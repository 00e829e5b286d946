"""Layer ``loop``: kernels launched on the device per completed batch,
counted from the device operations of the trace (every launch runs one),
copies and sets left out. Moves ``points_per_s``: each launch costs the
host a few microseconds and the device a gap."""

from portbench import trace as T


def read(run):
    if not run.batches or not run.trace.ops:
        return None
    return len(T.kernels(run.trace)) / len(run.batches)
