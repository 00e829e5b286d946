"""Layer ``device``: the share of the window, in %, in which no operation
ran on the device (1 − busy/window, busy the union of the device
operations' intervals). Moves ``points_per_s``: idle time is time the
host holds the device back."""

from portbench import trace as T


def read(run):
    if not run.trace.ops:
        return None
    return 100.0 * (1.0 - T.busy_s(run.trace) / T.window_s(run.trace))
