"""Layer ``device`` (the whole step): the floating-point operations the
window's batches need (``yardstick.work``: the same count whatever
implements the work) over the window's time, as a share in % of one
H100's 67 TFLOP/s in fp32 outside the tensor cores (the configurations
keep TF32 off). Moves ``points_per_s``, and bounds every kernel's gain."""

from portbench import trace as T
from portbench.yardstick.bounds import FLOPS_PER_S


def read(run):
    if not run.batches or not run.trace.ops:
        return None
    return 100.0 * sum(w["flops"] for w in run.work) / (T.window_s(run.trace) * FLOPS_PER_S)
