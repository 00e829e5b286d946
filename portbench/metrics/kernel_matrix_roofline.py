"""Layer ``kernels``: the hand-written kernel-matrix kernel's share of its
roofline, in %: the bounds (``yardstick.bounds.kernel_matrix_bound``) of
the kernel matrices the window's batches need (``yardstick.work``) over
the device time of every launch of the kernel. Moves ``points_per_s``."""

from portbench import trace as T

FRAGMENTS = ("kernel_matrix_tile",)


def read(run):
    ops = T.kernels(run.trace, FRAGMENTS)
    need_ms = sum(b["bound_ms"] for w in run.work for b in w["kernel_matrix"])
    if not ops or need_ms <= 0:
        return None
    return 100.0 * (need_ms / 1e3) / T.device_s(ops)
