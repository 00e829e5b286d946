"""Layer ``kernels``: the hand-written Thompson-covariance kernel's share
of its roofline, in %: the bounds (``yardstick.bounds.ts_cov_bound``) of
the chunk covariances the window's batches need over the device time of
every launch of the kernel (both of its passes). Moves ``points_per_s``."""

from portbench import trace as T

FRAGMENTS = ("ts_cov_",)


def read(run):
    ops = T.kernels(run.trace, FRAGMENTS)
    need_ms = sum(b["bound_ms"] for w in run.work for b in w["ts_cov"])
    if not ops or need_ms <= 0:
        return None
    return 100.0 * (need_ms / 1e3) / T.device_s(ops)
