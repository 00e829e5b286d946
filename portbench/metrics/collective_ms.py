"""Layer ``collectives``: device ms per completed batch in NCCL's kernels
on rank 0's trace (the row-sharded Cholesky's panel all-gathers, the
substitutions' broadcasts and all-reduces, the loop's broadcasts of the
objective's values and of the window's stop), matched by these fragments
of the kernels' names, lower case. A kernel's time includes its wait for
the other ranks. With the panel fixed the collectives a batch are fixed
too, so the time is the whole story. Moves ``points_per_s``."""

from portbench import trace as T

FRAGMENTS = ("nccl",)


def read(run):
    ops = T.kernels(run.trace, FRAGMENTS)
    if not run.batches or not ops:
        return None
    return 1e3 * T.device_s(ops) / len(run.batches)
