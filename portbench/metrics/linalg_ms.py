"""Layer ``linalg``: device milliseconds per batch in the libraries'
dense linear algebra (cuSOLVER's Cholesky (its kernels are named potrf and getrf), cuBLAS's triangular solves and
matrix products), matched by these fragments of the kernels' names, lower
case. Moves ``points_per_s``."""

from portbench import trace as T

FRAGMENTS = ("potrf", "getrf", "potri", "trtri", "lauum", "trsm", "trsv", "trmm", "gemm", "gemv", "syrk", "herk",
             "cusolver", "cublas", "xmma", "cutlass", "magma")


def read(run):
    ops = T.kernels(run.trace, FRAGMENTS)
    if not run.batches or not ops:
        return None
    return 1e3 * T.device_s(ops) / len(run.batches)
