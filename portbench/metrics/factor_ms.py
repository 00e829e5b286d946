"""Layer ``surrogate fit``: device ms per completed batch of the operations
launched under the program's ``gp.factor`` span (``gp.make_gp_state``:
K(X, X), the jitter ladder's Cholesky, α): the cached factorization after
a fit, or in its place with pinned hypers. Moves ``points_per_s``."""

from portbench import spans as S


def read(run):
    return S.device_ms_per_batch(run, "gp.factor")
