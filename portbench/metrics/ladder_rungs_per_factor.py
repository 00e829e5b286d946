"""Layer ``linalg``: Cholesky attempts per jitter ladder, the program's
``linalg.cholesky_rung`` spans over its ``linalg.cholesky_ladder`` spans
(``linalg.safe_cholesky`` and the TS covariance's ladder): 1 when every
first rung succeeds, each retry one more factorization. Moves
``points_per_s``."""

from portbench import spans as S


def read(run):
    ladders = S.count(run.trace, "linalg.cholesky_ladder")
    if not ladders:
        return None
    return S.count(run.trace, "linalg.cholesky_rung") / ladders
