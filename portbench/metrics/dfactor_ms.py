"""Layer ``surrogate fit``, on a mesh: device ms per completed batch of the
operations rank 0 launched under the program's ``dlinalg.factor`` span
(``distributed_linalg.DistributedGP.fit``: the in-shard K(X, X) block, the
jitter ladder's row-sharded Cholesky with its panel all-gathers, α's two
distributed substitutions). Moves ``points_per_s``."""

from portbench import spans as S


def read(run):
    return S.device_ms_per_batch(run, "dlinalg.factor")
