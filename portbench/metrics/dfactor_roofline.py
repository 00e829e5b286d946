"""Layer ``surrogate fit``, on a mesh: the row-sharded factorization's
share of its bound, in %: one rank's share of the factorization's
operations, N³/(3D) of the active N a batch (``yardstick.mesh_work``,
whatever implements it), at one H100's 67 TFLOP/s in fp32 outside the
tensor cores, over the device time rank 0's operations under
``dlinalg.factor`` took (``dfactor_ms``). The padded rows' work, the
collectives' waits and the in-shard build all lower it. Moves
``points_per_s``."""

from portbench import trace as T
from portbench.yardstick.bounds import FLOPS_PER_S


def read(run):
    ops = T.launched_under(run.trace, "dlinalg.factor")
    need = sum(w.get("dfactor_flops", 0.0) for w in run.work)
    if not ops or need <= 0:
        return None
    return 100.0 * (need / FLOPS_PER_S) / T.device_s(ops)
