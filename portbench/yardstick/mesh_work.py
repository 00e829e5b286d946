"""The work one batch of the row-sharded loop needs, counted from its
sizes (``entries/mesh.py``): at pinned hypers, at history size N (the
active rows, whatever the padding) on D ranks, q points:

* the factorization of K(X, X), N³/3 operations, of which each rank's
  share is N³/(3D): the row-sharded Cholesky divides the trailing updates
  by rows;
* the pathwise update's two triangular solves with q right-hand sides,
  2N²q, each rank's share 2N²q/D.

``mesh_batch`` returns ``{"flops", "dfactor_flops"}``: one rank's
operations in the batch and in its factorization. The same count holds
whatever implements the work, so padding and waiting lower the shares
read against it."""

from __future__ import annotations

from typing import Dict


def mesh_batch(n: int, q: int, world: int) -> Dict[str, float]:
    factor = n**3 / 3.0
    return {"flops": (factor + 2.0 * n * n * q) / world, "dfactor_flops": factor / world}
