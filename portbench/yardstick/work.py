"""The work one batch needs, counted from its sizes: the same count holds
whatever implements the work, so a faster implementation raises the shares
and a wasteful one (a kernel launched more often than the algorithm needs)
lowers them. Each entry (``entries/<entry>.py``) counts its batches with
the function here that matches its algorithm; an entry of another
algorithm brings its own count in its own file.

A batch at history size N, d inputs, m candidates, q points:

* ``pathwise_batch``, a batch of the BO loop (``adam_steps`` Adam steps of
  a fit, 0 at pinned hypers): each step factorizes K(X, X) (N³/3) and
  forms K⁻¹ from the factor for the gradient (2N³/3); then the posterior's
  factorization (N³/3); then the pathwise update's two triangular solves
  with q right-hand sides (2N²q). Kernel matrices: K(X, X) per Adam step
  and for the factorization, the cross k(x*, X).
* ``exact_ts_batch``, a suggestion by the exact sampler, candidates in
  chunks of c: the posterior's triangular solve over every candidate
  (N²·m), per chunk the upper triangle of vᵀv (N·c(c+1)) and its Cholesky
  (c³/3). Kernel matrices: the cross K(X, x*) per chunk; one TS
  covariance per chunk.

Each returns ``{"flops", "kernel_matrix", "ts_cov"}``: the floating-point
operations and the bounds (``yardstick.bounds``) of every kernel matrix
and TS covariance the batch needs."""

from __future__ import annotations

from typing import Dict

from portbench.yardstick.bounds import kernel_matrix_bound, ts_cov_bound


def pathwise_batch(n: int, d: int, q: int, m: int, adam_steps: int) -> Dict[str, object]:
    flops = n**3 / 3 + 2.0 * n * n * q + adam_steps * (n**3 / 3 + 2 * n**3 / 3)
    km = [kernel_matrix_bound(1, n, n, d, True)] * (adam_steps + 1) + [kernel_matrix_bound(1, m, n, d, False)]
    return {"flops": flops, "kernel_matrix": km, "ts_cov": []}


def exact_ts_batch(n: int, d: int, m: int, chunk: int) -> Dict[str, object]:
    chunks = m // chunk
    flops = float(n) * n * m + chunks * (float(n) * chunk * (chunk + 1) + chunk**3 / 3)
    return {"flops": flops, "kernel_matrix": [kernel_matrix_bound(1, n, chunk, d, False)] * chunks,
            "ts_cov": [ts_cov_bound(1, chunk, n, d)] * chunks}
