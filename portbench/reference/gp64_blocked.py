"""``gp64``'s exact GP and pathwise values at an N whose out-of-place
factor does not fit one card, in plain PyTorch in ``dtype`` (float64 for
the reference; the control runs the same code in float32 with TF32 on).

``gp64.factor`` clones K(X, X) and factors the clone: with the kernel
matrix that is three N² buffers, about 96 GiB in float64 at N = 65616,
more than the card has. Here K is built in row blocks into one
preallocated (N, N) buffer (about 32 GiB at that N) and factored there in
place by a blocked right-looking Cholesky: ``torch.linalg.cholesky_ex`` on
each diagonal tile, ``solve_triangular`` for the tiles below it, and
``addmm_`` on the lower block triangle right of it (N³/3 operations, on
the FP64 tensor cores on the card). The solves are blocked substitutions
against the buffer's lower triangle. The semantics are ``gp64``'s: the
kernel centred once on the mean of X with the diagonal's squared distance
exactly 0, y standardized over the history, the jitter ladder ×1, ×1e2,
×1e4 (a NaN factor when every rung fails) and Matheron's rule for the
pathwise values. Imports nothing of the program."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference import gp64 as R

Tensor = torch.Tensor

#: Rows of a tile: 17 diagonal tiles at N = 65616, each update a product
#: large enough for the tensor cores.
BLOCK = 4096
#: Rows of K(X, X) built at a time: the kernel's temporaries of a block
#: of 2048 × 65616 float64 values are about 1 GiB each.
BUILD_ROWS = 2048
#: Candidates of the pathwise cross built at a time.
CAND_CHUNK = 1000


def kernel_into(out: Tensor, x: Tensor, h: R.Hypers, gp: dict, rows: int = BUILD_ROWS) -> Tensor:
    """K_f(X, X) written into ``out`` (N, N) row block by row block: the
    scaled inputs centred once on their mean (``gp64.sqdist``'s centre of
    one input), the diagonal's squared distance exactly 0."""
    n = x.shape[0]
    z = x / h.lengthscale
    z = z - z.mean(dim=0)
    sq = (z * z).sum(dim=1)
    value = R.kernel_module(gp).value
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        d2 = sq[r0:r1, None] + sq[None, :] - 2.0 * (z[r0:r1] @ z.T)
        d2.clamp_(min=0.0)
        i = torch.arange(r0, r1, device=x.device)
        d2[i - r0, i] = 0.0
        out[r0:r1] = value(d2, h.outputscale)
        del d2
    return out


def cholesky_(a: Tensor, block: int = BLOCK) -> bool:
    """The lower Cholesky factor of SPD ``a`` in its lower triangle, in
    place (the upper triangle outside the diagonal tiles keeps what it
    held); False, and ``a`` half-factored, where a diagonal tile is not
    positive definite."""
    n = a.shape[0]
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        l_kk, info = torch.linalg.cholesky_ex(a[k0:k1, k0:k1])
        if int(info) != 0:
            return False
        a[k0:k1, k0:k1] = l_kk
        if k1 == n:
            break
        p = torch.linalg.solve_triangular(l_kk.mT, a[k1:, k0:k1], upper=True, left=False)
        a[k1:, k0:k1] = p
        for j0 in range(k1, n, block):  # the lower block triangle of the trailing matrix
            j1 = min(j0 + block, n)
            a[j0:, j0:j1].addmm_(p[j0 - k1:], p[j0 - k1:j1 - k1].mT, alpha=-1.0)
        del p
    return True


def solve_lower(l_buf: Tensor, b: Tensor, block: int = BLOCK) -> Tensor:
    """x = L⁻¹ b, L the lower triangle of ``l_buf``, b (N, m)."""
    n = l_buf.shape[0]
    x = b.clone()
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        x[k0:k1] = torch.linalg.solve_triangular(l_buf[k0:k1, k0:k1], x[k0:k1], upper=False)
        if k1 < n:
            x[k1:] -= l_buf[k1:, k0:k1] @ x[k0:k1]
    return x


def solve_upper_t(l_buf: Tensor, b: Tensor, block: int = BLOCK) -> Tensor:
    """x = L⁻ᵀ b, the same layout."""
    n = l_buf.shape[0]
    x = b.clone()
    for k0 in reversed(range(0, n, block)):
        k1 = min(k0 + block, n)
        if k1 < n:
            x[k0:k1] -= l_buf[k1:, k0:k1].mT @ x[k1:]
        x[k0:k1] = torch.linalg.solve_triangular(l_buf[k0:k1, k0:k1].mT, x[k0:k1], upper=True)
    return x


def cho_solve(l_buf: Tensor, b: Tensor, block: int = BLOCK) -> Tensor:
    bm = b if b.dim() == 2 else b[:, None]
    return solve_upper_t(l_buf, solve_lower(l_buf, bm, block), block).reshape(b.shape)


def factor(x: Tensor, h: R.Hypers, gp: dict, block: int = BLOCK) -> Tensor:
    """``gp64.factor`` in one buffer: the factor of K_f + σ²I +
    rel·mean(diag)·I in the buffer's lower triangle over the ladder rel =
    jitter, 1e2·jitter, 1e4·jitter (K rebuilt for each rung); NaN when
    every rung fails."""
    n = x.shape[0]
    buf = torch.empty((n, n), dtype=x.dtype, device=x.device)
    jitter = gp["jitter"]
    for rel in (jitter, 1e2 * jitter, 1e4 * jitter):
        kernel_into(buf, x, h, gp)
        buf.diagonal().add_(R.train_shift(h, jitter, rel))
        if cholesky_(buf, block):
            return buf
    return buf.fill_(math.nan)


class Posterior(NamedTuple):
    x: Tensor
    h: R.Hypers
    l_buf: Tensor  # the factor in its lower triangle
    alpha: Tensor  # K⁻¹ y_std
    y_std: Tensor
    y_mean: Tensor
    y_sd: Tensor
    gp: dict
    block: int


def posterior(x: Tensor, y: Tensor, raw: Tensor, gp: dict, block: int = BLOCK) -> Posterior:
    h = R.constrain(raw, gp)
    y_std, y_mean, y_sd = R.standardize(y)
    l_buf = factor(x, h, gp, block)
    return Posterior(x, h, l_buf, cho_solve(l_buf, y_std, block), y_std, y_mean, y_sd, gp, block)


def pathwise_values(post: Posterior, cands: Tensor, omega: Tensor, b: Tensor, weights: Tensor,
                    eps: Tensor) -> Tensor:
    """``gp64.pathwise_values`` against the blocked factor: (q, m) paths in
    the original units, φ(x*)ᵀw + k(x*, X)K⁻¹(y_std − φ(X)ᵀw − σε), the
    cross built ``CAND_CHUNK`` candidates at a time (each chunk centred as
    ``gp64.sqdist`` centres a cross)."""
    h = post.h
    prior_x = weights @ R.rff(post.x, omega, b, h).T
    prior_c = weights @ R.rff(cands, omega, b, h).T
    rhs = post.y_std[None, :] - prior_x - torch.sqrt(h.noise) * eps
    u = cho_solve(post.l_buf, rhs.T.contiguous(), post.block)
    update = torch.cat([R.kernel(c, post.x, h, post.gp) @ u for c in cands.split(CAND_CHUNK)])
    return (prior_c + update.T) * post.y_sd + post.y_mean
