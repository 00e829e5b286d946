"""Masked, statically shaped linear algebra for GP inference (port of
``turbojax.linalg``).

A growing training set is carried as an ``(N_max, ·)`` buffer plus an
active count. Masked kernel matrices are identity-padded, so the Cholesky
factor of the padded matrix is ``[chol(K_active), I]``; masked right-hand
sides are zero-padded, so triangular solves leave inactive rows at 0; the
masked log-determinant gets log 1 = 0 from inactive rows.

Failure semantics differ from JAX's and are made equal here:
``jnp.linalg.cholesky`` returns NaN when the factorization fails, while
``torch.linalg.cholesky`` raises and ``torch.linalg.cholesky_ex`` returns a
partial, finite factor beside an ``info`` code. Every ladder below keys on
``info``, and a failed factor is filled with NaN, never kept.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from turbojax_torch.runlog import span

Tensor = torch.Tensor


def row_mask(n_max: int, n, device=None) -> Tensor:
    """Boolean (n_max,) mask with the first ``n`` entries active."""
    return torch.arange(n_max, device=device) < n


def mask_kernel_matrix(k_mat: Tensor, mask: Tensor) -> Tensor:
    """Identity-pad a kernel matrix outside the active block. ``mask`` is
    (N,) or carries the matrices' leading batch dimensions, (..., N)."""
    both = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(k_mat.shape[-1], dtype=k_mat.dtype, device=k_mat.device)
    return torch.where(both, k_mat, eye)


def mask_cross_matrix(k_cross: Tensor, mask: Tensor) -> Tensor:
    """Zero the rows of a train×candidate cross-covariance for inactive
    training points (``mask`` (N,) or (..., N), as above)."""
    return torch.where(mask[..., :, None], k_cross, torch.zeros_like(k_cross))


def cholesky_nan(a: Tensor) -> Tuple[Tensor, Tensor]:
    """``cholesky_ex`` with JAX's failure semantics: every matrix of the
    batch whose factorization failed (``info != 0``) comes back NaN in its
    lower triangle (0 above, as ``jnp.linalg.cholesky`` returns it).
    Returns (factor, info)."""
    l_mat, info = torch.linalg.cholesky_ex(a)
    failed = (info != 0)[..., None, None]
    return torch.where(failed, torch.full_like(l_mat, torch.nan).tril(), l_mat), info


def _bumped(k_mat: Tensor, rel: float) -> Tensor:
    n = k_mat.shape[-1]
    scale = k_mat.diagonal(dim1=-2, dim2=-1).mean(dim=-1)
    eye = torch.eye(n, dtype=k_mat.dtype, device=k_mat.device)
    return k_mat + (rel * scale)[..., None, None] * eye


def cholesky_jittered(k_mat: Tensor, jitter: float) -> Tensor:
    """Cholesky of ``k_mat + jitter·mean(diag)·I``: the fixed-jitter path of
    the batched grid fit. A failed batch row comes back NaN (no host sync)."""
    return cholesky_nan(_bumped(k_mat, jitter))[0]


def safe_cholesky(k_mat: Tensor, jitters: Tuple[float, ...] = (0.0, 1e-8, 1e-6, 1e-4)) -> Tensor:
    """Cholesky with an escalating relative-jitter ladder: for each matrix
    of the batch the first rung whose factorization succeeds
    (``info == 0``) wins, so one failing matrix never changes another's
    factor; a matrix that fails the last rung comes back NaN. The next rung
    runs only while some matrix still fails: one host sync per rung tried
    (one in the common case)."""
    with span("linalg.cholesky_ladder"):
        with span("linalg.cholesky_rung"):
            l_mat, info = cholesky_nan(_bumped(k_mat, jitters[0]))
        for rel in jitters[1:]:
            failed = info != 0
            with span("sync.linalg.ladder"):
                done = not bool(failed.any())
            if done:
                break
            with span("linalg.cholesky_rung"):
                l_next, info_next = cholesky_nan(_bumped(k_mat, rel))
            l_mat = torch.where(failed[..., None, None], l_next, l_mat)
            info = torch.where(failed, info_next, info)
        return l_mat


def _as_matrix(b: Tensor, l_mat: Tensor) -> Tuple[Tensor, bool]:
    vec = b.dim() == l_mat.dim() - 1
    return (b.unsqueeze(-1) if vec else b), vec


def solve_lower(l_mat: Tensor, b: Tensor) -> Tensor:
    """x = L⁻¹ b with L lower-triangular; b is a vector or a matrix."""
    bm, vec = _as_matrix(b, l_mat)
    x = torch.linalg.solve_triangular(l_mat, bm, upper=False)
    return x.squeeze(-1) if vec else x


def solve_upper_t(l_mat: Tensor, b: Tensor) -> Tensor:
    """x = L⁻ᵀ b with L lower-triangular."""
    bm, vec = _as_matrix(b, l_mat)
    x = torch.linalg.solve_triangular(l_mat.mT, bm, upper=True)
    return x.squeeze(-1) if vec else x


def cho_solve(l_mat: Tensor, b: Tensor) -> Tensor:
    """x = (L Lᵀ)⁻¹ b."""
    return solve_upper_t(l_mat, solve_lower(l_mat, b))


def masked_logdet_from_chol(l_mat: Tensor, mask: Tensor) -> Tensor:
    """log|K_active| from the identity-padded factor."""
    diag = l_mat.diagonal(dim1=-2, dim2=-1)
    safe = torch.where(mask, diag, torch.ones_like(diag))
    return 2.0 * torch.log(safe).sum(dim=-1)


# (L Lᵀ)⁻¹ from the factor, LAPACK's potri (the triangular inverse, then the
# triangular product) written as recursions on halves:
#
#   M = L⁻¹:  M₁₁, M₂₂ recursively, then M₂₁ = −M₂₂ (L₂₁ M₁₁);
#   W = MᵀM:  W₁₁ = M₁₁ᵀM₁₁ + M₂₁ᵀM₂₁,  W₂₁ = M₂₂ᵀM₂₁,  W₂₂ = M₂₂ᵀM₂₂.
#
# Each product of a triangle with a block recurses on the triangle's halves
# (a dense product for the square half), as M₂₁ᵀM₂₁ does on its columns
# (only its lower triangle is needed), so the matrix products do about
# 2N³/3 flops, against 2N³ for cholesky_solve(I); reverse mode through the
# Cholesky takes 4N³. A triangle of at most this size is inverted by one
# triangular solve against the identity and multiplied densely. Measured on
# an NVIDIA H100 80GB HBM3 at 700 W (float32, N = 16484, CUDA events): 83.9 /
# 85.7 / 95.1 / 115.7 ms at 512 / 1024 / 2048 / 4096, torch.cholesky_inverse
# 207 ms. Config 5's polish (5 lanes of 2048, 40 Adam steps), same card: a
# loss evaluation takes 17.4 ms at 1024, 18.4 ms at 2048 (no split).
_CHOL_INVERSE_BASE = 1024


def _half(n: int) -> int:
    """Where a block of ``n`` splits: n/2, down to a multiple of 64 once that
    is not 0, so that a block starts as aligned as the buffer's rows."""
    return (n // 2) & ~63 or n // 2


def _trmm_left_(x: Tensor, t: Tensor) -> None:
    """x ← t x in place; t (B, r, r) lower-triangular (0 above), x (B, r, w)."""
    r = t.shape[-1]
    if r <= _CHOL_INVERSE_BASE:
        x.copy_(torch.bmm(t, x))
        return
    h = _half(r)
    _trmm_left_(x[:, h:], t[:, h:, h:])
    x[:, h:].baddbmm_(t[:, h:, :h], x[:, :h])
    _trmm_left_(x[:, :h], t[:, :h, :h])


def _trmm_right_(y: Tensor, t: Tensor) -> None:
    """y ← y t in place; t (B, k, k) lower-triangular (0 above), y (B, r, k)."""
    k = t.shape[-1]
    if k <= _CHOL_INVERSE_BASE:
        y.copy_(torch.bmm(y, t))
        return
    h = _half(k)
    _trmm_right_(y[..., :h], t[:, :h, :h])
    y[..., :h].baddbmm_(y[..., h:], t[:, h:, :h])
    _trmm_right_(y[..., h:], t[:, h:, h:])


def _trmm_t_add_(d: Tensor, t: Tensor, z: Tensor) -> None:
    """d += tᵀz; t (B, r, r) lower-triangular (0 above), z and d (B, r, w)."""
    r = t.shape[-1]
    if r <= _CHOL_INVERSE_BASE:
        d.baddbmm_(t.mT, z)
        return
    h = _half(r)
    _trmm_t_add_(d[:, :h], t[:, :h, :h], z[:, :h])
    d[:, :h].baddbmm_(t[:, h:, :h].mT, z[:, h:])
    _trmm_t_add_(d[:, h:], t[:, h:, h:], z[:, h:])


def _syrk_add_(c: Tensor, a: Tensor) -> None:
    """c += aᵀa in c's lower triangle (above it, a block may be written or
    not); a (B, r, k), c (B, k, k)."""
    k = a.shape[-1]
    if k <= _CHOL_INVERSE_BASE:
        c.baddbmm_(a.mT, a)
        return
    h = _half(k)
    _syrk_add_(c[:, :h, :h], a[..., :h])
    c[:, h:, :h].baddbmm_(a[..., h:].mT, a[..., :h])
    _syrk_add_(c[:, h:, h:], a[..., h:])


def _tri_inv_(m: Tensor) -> None:
    """m ← m⁻¹ in place, for (B, n, n) lower-triangular m (0 above)."""
    n = m.shape[-1]
    if n <= _CHOL_INVERSE_BASE:
        m.copy_(torch.linalg.solve_triangular(m, torch.eye(n, dtype=m.dtype, device=m.device), upper=False))
        return
    h = _half(n)
    m11, m21, m22 = m[:, :h, :h], m[:, h:, :h], m[:, h:, h:]
    _tri_inv_(m11)
    _tri_inv_(m22)
    _trmm_right_(m21, m11)
    _trmm_left_(m21, m22)
    m21.neg_()


def _lauum_(m: Tensor, acc: Optional[Tensor] = None) -> None:
    """m ← mᵀm (+ acc) in place, for (B, n, n) lower-triangular m (0 above),
    written whole and exactly symmetric: each entry above the diagonal is a
    copy of its mirror. Only ``acc``'s lower triangle is read; it is
    overwritten."""
    n = m.shape[-1]
    if n <= _CHOL_INVERSE_BASE:
        w = (torch.bmm(m.mT, m) if acc is None else torch.baddbmm(acc, m.mT, m)).tril_()
        m.copy_(w + w.tril(-1).mT)
        return
    h = _half(n)
    m11, m12, m21, m22 = m[:, :h, :h], m[:, :h, h:], m[:, h:, :h], m[:, h:, h:]
    a11 = torch.zeros_like(m11) if acc is None else acc[:, :h, :h]
    _syrk_add_(a11, m21)
    _lauum_(m11, a11)
    del a11
    w21 = torch.zeros_like(m21) if acc is None else acc[:, h:, :h]
    _trmm_t_add_(w21, m22, m21)
    m21.copy_(w21)
    m12.copy_(w21.mT)
    del w21
    _lauum_(m22, None if acc is None else acc[:, h:, h:])


def chol_inverse(l_mat: Tensor) -> Tensor:
    """(L Lᵀ)⁻¹ for a lower factor L of shape (..., N, N), as a new tensor,
    exactly symmetric. Only L's lower triangle is read. Works in the result's
    buffer: besides it, temporaries of at most N²/4 entries a matrix. A NaN
    factor (a failed ``cholesky_nan``) gives a NaN inverse."""
    n = l_mat.shape[-1]
    out = torch.tril(l_mat.reshape(-1, n, n))
    _tri_inv_(out)
    _lauum_(out)
    return out.reshape(l_mat.shape)


# Incremental Cholesky:
#
#   L_{n+1} = [[L, 0], [bᵀ, p]],  b = L⁻¹ k(X, x_new),  p = sqrt(k_nn + σ² − bᵀb)
#
# O(n²) per append against O(n³) for a refactorization. The active count is a
# host int here, so the solve runs on the active n × n view of the buffer.


def _append_row_(l_buf: Tensor, n: int, k_vec: Tensor, k_nn: Tensor, floor: float) -> None:
    """Write row ``n`` of the factor in place: [b, pivot, 0, ...]."""
    b = solve_lower(l_buf[:n, :n], k_vec[:n]) if n else k_vec[:0]
    # an elementwise product and a sum: the pivot is a cancellation, and a
    # dot product could take a reduced-precision path
    pivot = torch.sqrt(torch.clamp_min(k_nn - (b * b).sum(), floor))
    l_buf[n].zero_()
    l_buf[n, :n] = b
    l_buf[n, n] = pivot


def chol_append(l_buf: Tensor, n: int, k_vec: Tensor, k_nn: Tensor, floor: float = 1e-10) -> Tensor:
    """Append one observation to an identity-padded Cholesky buffer.

    ``l_buf``: (N_max, N_max) lower factor, the identity outside the active
    n × n block; ``n``: the active size (a host int), row ``n`` is written;
    ``k_vec``: (N_max,) covariances k(X_buf, x_new), entries at index ≥ n are
    ignored; ``k_nn``: k(x_new, x_new) + σ²; ``floor``: the clamp under the
    new pivot's square root. Returns a new (N_max, N_max) factor with active
    size n + 1; ``l_buf`` is left as it was."""
    if not 0 <= n < l_buf.shape[-1]:
        raise ValueError(f"cannot append row {n} to a factor of capacity {l_buf.shape[-1]}")
    l_new = l_buf.clone()
    _append_row_(l_new, n, k_vec, k_nn, floor)
    return l_new


def chol_append_batch(
    l_buf: Tensor, n: int, k_block: Tensor, k_diag_block: Tensor, q: int, floor: float = 1e-10
) -> Tensor:
    """Append ``q`` observations one after another. ``k_block``: (q, N_max)
    covariances of each new point against the buffer with the new points
    already written (column n + j holds k(x_i, x_j) for the j-th new point);
    ``k_diag_block``: (q,) k(x_i, x_i) + σ². Returns a new factor with
    active size n + q."""
    if not 0 <= n <= l_buf.shape[-1] - q:
        raise ValueError(f"cannot append rows {n}..{n + q - 1} to a factor of capacity {l_buf.shape[-1]}")
    l_new = l_buf.clone()
    for i in range(q):
        _append_row_(l_new, n + i, k_block[i], k_diag_block[i], floor)
    return l_new


def dense_chol_solve(k_mat: Tensor, y: Tensor, jitter: float = 0.0) -> Tuple[Tensor, Tensor]:
    """(L, (L Lᵀ)⁻¹ y) for a dense, unmasked matrix; a failed factor is NaN."""
    l_mat = cholesky_jittered(k_mat, jitter) if jitter else cholesky_nan(k_mat)[0]
    return l_mat, cho_solve(l_mat, y)
