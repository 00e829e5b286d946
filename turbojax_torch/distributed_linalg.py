"""The exact GP with K row-block-sharded over a mesh: blocked Cholesky,
solves, the MLL with its closed-form gradient, the fit, the posterior and
pathwise draws, and the auto-routing between it and the dense GP (port of
``turbojax.distributed_linalg``).

Layout: a sharded primitive (``distributed_cholesky``, the solves,
``distributed_gp_posterior``, ``distributed_kernel_chol``,
``distributed_cross_covariance``) keeps ``parallel``'s contract: K (N, N)
is sharded by row blocks, rank r owning rows [r·N/D, (r+1)·N/D); a
function takes and returns each sharded matrix as the rank's block and each
replicated value whole. The primitives on the given factor take N a
multiple of D·P. The GP level (``DistributedGP``, ``distributed_mll``,
``distributed_pathwise_paths``) takes any N: it pads the history to N_pad,
the next multiple of D·P (``_layout``), with padded rows and columns of K
the identity's (off-diagonal 0, diagonal 1, as ``linalg.mask_kernel_matrix``
pads the dense route), residual 0 and a zero cross block, so that they add
nothing to the solves, 0 to log|K| and the MLL counts the active N; the
draws keep the active N's shapes. Its rows are dealt out balanced: the
N_pad/P panels form D·s row blocks of whole panels (s = ``_BLOCKS_PER_RANK``
on D > 1, or the panels a rank holds if fewer; s = 1 on one device), given
out in snake order (ranks 0…D−1, then D−1…0, ...), each rank storing its s
blocks one after another in global order: N_pad/D rows a rank as before,
the padded rows still the last global rows (the end of each rank's
storage). With one block a rank (the primitives' layout) the last rank's
rows lie below every panel and it does ~2.9× its N³/(3D) share of the
trailing updates at D = 4 while the others wait; dealt out at s = 8 the
slowest rank's share per panel sums to ~1.06×. ``Layout.gather`` makes a
GP-level block whole in global row order.

The factorization is right-looking over column panels of width P (a panel
lies inside one block, so its rows live on one rank); per panel:

1. all-gather the panel column (N·P values, the only communication: the
   matrix once over the whole run);
2. every rank factors the P × P diagonal block itself (``linalg.
   cholesky_nan``: a failed block is NaN, as ``jnp.linalg.cholesky``'s is)
   and solves the gathered column below it;
3. every rank updates each of its blocks below the panel on the columns
   right of it up to the block's last row (a staircase: the columns past
   it are the upper triangle's), in place, one ``addmm_`` a block.

The substitutions go by blocks in global order: the owner's diagonal block
is one triangular solve, and D·s broadcasts (forward) or all-reduces
(backward) of a (block rows, m) piece carry the coupling, whatever the
panel; a rank's blocks past a block are a suffix of its storage, so each
step is one ``addmm_`` a rank.

No rank holds the dense N × N matrix: the row blocks of k(X, X) and of the
crosses k(X, X*) are built inside the shard from the replicated X by
``cuda_kernels.kernel_matrix`` (the CUDA kernel on CUDA tensors), with one
centre computed from the whole X (a per-block centre would give each rank a
slightly different K) and, for K's row blocks, the exact self-value on the
global diagonal (``diag_offset`` with one block a rank, else one indexed
write after the build). The panel loop is a host loop: it is the
JAX package's unrolled lane, with no ``fori`` lane and no ``unroll`` switch,
which exist there for XLA's program size; ``unroll=`` is accepted and
ignored. Every contraction is full fp32 or fp64 (TF32 stays off).

The MLL's gradient is ``torch.autograd.Function`` from the closed form
∂MLL/∂K = ½(ααᵀ − K⁻¹), with K⁻¹ row-sharded from two distributed
substitutions against the identity: no autograd graph runs through the
panel loop, so the backward keeps the forward's O(N²/D) memory.

Routing: ``should_distribute`` takes the dense route without a mesh or on
a mesh of one device, and otherwise when the dense fit's working set
(3 N² · itemsize) fits ``DENSE_BUDGET_BYTES``. Both routes model
``warp_y(y)``; ``.mll()`` scores the warped, standardized targets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from turbojax_torch import acq as A
from turbojax_torch import cuda_kernels as CK
from turbojax_torch import gp as G
from turbojax_torch import kernels as K
from turbojax_torch import linalg as L
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig
from turbojax_torch.parallel import Mesh, all_sum, all_true, broadcast_from, gather_rows
from turbojax_torch.runlog import span

Tensor = torch.Tensor

_LOG_2PI = math.log(2.0 * math.pi)


#: Row blocks a rank holds in the GP level's layout on a mesh of D > 1 (or
#: the panels it holds, if fewer). The slowest rank's trailing update summed
#: over the panels at N_pad = 66048, D = 4, P = 128, in units of N³/(3D):
#: 2.93 at one block, 1.51 / 1.17 / 1.06 / 1.03 at 2 / 4 / 8 / 16, while a
#: substitution takes D·s collectives. Timed on four H100s at 700 W (the
#: factor and α at N = 65546, float32): 2.50-2.51 s at one block, 1.19 /
#: 1.13 / 1.13-1.17 s at 4 / 8 / 16.
_BLOCKS_PER_RANK = 8


class Layout(NamedTuple):
    """The padded row layout of an N-row history on a mesh: N_pad/P panels
    dealt out to the ranks as row blocks of whole panels (``_layout``)."""

    n: int  # the active rows
    n_pad: int  # N padded to the next multiple of D·P
    rows: int  # rows a rank holds, N_pad/D
    blocks: Tuple[Tuple[int, int, int, int], ...]  # in global order: (first row, end, owner, first row on the owner)
    mine: Tuple[Tuple[int, int, int], ...]  # this rank's, in global order: (first row, end, first local row)
    active: int  # this rank's active rows: the first ones of its storage (the padding is the last global rows)
    index: Tensor  # (rows,) the global row of each of this rank's rows
    order: Optional[Tensor]  # (N_pad,) each global row's place in the ranks' rows stacked in rank order

    def gather(self, block: Tensor, mesh: Mesh) -> Tensor:
        """The row-sharded ``block`` (rows, ...) made whole, in global row
        order."""
        whole = gather_rows(block, mesh)
        return whole if self.order is None else whole[self.order]


def _layout(n: int, mesh: Mesh, panel: int, contiguous: bool = False) -> Layout:
    """N padded to N_pad, the next multiple of D·P, and its N_pad/P panels
    dealt out as D·s row blocks of whole panels, s a rank: 1 on one device
    or where ``contiguous`` (the sharded primitives' rank blocks), else
    ``_BLOCKS_PER_RANK`` or the panels a rank holds, if fewer. Round k gives
    ranks 0…D−1 a block each (k even) or D−1…0 (k odd); where the panels do
    not divide evenly the early rounds are a panel wider, so every rank
    holds N_pad/D rows. The index tensors are on ``mesh.device``."""
    size, unit = mesh.size, mesh.size * panel
    n_pad = -(-n // unit) * unit
    rows = n_pad // size
    per_rank = rows // panel
    s = 1 if contiguous or size == 1 else max(min(_BLOCKS_PER_RANK, per_rank), 1)
    base, wide = divmod(per_rank, s)
    blocks, filled, g = [], [0] * size, 0
    for k in range(s):
        width = (base + (k < wide)) * panel
        for i in range(size):
            owner = i if k % 2 == 0 else size - 1 - i
            blocks.append((g, g + width, owner, filled[owner]))
            filled[owner] += width
            g += width
    mine = tuple((g0, g1, l0) for g0, g1, owner, l0 in blocks if owner == mesh.rank)
    dev = mesh.device
    index = torch.cat([torch.arange(g0, g1, device=dev) for g0, g1, _ in mine])
    order = None
    if s > 1:
        order = torch.cat([torch.arange(owner * rows + l0, owner * rows + l0 + g1 - g0, device=dev)
                           for g0, g1, owner, l0 in blocks])
    active = sum(min(max(n - g0, 0), g1 - g0) for g0, g1, _ in mine)
    return Layout(n, n_pad, rows, tuple(blocks), mine, active, index, order)


def _pad_to(block: Tensor, rows: int) -> Tensor:
    short = rows - block.shape[0]
    return block if short == 0 else torch.cat([block, block.new_zeros((short, *block.shape[1:]))])


def _pad_rows(v: Tensor, lay: Layout) -> Tensor:
    """This rank's rows of the replicated (N, ...) ``v``, zero on the padded
    rows."""
    return _pad_to(v[lay.index[:lay.active]], lay.rows)


# --------------------------------------------------------------------------
# Panel algorithms on the rank's rows of a layout


def _local_chol(a: Tensor, mesh: Mesh, lay: Layout, panel: int) -> Tensor:
    """Blocked right-looking Cholesky of the row-sharded matrix whose rows
    ``a`` holds, in place: ``a`` becomes the rows of the lower factor."""
    for c0 in range(0, lay.n_pad, panel):
        t0 = c0 + panel
        col = lay.gather(a[:, c0:t0], mesh)  # (n_pad, panel), the factor's panel column once filled in
        l_kk = L.cholesky_nan(col[c0:t0])[0]
        col[t0:] = torch.linalg.solve_triangular(l_kk.mT, col[t0:], upper=True, left=False)
        col[c0:t0] = l_kk
        col[:c0] = 0.0
        a[:, c0:t0] = col[lay.index]
        for g0, g1, l0 in lay.mine:
            if g1 > t0:  # the block's rows below the panel, on the lower triangle's columns up to its last row
                lo, hi = l0 + max(t0 - g0, 0), l0 + g1 - g0
                a[lo:hi, t0:g1].addmm_(a[lo:hi, c0:t0], col[t0:g1].mT, alpha=-1.0)
    return a


def _local_solve_lower(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, lay: Layout) -> Tensor:
    """x = L⁻¹ b with L and b (N, m) row-sharded: forward substitution by
    blocks in global order. The block's owner solves its diagonal block
    (one triangular solve) and broadcasts its piece of x, and every rank
    takes L_jb x_b off its rows past the block (a suffix of its storage):
    D·s broadcasts in all, whatever the panel."""
    x = b_loc.clone()
    past = 0  # this rank's first row past the block
    for g0, g1, owner, l0 in lay.blocks:
        if mesh.rank == owner:
            past = l0 + g1 - g0
            x[l0:past] = torch.linalg.solve_triangular(l_loc[l0:past, g0:g1], x[l0:past], upper=False)
            x_b = broadcast_from(x[l0:past], mesh, src=owner)
        else:
            x_b = broadcast_from(x.new_empty((g1 - g0, *x.shape[1:])), mesh, src=owner)
        x[past:].addmm_(l_loc[past:, g0:g1], x_b, alpha=-1.0)
    return x


def _local_solve_upper_t(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, lay: Layout) -> Tensor:
    """x = L⁻ᵀ b (backward substitution), same layout, by blocks from the
    last: x_b = L_bb⁻ᵀ(b_b − Σ_{j past b} L_jbᵀ x_j), every rank sending its
    rows' terms and the owner its b_b in one all-reduce (a masked sum, as
    the JAX package's ``psum``): D·s all-reduces in all."""
    x = b_loc.clone()
    past = lay.rows
    for g0, g1, owner, l0 in reversed(lay.blocks):
        l1 = l0 + g1 - g0
        part = -(l_loc[past:, g0:g1].mT @ x[past:])
        if mesh.rank == owner:
            part += b_loc[l0:l1]
        total = all_sum(part, mesh)
        if mesh.rank == owner:
            x[l0:l1] = torch.linalg.solve_triangular(l_loc[l0:l1, g0:g1].mT, total, upper=True)
            past = l0
    return x


def _cho_solve(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, lay: Layout) -> Tensor:
    return _local_solve_upper_t(l_loc, _local_solve_lower(l_loc, b_loc, mesh, lay), mesh, lay)


def _block_layout(mat_loc: Tensor, mesh: Mesh, panel: int) -> Layout:
    """The layout of a row block (rows, N) of the sharded primitives: one
    block a rank, N a multiple of D·P, no padding."""
    lay = _layout(mat_loc.shape[-1], mesh, panel, contiguous=True)
    if lay.n_pad != lay.n:
        raise ValueError(f"N ({lay.n}) must be a multiple of the mesh size times the panel "
                         f"({mesh.size} x {panel})")
    if mat_loc.shape[0] != lay.rows:
        raise ValueError(f"a row block of an ({lay.n}, {lay.n}) matrix on {mesh.size} ranks has {lay.rows} rows, "
                         f"not {mat_loc.shape[0]}")
    return lay


# --------------------------------------------------------------------------
# Public sharded primitives. ``unroll`` keeps the JAX package's signature
# and is ignored (see the module docstring).


def distributed_cholesky(k_loc: Tensor, mesh: Mesh, panel: int = 128, unroll="auto") -> Tensor:
    """The row block of the lower factor of SPD K, from K's row block."""
    return _local_chol(k_loc.clone(), mesh, _block_layout(k_loc, mesh, panel), panel)


def distributed_solve_lower(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128, unroll="auto") -> Tensor:
    """x = L⁻¹ b with L and b (N, m) row-sharded alike."""
    return _local_solve_lower(l_loc, b_loc, mesh, _block_layout(l_loc, mesh, panel))


def distributed_solve_upper_t(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128,
                              unroll="auto") -> Tensor:
    """x = L⁻ᵀ b (backward substitution), same layout."""
    return _local_solve_upper_t(l_loc, b_loc, mesh, _block_layout(l_loc, mesh, panel))


def distributed_cho_solve(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128, unroll="auto") -> Tensor:
    """(L Lᵀ)⁻¹ b: forward, then backward substitution."""
    return _cho_solve(l_loc, b_loc, mesh, _block_layout(l_loc, mesh, panel))


def distributed_gp_posterior(
    l_loc: Tensor, alpha_loc: Tensor, k_cross_loc: Tensor, k_diag: Tensor, mesh: Mesh, panel: int = 128,
    mean=0.0,
) -> Tuple[Tensor, Tensor]:
    """Posterior mean and variance (replicated) with the training axis
    row-sharded: μ* = m + K*ᵀα (local product, all-reduced), σ*² = k** −
    Σ_rows v², v = L⁻¹K* (a distributed forward solve, then a row sum),
    both sums in one all-reduce. ``alpha_loc`` (rows,) or (rows, 1);
    ``k_cross_loc`` (rows, m) the cross's row block; ``k_diag`` (m,) the
    prior variances k(x*, x*)."""
    return _posterior(l_loc, alpha_loc, k_cross_loc, k_diag, mesh, _block_layout(l_loc, mesh, panel), mean)


def _posterior(l_loc: Tensor, alpha_loc: Tensor, k_cross_loc: Tensor, k_diag: Tensor, mesh: Mesh, lay: Layout,
               mean) -> Tuple[Tensor, Tensor]:
    a = alpha_loc.reshape(-1)
    v = _local_solve_lower(l_loc, k_cross_loc, mesh, lay)
    parts = all_sum(torch.stack([k_cross_loc.mT @ a, (v * v).sum(dim=0)]), mesh)
    return mean + parts[0], torch.clamp_min(k_diag - parts[1], 1e-12)


def _log_diag(l_loc: Tensor, index: Tensor) -> Tensor:
    """2 Σ log of the factor's global diagonal on this rank's rows (global
    rows ``index``)."""
    return 2.0 * torch.log(l_loc[torch.arange(l_loc.shape[0], device=l_loc.device), index]).sum()


def distributed_logdet_from_chol(l_loc: Tensor, mesh: Mesh) -> Tensor:
    """log|K| = 2 Σ log diag(L), the diagonal's row blocks all-reduced."""
    rows = l_loc.shape[0]
    return all_sum(_log_diag(l_loc, mesh.rank * rows + torch.arange(rows, device=l_loc.device)), mesh)


# --------------------------------------------------------------------------
# In-shard kernel builds: no rank holds the dense N × N matrix


def _kernel_rows(params: Dict[str, Tensor], x: Tensor, lay: Layout, kernel: str, bump) -> Tensor:
    """k(X_rows, X) + bump on the global diagonal over the padded layout,
    the diagonal's values the exact outputscale + bump. A padded row of X
    is zero before the centring, and the one centre, the mean of the active
    rows, is the same on every rank. The padded rows and columns are not
    masked here (``_mask_padding_``). With one block a rank the kernel
    writes the diagonal (``diag_offset``), and on a mesh of one device the
    block is the whole matrix, passed as one tensor: the kernel's symmetric
    schedule. Dealt-out blocks are one build of the rank's rows, then one
    indexed write of the diagonal."""
    z = _pad_to(x, lay.n_pad) / params["lengthscale"]
    z = (z - z[:lay.n].mean(dim=0, keepdim=True)).contiguous()
    if lay.order is None:
        row0 = lay.mine[0][0]
        z_rows = z if lay.rows == z.shape[0] else z[row0:row0 + lay.rows]
        return CK.kernel_matrix(z_rows, z, params["outputscale"], bump, kernel, add_noise=True, diag_offset=row0)
    k_loc = CK.kernel_matrix(z[lay.index], z, params["outputscale"], 0.0, kernel)
    diag = (torch.arange(lay.rows, device=k_loc.device), lay.index)
    # in place, but not on the output of the kernel's autograd Function (a view) where the MLL's backward records it
    if k_loc.requires_grad:
        return k_loc.index_put(diag, params["outputscale"] + bump)
    return k_loc.index_put_(diag, params["outputscale"] + bump)


def _mask_padding_(k_loc: Tensor, lay: Layout) -> Tensor:
    """K's row block with its padded rows and columns the identity's
    (``linalg.mask_kernel_matrix``'s padding), in place."""
    if lay.n_pad == lay.n:
        return k_loc
    a = lay.active
    k_loc[:, lay.n:] = 0.0
    k_loc[a:] = 0.0
    k_loc[torch.arange(a, lay.rows, device=k_loc.device), lay.index[a:]] = 1.0
    return k_loc


def _mask_grad_(gk: Tensor, lay: Layout) -> Tensor:
    """ḡK zero on the padded rows and columns, in place: they are
    constants, not the kernel's."""
    if lay.n_pad != lay.n:
        gk[:, lay.n:] = 0.0
        gk[lay.active:] = 0.0
    return gk


def _bump(params: Dict[str, Tensor], jitter: float) -> Tensor:
    """σ² + jitter·(outputscale + σ²): the dense lane's relative jitter on
    the mean diagonal of a stationary kernel."""
    return params["noise"] + jitter * (params["outputscale"] + params["noise"])


def distributed_kernel_chol(
    params: Dict[str, Tensor], x: Tensor, mesh: Mesh, panel: int = 128, kernel: str = "matern52",
    unroll="auto", jitter: float = 0.0,
) -> Tensor:
    """The row block (N_pad/D, N_pad) of the Cholesky factor of k(X, X) +
    σ²I (+ the relative ``jitter``) over the padded layout with one block a
    rank (``_layout``: its padded block the identity), built in the shard
    from the replicated X (N, d): the largest live array is the row block.
    ``params`` holds "lengthscale", "outputscale" and "noise"."""
    return _kernel_chol(params, x, mesh, _layout(x.shape[0], mesh, panel, contiguous=True), panel, kernel, jitter)


def _kernel_chol(params: Dict[str, Tensor], x: Tensor, mesh: Mesh, lay: Layout, panel: int, kernel: str,
                 jitter: float) -> Tensor:
    k_loc = _mask_padding_(_kernel_rows(params, x, lay, kernel, _bump(params, jitter)), lay)
    return _local_chol(k_loc, mesh, lay, panel)


def distributed_cross_covariance(params: Dict[str, Tensor], x: Tensor, xs: Tensor, mesh: Mesh,
                                 kernel: str = "matern52", panel: int = 128) -> Tensor:
    """The row block of k(X, X*) (N_pad/D × m) over the padded layout with
    one block a rank (``_layout``; zero on the padded rows), built in the
    shard; the centre is the dense posterior's, from the whole X and X*."""
    return _cross_rows(params, x, xs, _layout(x.shape[0], mesh, panel, contiguous=True), kernel)


def _cross_rows(params: Dict[str, Tensor], x: Tensor, xs: Tensor, lay: Layout, kernel: str) -> Tensor:
    ls = params["lengthscale"]
    zx, zs = x / ls, xs / ls
    c = 0.5 * (zx.mean(dim=0, keepdim=True) + zs.mean(dim=0, keepdim=True))
    out = CK.kernel_matrix(_pad_rows(zx - c, lay).contiguous(), (zs - c).contiguous(), params["outputscale"], 0.0,
                           kernel, False)
    out[lay.active:] = 0.0
    return out


# --------------------------------------------------------------------------
# The distributed MLL and the fit


def _mll_parts(raw: G.GPParams, x: Tensor, y_std: Tensor, mesh: Mesh, config: GPConfig,
               panel: int) -> Tuple[Tensor, Tensor, Tensor, Layout]:
    """Kernel rows → blocked Cholesky → forward solve (quad = ‖L⁻¹r‖²) →
    logdet. Returns (mll, L's rows, v = L⁻¹r's rows, the layout)."""
    lay = _layout(x.shape[0], mesh, panel)
    params = G.constrain_params(raw, config)
    k_loc = _mask_padding_(_kernel_rows(params, x, lay, config.kernel, _bump(params, config.jitter)), lay)
    l_loc = _local_chol(k_loc, mesh, lay, panel)
    resid = _pad_rows(y_std - params["mean"], lay)[:, None]
    v_loc = _local_solve_lower(l_loc, resid, mesh, lay)
    quad, logdet = all_sum(torch.stack([(v_loc * v_loc).sum(), _log_diag(l_loc, lay.index)]), mesh)
    return -0.5 * (quad + logdet + lay.n * _LOG_2PI), l_loc, v_loc, lay


class _DistributedMLL(torch.autograd.Function):
    """Forward: the MLL, saving L and α = K⁻¹r. Backward: the closed form,
    ∂MLL/∂K = ½(ααᵀ − K⁻¹) on the local block (K⁻¹'s rows from
    substitutions against the identity's rows, made in the shard), zero on
    the padded rows and columns, pulled back through the in-shard kernel
    build by ``torch.autograd.grad``, the hypers' and X's gradients
    all-reduced, and ∂MLL/∂y_std = −α on the active rows."""

    @staticmethod
    def forward(ctx, mesh, config, panel, x, y_std, *raw_leaves):
        mll_val, l_loc, v_loc, lay = _mll_parts(G.GPParams(*raw_leaves), x, y_std, mesh, config, panel)
        alpha_loc = _local_solve_upper_t(l_loc, v_loc, mesh, lay)[:, 0]
        ctx.mesh, ctx.config, ctx.panel = mesh, config, panel
        ctx.save_for_backward(x, l_loc, alpha_loc, *raw_leaves)
        return mll_val

    @staticmethod
    def backward(ctx, g):
        mesh, config, panel = ctx.mesh, ctx.config, ctx.panel
        x, l_loc, alpha_loc, *raw_leaves = ctx.saved_tensors
        lay = _layout(x.shape[0], mesh, panel)
        eye_loc = torch.zeros((lay.rows, lay.n_pad), dtype=l_loc.dtype, device=l_loc.device)
        eye_loc[torch.arange(lay.rows, device=l_loc.device), lay.index] = 1.0
        kinv_loc = _cho_solve(l_loc, eye_loc, mesh, lay)
        del eye_loc
        alpha = lay.gather(alpha_loc, mesh)
        # the in-shard build assigns every entry of K once across the ranks
        gk = _mask_grad_((0.5 * g) * (alpha_loc[:, None] * alpha[None, :] - kinv_loc), lay)
        del kinv_loc
        want_x = ctx.needs_input_grad[3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in raw_leaves]
            x_in = x.detach().requires_grad_(want_x)
            p = G.constrain_params(G.GPParams(*leaves), config)
            outs = [_kernel_rows(p, x_in, lay, config.kernel, _bump(p, config.jitter))]
            grads_out = [gk]
            if p["mean"].requires_grad:
                outs.append(p["mean"])
                grads_out.append(g * alpha_loc.sum())
            inputs = leaves + ([x_in] if want_x else [])
            grads = torch.autograd.grad(outs, inputs, grads_out, allow_unused=True)
        grads = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(inputs, grads)]
        flat = all_sum(torch.cat([gr.reshape(-1) for gr in grads]), mesh)
        grads = [part.reshape(t.shape) for part, t in zip(flat.split([t.numel() for t in inputs]), inputs)]
        x_bar = grads.pop() if want_x else None
        y_bar = -g * alpha[:lay.n] if ctx.needs_input_grad[4] else None
        return (None, None, None, x_bar, y_bar, *grads)


def distributed_mll(raw: G.GPParams, x: Tensor, y_std: Tensor, mesh: Mesh, config: GPConfig,
                    panel: int = 128) -> Tensor:
    """The exact MLL −½(rᵀK⁻¹r + log|K| + n log 2π), r = y_std − mean, with
    K row-sharded and built in the shard (replicated ``x``, ``y_std`` and
    ``raw``; the value on every rank). Differentiable in ``raw``, ``x`` and
    ``y_std`` by the closed form (``_DistributedMLL``), not by autograd
    through the panel loop, which would keep an (N/D, N) block per panel.
    Any N: the padded layout (``_layout``) adds nothing, and n is the
    active N."""
    return _DistributedMLL.apply(mesh, config, panel, x, y_std, *raw)


def _fit_distributed_raw(raw0: G.GPParams, x: Tensor, y_std: Tensor, mesh: Mesh, config: GPConfig, panel: int,
                         steps: int) -> G.GPParams:
    """``steps`` Adam steps on −(MLL + log prior)/n from ``raw0``, with
    ``gp._fit_adam``'s NaN rules (a non-finite gradient element is zeroed,
    a non-finite iterate keeps the last finite one), and ``raw0`` if the end
    is not finite."""
    n, dim = x.shape

    def loss(raw: G.GPParams) -> Tensor:
        val = distributed_mll(raw, x, y_std, mesh, config, panel)
        if config.fit_prior != "none":
            val = val + G.log_prior(raw, dim, config)  # the dense lane's MAP objective
        return -val / n

    cfg = dataclasses.replace(config, fit_optimizer="adam", fit_maxiter=steps, fit_ftol=0.0)
    raw, _, _ = G._fit_adam(raw0, loss, cfg)
    return G._where_rows(G._finite_rows(raw), raw, raw0)


def _standardized(y: Tensor, config: GPConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """(warp_y(y) standardized, its mean, its std (population, floored at
    1e-8))."""
    y_w = T.warp_y(y, config.y_warp)
    y_mean = y_w.mean()
    y_sd = torch.clamp_min(y_w.std(correction=0), 1e-8)
    return (y_w - y_mean) / y_sd, y_mean, y_sd


def fit_distributed_gp(x: Tensor, y: Tensor, mesh: Mesh, config: GPConfig = GPConfig(), panel: int = 128,
                       steps: Optional[int] = None, warm_start: Optional[G.GPParams] = None) -> "DistributedGP":
    """Fit the hypers by Adam over the distributed MLL (``config.fit_maxiter``
    steps by default) from the defaults or ``warm_start`` (one restart: at
    this scale one fit is the budget), then cache the row-sharded
    factorization. The fit never returns non-finite hypers: NaN gradients
    are dropped step by step, a non-finite warm start falls back to the
    defaults, and the factorization gets the escalating-jitter rescue."""
    dim = x.shape[-1]
    y_std, _, _ = _standardized(y, config)
    raw0 = G.default_params(dim, config, x.dtype, x.device)
    if warm_start is not None:
        with span("sync.dlinalg.warm_start"):
            finite = bool(G._finite_rows(warm_start))
        if finite:
            raw0 = G.GPParams(*(a.to(x.dtype) for a in warm_start))
    raw = _fit_distributed_raw(raw0, x, y_std, mesh, config, panel, steps or config.fit_maxiter)
    return _assemble_distributed_gp(x, y, raw, config, mesh, panel)


# --------------------------------------------------------------------------
# The user-facing distributed exact GP


class DistributedGP:
    """Exact GP whose O(N²) state is row-sharded over a mesh: the twin of
    ``gp.make_gp_state``/``gp_posterior`` when N outgrows a device. x and y
    are replicated, of any N; the factor and α are the rank's rows of the
    padded layout (``layout``: N_pad/D rows each, dealt out in blocks, zero
    α on the padded rows; ``layout.gather`` makes them whole).

        dgp = DistributedGP(mesh, kernel="matern52", panel=128)
        dgp.fit(x, y, lengthscale, outputscale, noise)
        mu, var = dgp.posterior(xs)

    or fit the hypers too: ``fit_distributed_gp(x, y, mesh)``."""

    def __init__(self, mesh: Mesh, kernel: str = "matern52", panel: int = 128, jitter: float = 1e-6):
        self.mesh = mesh
        self.kernel = kernel
        self.panel = panel
        self.jitter = jitter
        self.y_mean = 0.0  # the standardization (set by _assemble_distributed_gp)
        self.y_sd = 1.0

    def fit(self, x: Tensor, y: Tensor, lengthscale, outputscale, noise, mean=0.0) -> "DistributedGP":
        """Factor k(X, X) + σ²I with the fit's diagonal (the same bump as
        ``distributed_mll``) and the dense lane's escalating-jitter rescue
        (×1, ×1e2, ×1e4); a rung is kept when every rank's block is finite
        (an all-reduced flag: every rank takes the same rung)."""
        with span("dlinalg.factor"):
            kw = dict(dtype=x.dtype, device=x.device)
            self.x, self.y = x, y
            self.layout = _layout(x.shape[0], self.mesh, self.panel)
            self.params = {"lengthscale": torch.as_tensor(lengthscale, **kw),
                           "outputscale": torch.as_tensor(outputscale, **kw), "noise": torch.as_tensor(noise, **kw)}
            self.mean = torch.as_tensor(mean, **kw)
            with span("linalg.cholesky_ladder"):
                for scale in (1.0, 1e2, 1e4):
                    with span("linalg.cholesky_rung"):
                        chol = _kernel_chol(self.params, x, self.mesh, self.layout, self.panel, self.kernel,
                                            self.jitter * scale)
                    with span("sync.dlinalg.ladder"):
                        finite = all_true(torch.isfinite(chol).all(), self.mesh)
                    if finite:
                        break
            self.chol = chol
            self.alpha = _cho_solve(chol, self._rows(y - self.mean)[:, None], self.mesh, self.layout)
            return self

    def _rows(self, v: Tensor) -> Tensor:
        """This rank's rows of the replicated (N, ...) ``v``, zero on the
        padded rows."""
        return _pad_rows(v, self.layout)

    def posterior(self, xs: Tensor) -> Tuple[Tensor, Tensor]:
        """(μ, σ²) at ``xs`` in the standardization's units, replicated."""
        k_cross = _cross_rows(self.params, self.x, xs, self.layout, self.kernel)
        mu, var = _posterior(self.chol, self.alpha, k_cross, K.kernel_diag(self.params, xs), self.mesh, self.layout,
                             self.mean)
        return self.y_mean + self.y_sd * mu, var * self.y_sd**2

    def mll(self) -> Tensor:
        quad, logdet = all_sum(torch.stack([self._rows(self.y - self.mean) @ self.alpha[:, 0],
                                            _log_diag(self.chol, self.layout.index)]), self.mesh)
        return -0.5 * (quad + logdet + self.layout.n * _LOG_2PI)

    def pathwise_paths(self, xs: Tensor, n_paths: int, n_features: int = 1024,
                       generator: Optional[torch.Generator] = None, draws: A.Draws = A.Draws()) -> Tensor:
        """Decoupled pathwise draws at ``xs``: ``distributed_pathwise_paths``."""
        return distributed_pathwise_paths(self, xs, n_paths, n_features, generator, draws)


def distributed_pathwise_paths(dgp: DistributedGP, xs: Tensor, n_paths: int, n_features: int = 1024,
                               generator: Optional[torch.Generator] = None, draws: A.Draws = A.Draws()) -> Tensor:
    """Globally joint posterior sample paths at ``xs`` against a
    ``DistributedGP``, the twin of ``acq.pathwise_paths`` (Matheron's rule):

        f_post(x*) = φ(x*)ᵀw + k(x*, X)(K + σ²I)⁻¹(r − φ(X)ᵀw − ε),

    w ~ N(0, I_M), ε ~ N(0, σ²I). The φ and k(X, X*) row blocks are built in
    the shard, with one distributed cho_solve against the cached factor;
    per rank O(N·max(M, n_cand)/D + n_cand·M) memory. The draws come in
    ``acq.pathwise_paths``'s order (Ω and b, then w, then ε, all whole on
    every rank), ε at the active N's shape (q, N), so with the same
    generator state the dense and distributed samplers agree to solver
    precision; ``draws`` replaces them. The right-hand sides are zero on
    the padded rows. Returns (n_paths, n_cand) in the model's
    unstandardized units."""
    with span("acq.sample"):
        mesh, x, p, lay = dgp.mesh, dgp.x, dgp.params, dgp.layout
        n, dim = x.shape
        rows = lay.index[:lay.active]  # the rank's active rows of a replicated (N, ...) value
        kw = dict(dtype=xs.dtype, device=xs.device)
        omega, b = draws.omega, draws.b
        if omega is None or b is None:
            omega, b = A.rff_frequencies(dim, n_features, dgp.kernel, generator, xs.dtype, xs.device)
        omega, b = omega.to(**kw), b.to(**kw)
        ls = torch.broadcast_to(p["lengthscale"], (dim,))
        w = A._normals((n_paths, omega.shape[0]), draws.weights, generator, xs)
        eps = torch.sqrt(p["noise"]) * A._normals((n_paths, n), draws.eps, generator, xs)
        # rhs = r − φ(X)ᵀw − ε on the rank's active rows, then zero on its padded ones:
        # the (N/D, M) φ block, never a global (N, M)
        phi_rows = A._rff_phi(x[rows], omega, b, ls, p["outputscale"])
        rhs = _pad_to((dgp.y[rows] - dgp.mean)[:, None] - phi_rows @ w.mT - eps.mT[rows], lay.rows)
        u = _cho_solve(dgp.chol, rhs, mesh, lay)  # (N_pad/D, n_paths)
        k_cross = _cross_rows(p, x, xs, lay, dgp.kernel)  # (N_pad/D, n_cand)
        update = all_sum(k_cross.mT @ u, mesh)  # (n_cand, n_paths)
        prior_c = w @ A._rff_phi(xs, omega, b, ls, p["outputscale"]).mT  # (n_paths, n_cand)
        return dgp.y_mean + dgp.y_sd * (dgp.mean + prior_c + update.mT)


# --------------------------------------------------------------------------
# Auto-routing: the dense GP below the memory threshold, the distributed GP above

#: Per-device bytes the dense fit may spend by the rule's count (3 N² ·
#: itemsize: K, its factor, the autograd residuals) before a multi-device mesh
#: distributes it. Measured on an NVIDIA H100 80GB HBM3 at 700 W
#: (``python3 -m turbojax_torch.bench_large_n --budget``): the default dense
#: fit (L-BFGS, four restarts as one batch) peaks at 2.44 / 9.57 / 38.07 GiB
#: at N = 4096 / 8192 / 16384 in float32, 12.7-13.0× the rule's count. 3 GiB
#: keeps the dense route up to N = 16384, whose fit peaks at 48% of the
#: card's 79.2 GiB and leaves the rest to the loop around it (the posterior
#: over the candidates, the next batch); the JAX package's 2 GiB was sized
#: for a 16 GiB TPU chip.
DENSE_BUDGET_BYTES = 3 << 30


def should_distribute(n: int, mesh: Optional[Mesh], dtype=torch.float32,
                      budget_bytes: int = DENSE_BUDGET_BYTES) -> bool:
    """True when the dense fit's working set, ~3 N² buffers, exceeds the
    per-device budget and a mesh of more than one device is there to shard
    it."""
    if mesh is None or mesh.size <= 1:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 3 * n * n * itemsize > budget_bytes


class _DenseGPAdapter:
    """A dense ``gp.GPState`` behind the distributed GP's interface, so that
    callers of ``fit_gp_auto`` see one surface either way."""

    def __init__(self, state: G.GPState, config: GPConfig, y_std_buf: Tensor):
        self.state = state
        self.config = config
        self.raw = state.raw
        self._y_std_buf = y_std_buf

    def posterior(self, xs: Tensor) -> Tuple[Tensor, Tensor]:
        return G.gp_posterior(self.state, xs, self.config)

    def mll(self) -> Tensor:
        """The MLL of the warped, standardized targets (the distributed GP's
        convention)."""
        return G.mll(self.state.raw, self.state.x_buf, self._y_std_buf, self.state.mask, self.config)

    def pathwise_paths(self, xs: Tensor, n_paths: int, n_features: int = 1024,
                       generator: Optional[torch.Generator] = None, draws: A.Draws = A.Draws()) -> Tensor:
        """Decoupled pathwise draws at ``xs``: ``acq.pathwise_paths``."""
        return A.pathwise_paths(self.state, xs, n_paths, self.config, n_features, generator, draws)


def _adapt_dense(state: G.GPState, y: Tensor, mask: Tensor, config: GPConfig) -> _DenseGPAdapter:
    y_std_buf, _, _ = T.standardize(T.warp_y(y, config.y_warp), mask)
    return _DenseGPAdapter(state, config, y_std_buf)


def _assemble_distributed_gp(x: Tensor, y: Tensor, raw: G.GPParams, config: GPConfig, mesh: Mesh,
                             panel: int) -> DistributedGP:
    """A ``DistributedGP`` at the hypers ``raw`` over the raw targets ``y``:
    warp_y → standardize → factor, recording ``y_mean``, ``y_sd`` and
    ``raw``. The fit and the refactor routes both end here, so they cannot
    disagree on the convention."""
    params = G.constrain_params(raw, config)
    y_std, y_mean, y_sd = _standardized(y, config)
    dgp = DistributedGP(mesh, kernel=config.kernel, panel=panel, jitter=config.jitter)
    dgp.fit(x, y_std, params["lengthscale"], params["outputscale"], params["noise"], mean=params["mean"])
    dgp.y_mean, dgp.y_sd, dgp.raw = y_mean, y_sd, raw
    return dgp


def fit_gp_auto(
    x: Tensor,
    y: Tensor,
    config: GPConfig = GPConfig(),
    mesh: Optional[Mesh] = None,
    panel: int = 128,
    budget_bytes: int = DENSE_BUDGET_BYTES,
    warm_start: Optional[G.GPParams] = None,
    generator: Optional[torch.Generator] = None,
    restart_uniforms: Optional[Tensor] = None,
):
    """Fit an exact GP on the unmasked history ``(x, y)``, routed by
    ``should_distribute``: the dense ``gp.fit_gp`` (multi-restart, its
    optimizer) or ``fit_distributed_gp`` (Adam over the row-sharded MLL).
    Returns an object with ``.posterior(xs) -> (mu, var)``, ``.mll()``,
    ``.pathwise_paths(xs, n_paths, ...)`` and ``.raw`` (pass it back as ``warm_start`` for the next refit). Where the
    JAX package takes a key, the dense route takes the restart draws:
    ``generator`` or ``restart_uniforms``, as ``gp.fit_gp`` does."""
    n = x.shape[0]
    if should_distribute(n, mesh, x.dtype, budget_bytes):
        return fit_distributed_gp(x, y, mesh, config, panel, warm_start=warm_start)
    mask = L.row_mask(n, n, x.device)
    state = G.fit_gp(x, y, mask, config, warm_start=warm_start, generator=generator,
                     restart_uniforms=restart_uniforms)
    return _adapt_dense(state, y, mask, config)


def refactor_gp_auto(
    x: Tensor,
    y: Tensor,
    raw: G.GPParams,
    config: GPConfig = GPConfig(),
    mesh: Optional[Mesh] = None,
    panel: int = 128,
    budget_bytes: int = DENSE_BUDGET_BYTES,
):
    """Rebuild the cached factorization over the current ``(x, y)`` at the
    pinned hypers ``raw``: the off-cadence twin of ``fit_gp_auto`` (same
    routing, same surface, no MLL optimization). The posterior must see
    every observation between refits; reusing a stale fitted object would
    skip the newest batches."""
    n = x.shape[0]
    if should_distribute(n, mesh, x.dtype, budget_bytes):
        return _assemble_distributed_gp(x, y, raw, config, mesh, panel)
    mask = L.row_mask(n, n, x.device)
    state = G.make_gp_state(x, y, mask, raw, config)
    return _adapt_dense(state, y, mask, config)
