"""The exact GP with K row-block-sharded over a mesh: blocked Cholesky,
solves, the MLL with its closed-form gradient, the fit, the posterior and
pathwise draws, and the auto-routing between it and the dense GP (port of
``turbojax.distributed_linalg``).

Layout (``parallel``'s contract): K (N, N) is sharded by row blocks, rank r
owning rows [r·N/D, (r+1)·N/D); a function takes and returns each sharded
matrix as the rank's block and each replicated value whole. The sharded
primitives (``distributed_cholesky``, the solves, ``distributed_gp_posterior``)
take N a multiple of D·P. The GP level (``DistributedGP``, ``distributed_mll``,
the in-shard builds, ``distributed_pathwise_paths``) takes any N: it pads
the history to N_pad, the next multiple of D·P (``_layout``), with padded
rows and columns of K the identity's (off-diagonal 0, diagonal 1, as
``linalg.mask_kernel_matrix`` pads the dense route), residual 0 and a zero
cross block, so that they add nothing to the solves, 0 to log|K| and the
MLL counts the active N; the draws keep the active N's shapes. The
factorization is right-looking over column panels of width P (P divides
N_pad/D, so a panel's rows live on one rank); per panel:

1. all-gather the panel column (N·P values, the only communication: the
   matrix once over the whole run);
2. every rank factors the P × P diagonal block itself (``linalg.
   cholesky_nan``: a failed block is NaN, as ``jnp.linalg.cholesky``'s is)
   and solves the gathered column below it;
3. every rank updates its own rows below the panel on the columns right of
   it up to its last row (the narrow trailing slice; the columns past it
   are the upper triangle's), in place.

The substitutions go by rank blocks: each rank's diagonal block is one
triangular solve, and D broadcasts (forward) or all-reduces (backward) of
an (N/D, m) block carry the coupling, whatever the panel.

No rank holds the dense N × N matrix: the row blocks of k(X, X) and of the
crosses k(X, X*) are built inside the shard from the replicated X by
``cuda_kernels.kernel_matrix`` (the CUDA kernel on CUDA tensors), with one
centre computed from the whole X (a per-block centre would give each rank a
slightly different K) and, for K's row blocks, the exact self-value on the
global diagonal (``diag_offset``). The panel loop is a host loop: it is the
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


class Layout(NamedTuple):
    """The padded row layout of an N-row history on a mesh."""

    n: int  # the active rows
    n_pad: int  # N padded to the next multiple of D·P
    rows: int  # rows of one rank's block, N_pad/D
    row0: int  # this rank's first row


def _layout(n: int, mesh: Mesh, panel: int) -> Layout:
    unit = mesh.size * panel
    n_pad = -(-n // unit) * unit
    rows = n_pad // mesh.size
    return Layout(n, n_pad, rows, mesh.rank * rows)


def _active(lay: Layout) -> int:
    """This rank's active rows: the first ones of its block."""
    return min(max(lay.n - lay.row0, 0), lay.rows)


def _pad_to(block: Tensor, rows: int) -> Tensor:
    short = rows - block.shape[0]
    return block if short == 0 else torch.cat([block, block.new_zeros((short, *block.shape[1:]))])


def _pad_rows(v: Tensor, lay: Layout) -> Tensor:
    """This rank's row block of the replicated (N, ...) ``v``, zero on the
    padded rows."""
    return _pad_to(v[lay.row0:lay.row0 + lay.rows], lay.rows)


def _span(a: int, b: int, row0: int, rows: int) -> Tuple[int, int]:
    """The local rows [lo, hi) of the global rows [a, b)."""
    return min(max(a - row0, 0), rows), min(max(b - row0, 0), rows)


# --------------------------------------------------------------------------
# Panel algorithms on the local row block (rows [row0, row0 + rows) of N)


def _local_chol(a: Tensor, mesh: Mesh, row0: int, rows: int, panel: int, n: int) -> Tensor:
    """Blocked right-looking Cholesky of the row-sharded matrix whose block
    ``a`` is, in place: ``a`` becomes the block of the lower factor."""
    for c0 in range(0, n, panel):
        t0 = c0 + panel
        col_full = gather_rows(a[:, c0:t0], mesh)  # (n, panel)
        l_kk = L.cholesky_nan(col_full[c0:t0])[0]
        lcol = torch.linalg.solve_triangular(l_kk.mT, col_full[t0:], upper=True, left=False)  # rows t0..n
        lo, hi = _span(c0, t0, row0, rows)
        a[:lo, c0:t0] = 0.0
        a[lo:hi, c0:t0] = l_kk[row0 + lo - c0:row0 + hi - c0]
        if hi < rows:
            a[hi:, c0:t0] = lcol[row0 + hi - t0:row0 + rows - t0]
            # the narrow trailing slice of the rows below, on the lower triangle's columns
            a[hi:, t0:row0 + rows].addmm_(a[hi:, c0:t0], lcol[:row0 + rows - t0].mT, alpha=-1.0)
    return a


def _local_solve_lower(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, row0: int, rows: int) -> Tensor:
    """x = L⁻¹ b with L and b (N, m) row-sharded: forward substitution by
    rank blocks. Rank r solves its diagonal block L_rr (one triangular
    solve), broadcasts its x_r, and the ranks below take L_jr x_r off their
    right-hand sides: D broadcasts in all, whatever the panel."""
    x = b_loc.clone()
    for r in range(mesh.size):
        if mesh.rank == r:
            x = torch.linalg.solve_triangular(l_loc[:, row0:row0 + rows], x, upper=False)
            x_r = broadcast_from(x, mesh, src=r)
        else:
            x_r = broadcast_from(torch.empty_like(x), mesh, src=r)
        if mesh.rank > r:
            x.addmm_(l_loc[:, r * rows:(r + 1) * rows], x_r, alpha=-1.0)
    return x


def _local_solve_upper_t(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, row0: int, rows: int) -> Tensor:
    """x = L⁻ᵀ b (backward substitution), same layout, by rank blocks from
    the last: x_r = L_rr⁻ᵀ(b_r − Σ_{j>r} L_jrᵀ x_j), the ranks below r
    sending their terms and rank r its b_r in one all-reduce (a masked sum,
    as the JAX package's ``psum``): D all-reduces in all."""
    x = b_loc
    for r in reversed(range(mesh.size)):
        if mesh.rank == r:
            part = b_loc
        elif mesh.rank > r:
            part = -(l_loc[:, r * rows:(r + 1) * rows].mT @ x)
        else:
            part = torch.zeros_like(b_loc)
        total = all_sum(part, mesh)
        if mesh.rank == r:
            x = torch.linalg.solve_triangular(l_loc[:, row0:row0 + rows].mT, total, upper=True)
    return x


def _block_layout(mat_loc: Tensor, mesh: Mesh, panel: int) -> Layout:
    """The layout of a row block (rows, N) of the sharded primitives: N a
    multiple of D·P, no padding."""
    lay = _layout(mat_loc.shape[-1], mesh, panel)
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
    lay = _block_layout(k_loc, mesh, panel)
    return _local_chol(k_loc.clone(), mesh, lay.row0, lay.rows, panel, lay.n)


def distributed_solve_lower(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128, unroll="auto") -> Tensor:
    """x = L⁻¹ b with L and b (N, m) row-sharded alike."""
    lay = _block_layout(l_loc, mesh, panel)
    return _local_solve_lower(l_loc, b_loc, mesh, lay.row0, lay.rows)


def distributed_solve_upper_t(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128,
                              unroll="auto") -> Tensor:
    """x = L⁻ᵀ b (backward substitution), same layout."""
    lay = _block_layout(l_loc, mesh, panel)
    return _local_solve_upper_t(l_loc, b_loc, mesh, lay.row0, lay.rows)


def distributed_cho_solve(l_loc: Tensor, b_loc: Tensor, mesh: Mesh, panel: int = 128, unroll="auto") -> Tensor:
    """(L Lᵀ)⁻¹ b: forward, then backward substitution."""
    return distributed_solve_upper_t(l_loc, distributed_solve_lower(l_loc, b_loc, mesh, panel), mesh, panel)


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
    a = alpha_loc.reshape(-1)
    v = distributed_solve_lower(l_loc, k_cross_loc, mesh, panel)
    parts = all_sum(torch.stack([k_cross_loc.mT @ a, (v * v).sum(dim=0)]), mesh)
    return mean + parts[0], torch.clamp_min(k_diag - parts[1], 1e-12)


def _global_diag(l_loc: Tensor, row0: int) -> Tensor:
    r = torch.arange(l_loc.shape[0], device=l_loc.device)
    return l_loc[r, row0 + r]


def distributed_logdet_from_chol(l_loc: Tensor, mesh: Mesh) -> Tensor:
    """log|K| = 2 Σ log diag(L), the diagonal's row blocks all-reduced."""
    return all_sum(2.0 * torch.log(_global_diag(l_loc, mesh.rank * l_loc.shape[0])).sum(), mesh)


# --------------------------------------------------------------------------
# In-shard kernel builds: no rank holds the dense N × N matrix


def _kernel_rows(params: Dict[str, Tensor], x: Tensor, lay: Layout, kernel: str, bump) -> Tensor:
    """k(X_rows, X) + bump on the global diagonal over the padded layout,
    the diagonal's values the exact outputscale + bump. A padded row of X
    is zero before the centring, and the one centre, the mean of the active
    rows, is the same on every rank. The padded rows and columns are not
    masked here (``_mask_padding_``). On a mesh of one device the block is
    the whole matrix, passed as one tensor: the kernel's symmetric
    schedule."""
    z = _pad_to(x, lay.n_pad) / params["lengthscale"]
    z = (z - z[:lay.n].mean(dim=0, keepdim=True)).contiguous()
    z_rows = z if lay.rows == z.shape[0] else z[lay.row0:lay.row0 + lay.rows]
    return CK.kernel_matrix(z_rows, z, params["outputscale"], bump, kernel, add_noise=True, diag_offset=lay.row0)


def _mask_padding_(k_loc: Tensor, lay: Layout) -> Tensor:
    """K's row block with its padded rows and columns the identity's
    (``linalg.mask_kernel_matrix``'s padding), in place."""
    if lay.n_pad == lay.n:
        return k_loc
    a = _active(lay)
    k_loc[:, lay.n:] = 0.0
    k_loc[a:] = 0.0
    r = torch.arange(a, lay.rows, device=k_loc.device)
    k_loc[r, lay.row0 + r] = 1.0
    return k_loc


def _mask_grad_(gk: Tensor, lay: Layout) -> Tensor:
    """ḡK zero on the padded rows and columns, in place: they are
    constants, not the kernel's."""
    if lay.n_pad != lay.n:
        gk[:, lay.n:] = 0.0
        gk[_active(lay):] = 0.0
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
    σ²I (+ the relative ``jitter``) over the padded layout (``_layout``:
    its padded block the identity), built in the shard from the replicated
    X (N, d): the largest live array is the row block. ``params`` holds
    "lengthscale", "outputscale" and "noise"."""
    lay = _layout(x.shape[0], mesh, panel)
    k_loc = _mask_padding_(_kernel_rows(params, x, lay, kernel, _bump(params, jitter)), lay)
    return _local_chol(k_loc, mesh, lay.row0, lay.rows, panel, lay.n_pad)


def distributed_cross_covariance(params: Dict[str, Tensor], x: Tensor, xs: Tensor, mesh: Mesh,
                                 kernel: str = "matern52", panel: int = 128) -> Tensor:
    """The row block of k(X, X*) (N_pad/D × m) over the padded layout
    (``_layout``; zero on the padded rows), built in the shard; the centre
    is the dense posterior's, from the whole X and X*."""
    lay = _layout(x.shape[0], mesh, panel)
    ls = params["lengthscale"]
    zx, zs = x / ls, xs / ls
    c = 0.5 * (zx.mean(dim=0, keepdim=True) + zs.mean(dim=0, keepdim=True))
    out = CK.kernel_matrix(_pad_rows(zx - c, lay).contiguous(), (zs - c).contiguous(), params["outputscale"], 0.0,
                           kernel, False)
    out[_active(lay):] = 0.0
    return out


# --------------------------------------------------------------------------
# The distributed MLL and the fit


def _mll_parts(raw: G.GPParams, x: Tensor, y_std: Tensor, mesh: Mesh, config: GPConfig,
               panel: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Kernel rows → blocked Cholesky → forward solve (quad = ‖L⁻¹r‖²) →
    logdet. Returns (mll, L's row block, v = L⁻¹r's row block)."""
    lay = _layout(x.shape[0], mesh, panel)
    params = G.constrain_params(raw, config)
    k_loc = _mask_padding_(_kernel_rows(params, x, lay, config.kernel, _bump(params, config.jitter)), lay)
    l_loc = _local_chol(k_loc, mesh, lay.row0, lay.rows, panel, lay.n_pad)
    resid = _pad_rows(y_std - params["mean"], lay)[:, None]
    v_loc = _local_solve_lower(l_loc, resid, mesh, lay.row0, lay.rows)
    quad, logdet = all_sum(torch.stack([(v_loc * v_loc).sum(),
                                        2.0 * torch.log(_global_diag(l_loc, lay.row0)).sum()]), mesh)
    return -0.5 * (quad + logdet + lay.n * _LOG_2PI), l_loc, v_loc


class _DistributedMLL(torch.autograd.Function):
    """Forward: the MLL, saving L and α = K⁻¹r. Backward: the closed form,
    ∂MLL/∂K = ½(ααᵀ − K⁻¹) on the local block (K⁻¹'s rows from
    substitutions against the identity's rows, made in the shard), zero on
    the padded rows and columns, pulled back through the in-shard kernel
    build by ``torch.autograd.grad``, the hypers' and X's gradients
    all-reduced, and ∂MLL/∂y_std = −α on the active rows."""

    @staticmethod
    def forward(ctx, mesh, config, panel, x, y_std, *raw_leaves):
        mll_val, l_loc, v_loc = _mll_parts(G.GPParams(*raw_leaves), x, y_std, mesh, config, panel)
        alpha_loc = distributed_solve_upper_t(l_loc, v_loc, mesh, panel)[:, 0]
        ctx.mesh, ctx.config, ctx.panel = mesh, config, panel
        ctx.save_for_backward(x, l_loc, alpha_loc, *raw_leaves)
        return mll_val

    @staticmethod
    def backward(ctx, g):
        mesh, config, panel = ctx.mesh, ctx.config, ctx.panel
        x, l_loc, alpha_loc, *raw_leaves = ctx.saved_tensors
        lay = _layout(x.shape[0], mesh, panel)
        r = torch.arange(lay.rows, device=x.device)
        eye_loc = torch.zeros((lay.rows, lay.n_pad), dtype=l_loc.dtype, device=l_loc.device)
        eye_loc[r, lay.row0 + r] = 1.0
        kinv_loc = distributed_cho_solve(l_loc, eye_loc, mesh, panel)
        del eye_loc
        alpha = gather_rows(alpha_loc, mesh)
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
    are replicated, of any N; the factor and α are row blocks of the padded
    layout (``layout``: N_pad/D rows each, zero α on the padded rows).

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
                        chol = distributed_kernel_chol(self.params, x, self.mesh, self.panel, self.kernel,
                                                       jitter=self.jitter * scale)
                    with span("sync.dlinalg.ladder"):
                        finite = all_true(torch.isfinite(chol).all(), self.mesh)
                    if finite:
                        break
            self.chol = chol
            self.alpha = distributed_cho_solve(chol, self._rows(y - self.mean)[:, None], self.mesh, self.panel)
            return self

    def _rows(self, v: Tensor) -> Tensor:
        """This rank's row block of the replicated (N, ...) ``v``, zero on
        the padded rows."""
        return _pad_rows(v, self.layout)

    def posterior(self, xs: Tensor) -> Tuple[Tensor, Tensor]:
        """(μ, σ²) at ``xs`` in the standardization's units, replicated."""
        k_cross = distributed_cross_covariance(self.params, self.x, xs, self.mesh, self.kernel, self.panel)
        mu, var = distributed_gp_posterior(self.chol, self.alpha, k_cross, K.kernel_diag(self.params, xs),
                                           self.mesh, self.panel, self.mean)
        return self.y_mean + self.y_sd * mu, var * self.y_sd**2

    def mll(self) -> Tensor:
        quad = all_sum(self._rows(self.y - self.mean) @ self.alpha[:, 0], self.mesh)
        return -0.5 * (quad + distributed_logdet_from_chol(self.chol, self.mesh) + self.layout.n * _LOG_2PI)

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
        rows = slice(lay.row0, lay.row0 + lay.rows)  # the rank's active rows of a replicated (N, ...) value
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
        u = distributed_cho_solve(dgp.chol, rhs, mesh, dgp.panel)  # (N_pad/D, n_paths)
        k_cross = distributed_cross_covariance(p, x, xs, mesh, dgp.kernel, dgp.panel)  # (N_pad/D, n_cand)
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
    Returns an object with ``.posterior(xs) -> (mu, var)``, ``.mll()`` and
    ``.raw`` (pass it back as ``warm_start`` for the next refit). Where the
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
