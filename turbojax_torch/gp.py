"""GP surrogate: masked MLL, the grid and grid+Adam trainers, batched
posterior (port of ``turbojax.gp``, main-path part).

All state lives in statically shaped masked buffers (``linalg``). Inputs
are scaled by 1/ℓ and centered by ``_scale_center``; every kernel-matrix
build then goes through ``cuda_kernels.kernel_matrix`` and every
Thompson-chunk covariance through ``cuda_kernels.ts_cov``: the hand-written
CUDA kernels on CUDA tensors, their plain versions on CPU tensors.

The trainers take a leading batch axis on the buffers (one row per trust
region, in place of the JAX package's ``vmap``): the grid's hyperparameter
rows of every region are one batch (one kernel launch, one batched
Cholesky), and the Adam polish is one batched loss whose per-region terms
are summed, so that each region gets its own exact gradient.

Ported: ``GPParams``, ``GPState``, ``constrain_params``, ``default_params``,
``grid_params``, ``mll``, ``make_gp_state``, ``fit_gp`` with
``fit_optimizer="grid"`` and ``"grid+adam"`` (with the warm row),
``gp_posterior`` and ``posterior_cov``. The other trainers ("lbfgs",
"adam" with restarts), ``fit_ftol``, ``grid_polish_both`` and the MAP prior
are later work and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from turbojax_torch import cuda_kernels as CK
from turbojax_torch import kernels as K
from turbojax_torch import linalg as L
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453

# Above this many bytes of batched grid-fit work (~3·N²·itemsize per row)
# the rows are scored one after another. The constant is the JAX package's,
# measured on a TPU; it has not been measured on a GPU yet.
_GRID_VMAP_BUDGET_BYTES = 12 << 30
# gp_posterior auto-chunks the candidate axis when the (N_max, m) cross
# matrix exceeds this size (the JAX package's constant, not yet re-measured).
_POSTERIOR_AUTO_CHUNK_BYTES = 128 << 20


class GPParams(NamedTuple):
    """Unconstrained (raw) hyperparameters; constrain via ``constrain_params``.
    A leading batch dimension on every field stacks several settings."""

    raw_lengthscale: Tensor  # (d,) with ARD, (1,) without
    raw_outputscale: Tensor  # ()
    raw_noise: Tensor  # ()
    raw_mean: Tensor  # ()


class GPState(NamedTuple):
    """Fitted-GP cache: the identity-padded Cholesky of K(X,X)+σ²I, the
    solve α = (K+σ²I)⁻¹(y_std − m), and the y standardization constants."""

    x_buf: Tensor  # (N_max, d), zero-padded
    mask: Tensor  # (N_max,) bool
    params: Dict[str, Tensor]  # constrained: lengthscale, outputscale, noise, mean
    raw: GPParams
    chol: Tensor  # (N_max, N_max)
    alpha: Tensor  # (N_max,)
    y_mean: Tensor  # ()
    y_std: Tensor  # ()


def constrain_params(raw: GPParams, config: GPConfig) -> Dict[str, Tensor]:
    lo, hi = config.lengthscale_bounds
    so, sh = config.outputscale_bounds
    no, nh = config.noise_bounds
    return {
        "lengthscale": T.constrain(raw.raw_lengthscale, lo, hi),
        "outputscale": T.constrain(raw.raw_outputscale, so, sh),
        "noise": torch.clamp_min(T.constrain(raw.raw_noise, no, nh), config.noise_floor),
        "mean": raw.raw_mean if config.learn_mean else torch.zeros_like(raw.raw_mean),
    }


def default_params(dim: int, config: GPConfig, dtype=torch.float32, device=None) -> GPParams:
    """Initial hypers: ℓ=0.5 (unit cube), s²=1, σ²=max(1e-3, noise floor)."""
    d_eff = dim if config.use_ard else 1
    lo, hi = config.lengthscale_bounds
    so, sh = config.outputscale_bounds
    no, nh = config.noise_bounds

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return GPParams(
        raw_lengthscale=T.unconstrain(scalar(0.5), lo, hi).expand(d_eff).clone(),
        raw_outputscale=T.unconstrain(scalar(1.0), so, sh),
        raw_noise=T.unconstrain(scalar(max(1e-3, config.noise_floor)), no, nh),
        raw_mean=scalar(0.0),
    )


def grid_params(dim: int, config: GPConfig, dtype=torch.float32, device=None) -> GPParams:
    """The static hyperparameter grid of ``fit_optimizer="grid"``: isotropic
    lengthscale × noise combos (outputscale 1 on standardized y), stacked on
    a leading axis. Values sit strictly inside the constraint boxes."""
    lo, hi = config.lengthscale_bounds
    no, nh = config.noise_bounds
    so, sh = config.outputscale_bounds
    ls_vals = [v for v in (0.1, 0.25, 0.5, 1.0, 1.9) if lo < v < hi]
    nz_vals = [v for v in (2e-4, 1e-3, 1e-2) if no < v < nh]
    d_eff = dim if config.use_ard else 1
    combos = [(ls, nz) for ls in ls_vals for nz in nz_vals]
    ls = torch.tensor([ls for ls, _ in combos], dtype=dtype, device=device)
    nz = torch.tensor([nz for _, nz in combos], dtype=dtype, device=device)
    ones = torch.ones(len(combos), dtype=dtype, device=device)
    return GPParams(
        raw_lengthscale=T.unconstrain(ls, lo, hi)[:, None].expand(len(combos), d_eff).clone(),
        raw_outputscale=T.unconstrain(ones, so, sh),
        raw_noise=T.unconstrain(nz, no, nh),
        raw_mean=torch.zeros(len(combos), dtype=dtype, device=device),
    )


def _scale_center(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """The inputs both kernels take: scaled by 1/ℓ and centered on the
    shared mean (the expansion's eps·‖z‖² error otherwise swamps clustered
    trust-region candidates). Pass the same tensor as x1 and x2 for one
    input; then the same tensor comes back twice."""
    ls = params["lengthscale"].unsqueeze(-2)
    same = x2 is x1
    z1 = x1 / ls
    z2 = z1 if same else x2 / ls
    c = 0.5 * (z1.mean(dim=-2, keepdim=True) + z2.mean(dim=-2, keepdim=True))
    z1 = (z1 - c).contiguous()
    return z1, (z1 if same else (z2 - c).contiguous())


def _kernel_matrix(
    params: Dict[str, Tensor], x1: Tensor, x2: Tensor, config: GPConfig, add_noise: bool
) -> Tensor:
    """k(x1, x2) (+ noise on the diagonal) through the kernel wrapper.
    Batched hypers (a leading axis on every param) give a batched (B, n, m)
    result from one launch. Pass the same tensor as x1 and x2 for K(X, X)."""
    z1, z2 = _scale_center(params, x1, x2)
    kernel_fn = CK.kernel_matrix_reference if config.use_kernel is False else CK.kernel_matrix
    return kernel_fn(z1, z2, params["outputscale"], params["noise"], config.kernel, add_noise)


def _masked_kernel_chol(
    params: Dict[str, Tensor], x_buf: Tensor, mask: Tensor, config: GPConfig, ladder: bool = False
) -> Tensor:
    k_mat = L.mask_kernel_matrix(_kernel_matrix(params, x_buf, x_buf, config, add_noise=True), mask)
    if ladder:
        # escalating-jitter rescue for the cached factorization: near-duplicate
        # rows at fitted hypers can defeat the fixed jitter in f32
        return L.safe_cholesky(k_mat, (config.jitter, 1e2 * config.jitter, 1e4 * config.jitter))
    return L.cholesky_jittered(k_mat, config.jitter)


def mll(raw: GPParams, x_buf: Tensor, y_std: Tensor, mask: Tensor, config: GPConfig) -> Tensor:
    """Exact marginal log-likelihood over the active block:
    −½ rᵀα − ½ log|K+σ²I| − (n/2) log 2π, with r = y_std − m. A leading
    batch axis on ``raw`` gives one MLL per row (the buffers either shared,
    or batched alike: x (B, N, d), y_std and mask (B, N)); a row whose
    factorization failed scores NaN."""
    params = constrain_params(raw, config)
    chol = _masked_kernel_chol(params, x_buf, mask, config)
    resid = torch.where(mask, y_std - params["mean"][..., None], torch.zeros_like(y_std))
    alpha = L.cho_solve(chol, resid)
    quad = (resid * alpha).sum(dim=-1)
    logdet = L.masked_logdet_from_chol(chol, mask)
    n_act = mask.sum(dim=-1).to(y_std.dtype)
    return -0.5 * (quad + logdet + n_act * _LOG_2PI)


def _row(p: GPParams, i) -> GPParams:
    """Row ``i`` (an int or a 0-dim device tensor) of stacked params. A
    1-element ``index_select``: indexing with a 0-dim tensor reads it back to
    the host."""
    idx = torch.as_tensor(i, device=p.raw_noise.device).reshape(1)
    return GPParams(*(a.index_select(0, idx)[0] for a in p))


def _finite_rows(p: GPParams) -> Tensor:
    """Per setting of (possibly stacked) params: are all its leaves finite?"""
    lead = p.raw_noise.shape
    return torch.stack([torch.isfinite(a.reshape(lead + (-1,))).all(dim=-1) for a in p]).all(dim=0)


def _where_rows(ok: Tensor, a: GPParams, b: GPParams) -> GPParams:
    """Per setting: ``a`` where ``ok``, else ``b``."""
    return GPParams(*(torch.where(ok.reshape(ok.shape + (1,) * (x.dim() - ok.dim())), x, y) for x, y in zip(a, b)))


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _fit_one(raw0: GPParams, x_buf: Tensor, y_std: Tensor, mask: Tensor, config: GPConfig) -> Tuple[GPParams, Tensor]:
    """Adam with a fixed trip count from ``raw0``; returns (params, final
    −mll/n). A leading axis on ``raw0`` is a batch of independent lanes
    (with x (L, N, d), y_std and mask (L, N), or buffers shared by all):
    their losses are summed, so each lane gets its own exact gradient.

    The step is ``optax.adam(fit_lr)`` written out (b1 0.9, b2 0.999, eps
    1e-8 after the square root, bias-corrected) with the JAX package's
    NaN-robust step, per lane: a non-finite gradient element is zeroed, the
    update is applied (the moments still decay), and the previous iterate
    is kept only where the new one is non-finite. A failed factorization
    gives NaN or zero gradients here where JAX gives NaN; both end as zero."""
    if config.fit_optimizer != "adam":
        raise NotImplementedError(f"fit_optimizer={config.fit_optimizer!r} in _fit_one is not ported yet; only 'adam' is")
    if config.fit_ftol > 0.0:
        raise NotImplementedError("fit_ftol > 0 (the early-stopping Adam lane) is not ported yet")
    if config.fit_prior != "none":
        raise NotImplementedError("fit_prior != 'none' (the MAP prior) is not ported yet")
    n_act = torch.clamp_min(mask.sum(dim=-1).to(y_std.dtype), 1.0)

    def loss(raw: GPParams) -> Tensor:
        return -mll(raw, x_buf, y_std, mask, config) / n_act

    raw = GPParams(*(a.detach() for a in raw0))
    mu = [torch.zeros_like(a) for a in raw]
    nu = [torch.zeros_like(a) for a in raw]
    for step in range(1, config.fit_maxiter + 1):
        leaves = [a.clone().requires_grad_(True) for a in raw]
        total = loss(GPParams(*leaves)).sum()
        with record_function("gp.polish_backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                 for a, g in zip(raw, grads)]
        mu = [(1 - _ADAM_B1) * g + _ADAM_B1 * m for g, m in zip(grads, mu)]
        nu = [(1 - _ADAM_B2) * g**2 + _ADAM_B2 * v for g, v in zip(grads, nu)]
        bc1, bc2 = 1 - _ADAM_B1**step, 1 - _ADAM_B2**step
        new = GPParams(*(
            p + (-config.fit_lr) * ((m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS))
            for p, m, v in zip(raw, mu, nu)
        ))
        raw = _where_rows(_finite_rows(new), new, raw)
    with torch.no_grad():
        return raw, loss(raw)


def _fit_gp_grid(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig, adam_polish: bool = False,
    warm_start: Optional[GPParams] = None,
) -> GPState:
    """Grid MLL selection: score every grid combo as one batch (one kernel
    launch, one batched Cholesky) and keep the argmax; a row with a
    non-finite MLL (failed factorization) scores −inf.

    ``adam_polish`` (``fit_optimizer="grid+adam"``): the warm start (the
    previous refit's hypers, sanitized to the defaults when non-finite)
    joins the grid as one more row when ``grid_warm_start``; the argmax is
    refined by ``fit_maxiter_warm or 10`` Adam steps, and the polish is kept
    only when its loss beats the grid's.

    Leading axes on the buffers (x (T, N, d), y and mask (T, N), and on
    ``warm_start``) are independent fits, one per trust region: all their
    rows are scored in one batch and polished as one batch of lanes."""
    if config.fit_prior != "none":
        raise NotImplementedError("fit_prior != 'none' (the MAP prior) is not ported yet")
    if adam_polish and config.grid_polish_both:
        raise NotImplementedError("grid_polish_both (the dual polish) is not ported yet")
    n_cap, dim = x_buf.shape[-2:]
    lead = x_buf.shape[:-2]
    n_fit = int(torch.Size(lead).numel())
    dtype, device = y_buf.dtype, y_buf.device
    x_t = x_buf.reshape(n_fit, n_cap, dim)
    mask_t = mask.expand(lead + (n_cap,)).reshape(n_fit, n_cap)
    y_std_t, _, _ = T.standardize(T.warp_y(y_buf.reshape(n_fit, n_cap), config.y_warp), mask_t)

    grid = grid_params(dim, config, dtype, device)
    inits = GPParams(*(a.expand((n_fit,) + a.shape) for a in grid))  # (T, R, ...)
    if adam_polish and config.grid_warm_start and warm_start is not None:
        warm = GPParams(*(a.reshape((n_fit,) + a.shape[len(lead):]) for a in warm_start))
        defaults = GPParams(*(a.expand((n_fit,) + a.shape) for a in default_params(dim, config, dtype, device)))
        warm = _where_rows(_finite_rows(warm), warm, defaults)
        inits = GPParams(*(torch.cat([g, w.unsqueeze(1)], dim=1) for g, w in zip(inits, warm)))
    n_rows = inits.raw_noise.shape[1]
    flat = GPParams(*(a.reshape((n_fit * n_rows,) + a.shape[2:]) for a in inits))
    x_r = x_t.repeat_interleave(n_rows, dim=0)
    y_r = y_std_t.repeat_interleave(n_rows, dim=0)
    mask_r = mask_t.repeat_interleave(n_rows, dim=0)

    lane_bytes = 3 * n_cap * n_cap * y_buf.element_size()
    if n_fit * n_rows * lane_bytes > _GRID_VMAP_BUDGET_BYTES:
        mlls = torch.stack([mll(_row(flat, i), x_r[i], y_r[i], mask_r[i], config) for i in range(n_fit * n_rows)])
    else:
        mlls = mll(flat, x_r, y_r, mask_r, config)
    mlls = mlls.reshape(n_fit, n_rows)
    mlls = torch.where(torch.isfinite(mlls), mlls, torch.full_like(mlls, -torch.inf))
    best = torch.argmax(mlls, dim=-1)
    lanes = torch.arange(n_fit, device=device)
    raw_best = GPParams(*(a[lanes, best] for a in inits))
    if adam_polish:
        steps = config.fit_maxiter_warm or 10
        cfg_a = dataclasses.replace(config, fit_optimizer="adam", fit_maxiter=steps)
        raw_pol, loss_pol = _fit_one(raw_best, x_t, y_std_t, mask_t, cfg_a)
        n_act = torch.clamp_min(mask_t.sum(dim=-1).to(dtype), 1.0)
        better = torch.isfinite(loss_pol) & (loss_pol < -mlls[lanes, best] / n_act)
        raw_best = _where_rows(better, raw_pol, raw_best)
    raw_best = GPParams(*(a.reshape(lead + a.shape[1:]) for a in raw_best))
    return make_gp_state(x_buf, y_buf, mask, raw_best, config)


def fit_gp(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig,
    warm_start: Optional[GPParams] = None,
) -> GPState:
    """Fit the hypers and cache the posterior factorization. The
    ``"grid"`` and ``"grid+adam"`` trainers are ported; ``warm_start`` is
    the grid+adam warm row (the grid alone ignores it, as in JAX). Leading
    axes on the buffers are independent fits (see ``_fit_gp_grid``)."""
    if config.fit_optimizer in ("grid", "grid+adam"):
        return _fit_gp_grid(
            x_buf, y_buf, mask, config,
            adam_polish=config.fit_optimizer == "grid+adam", warm_start=warm_start,
        )
    raise NotImplementedError(
        f"fit_optimizer={config.fit_optimizer!r} is not ported yet; only 'grid' and 'grid+adam' are"
    )


def make_gp_state(x_buf: Tensor, y_buf: Tensor, mask: Tensor, raw: GPParams, config: GPConfig) -> GPState:
    """Factorize once for the given hypers (with the jitter ladder, per
    matrix) and cache (chol, alpha). Leading axes on the buffers and on
    ``raw`` give a stacked state; ``state_lane`` takes one out."""
    params = constrain_params(raw, config)
    y_std_buf, y_mean, y_sd = T.standardize(T.warp_y(y_buf, config.y_warp), mask)
    chol = _masked_kernel_chol(params, x_buf, mask, config, ladder=True)
    resid = torch.where(mask, y_std_buf - params["mean"][..., None], torch.zeros_like(y_std_buf))
    alpha = L.cho_solve(chol, resid)
    return GPState(
        x_buf=x_buf, mask=mask, params=params, raw=raw, chol=chol, alpha=alpha,
        y_mean=y_mean, y_std=y_sd,
    )


def state_lane(state: GPState, i: int) -> GPState:
    """Lane ``i`` of a state stacked on one leading axis."""
    return GPState(
        x_buf=state.x_buf[i], mask=state.mask[i], params={k: v[i] for k, v in state.params.items()},
        raw=GPParams(*(a[i] for a in state.raw)), chol=state.chol[i], alpha=state.alpha[i],
        y_mean=state.y_mean[i], y_std=state.y_std[i],
    )


def _posterior_chunk(state: GPState, xs: Tensor, config: GPConfig, include_noise: bool) -> Tuple[Tensor, Tensor]:
    k_cross = L.mask_cross_matrix(
        _kernel_matrix(state.params, state.x_buf, xs, config, add_noise=False), state.mask
    )
    v = L.solve_lower(state.chol, k_cross)  # (N_max, m)
    mu_s = state.params["mean"] + k_cross.mT @ state.alpha
    var_s = K.kernel_diag(state.params, xs) - (v * v).sum(dim=0)
    var_s = torch.clamp_min(var_s, 1e-12)
    if include_noise:
        var_s = var_s + state.params["noise"]
    return mu_s, var_s


def gp_posterior(
    state: GPState,
    xs: Tensor,
    config: GPConfig,
    include_noise: bool = False,
    chunk_size: Optional[int] = None,
    standardized: bool = False,
) -> Tuple[Tensor, Tensor]:
    """Posterior mean/variance at candidate points: μ* = m + K*ᵀα,
    σ*² = k(x*,x*) − ‖L⁻¹K*‖²_col. Chunked over the candidate axis when
    ``chunk_size`` divides it; with ``chunk_size=None`` a chunk (the largest
    divisor of m ≤ 1024) is picked once the cross matrix exceeds
    ``_POSTERIOR_AUTO_CHUNK_BYTES``. Original-y units unless ``standardized``."""
    m = xs.shape[0]
    if chunk_size is None:
        cross_bytes = state.x_buf.shape[0] * m * xs.element_size()
        if cross_bytes > _POSTERIOR_AUTO_CHUNK_BYTES:
            divs = [c for c in range(2, min(m - 1, 1024) + 1) if m % c == 0]
            if divs:
                chunk_size = divs[-1]
    if chunk_size is not None and m > chunk_size and m % chunk_size == 0:
        parts = [_posterior_chunk(state, c, config, include_noise) for c in xs.split(chunk_size)]
        mu_s = torch.cat([p[0] for p in parts])
        var_s = torch.cat([p[1] for p in parts])
    else:
        mu_s, var_s = _posterior_chunk(state, xs, config, include_noise)
    if standardized:
        return mu_s, var_s
    return T.unstandardize(mu_s, state.y_mean, state.y_std), T.unstandardize_var(var_s, state.y_std)


def posterior_cov(
    state: GPState, xs: Tensor, config: GPConfig, include_noise: bool = False, standardized: bool = False
) -> Tuple[Tensor, Tensor]:
    """Joint posterior (mean, covariance) over a candidate chunk, the input
    to joint Thompson sampling: the covariance k(xs, xs) − vᵀv comes from
    one ``cuda_kernels.ts_cov`` call (jitter 0: the TS ladder adds its own
    bumps). O(m²) memory: chunk upstream."""
    k_cross = L.mask_cross_matrix(
        _kernel_matrix(state.params, state.x_buf, xs, config, add_noise=False), state.mask
    )
    v = L.solve_lower(state.chol, k_cross)
    mu_s = state.params["mean"] + k_cross.mT @ state.alpha
    zs, _ = _scale_center(state.params, xs, xs)
    ts_cov = CK.ts_cov_reference if config.use_kernel is False else CK.ts_cov
    with record_function("gp.ts_cov"):
        cov_s = ts_cov(zs, v, state.params["outputscale"], 0.0, config.kernel)
    if include_noise:
        cov_s = cov_s + state.params["noise"] * torch.eye(xs.shape[0], dtype=cov_s.dtype, device=cov_s.device)
    if standardized:
        return mu_s, cov_s
    return T.unstandardize(mu_s, state.y_mean, state.y_std), cov_s * state.y_std**2
