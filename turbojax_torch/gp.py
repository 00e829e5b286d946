"""GP surrogate: masked MLL, the grid trainer, batched posterior (port of
``turbojax.gp``, main-path part).

All state lives in statically shaped masked buffers (``linalg``). Every
kernel-matrix build goes through ``_kernel_matrix``, which scales by the
lengthscales, centers, and calls ``cuda_kernels.kernel_matrix``: the
hand-written CUDA kernel on CUDA tensors, its plain version on CPU tensors.
The grid trainer's 15 hyperparameter rows are one batch: one kernel launch
and one batched Cholesky for all rows.

Ported: ``GPParams``, ``GPState``, ``constrain_params``, ``default_params``,
``grid_params``, ``mll``, ``make_gp_state``, ``fit_gp`` with
``fit_optimizer="grid"``, ``gp_posterior`` and ``posterior_cov``. The
gradient trainers ("lbfgs", "adam", "grid+adam") and the MAP prior are later
work and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

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


def _kernel_matrix(
    params: Dict[str, Tensor], x1: Tensor, x2: Tensor, config: GPConfig, add_noise: bool
) -> Tensor:
    """k(x1, x2) (+ noise on the diagonal): scale by 1/ℓ, center (the
    expansion's eps·‖z‖² error otherwise swamps clustered trust-region
    candidates), then the kernel wrapper. Batched hypers (a leading axis on
    every param) give a batched (B, n, m) result from one launch. Pass the
    same tensor as x1 and x2 for K(X, X)."""
    ls = params["lengthscale"].unsqueeze(-2)
    same = x2 is x1
    z1 = x1 / ls
    z2 = z1 if same else x2 / ls
    c = 0.5 * (z1.mean(dim=-2, keepdim=True) + z2.mean(dim=-2, keepdim=True))
    z1 = (z1 - c).contiguous()
    z2 = z1 if same else (z2 - c).contiguous()
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
    batch axis on ``raw`` gives one MLL per row; a row whose factorization
    failed scores NaN."""
    params = constrain_params(raw, config)
    chol = _masked_kernel_chol(params, x_buf, mask, config)
    resid = torch.where(mask, y_std - params["mean"][..., None], torch.zeros_like(y_std))
    alpha = L.cho_solve(chol, resid)
    quad = (resid * alpha).sum(dim=-1)
    logdet = L.masked_logdet_from_chol(chol, mask)
    n_act = mask.sum().to(y_std.dtype)
    return -0.5 * (quad + logdet + n_act * _LOG_2PI)


def _row(p: GPParams, i) -> GPParams:
    """Row ``i`` (an int or a 0-dim device tensor) of stacked params. A
    1-element ``index_select``: indexing with a 0-dim tensor reads it back to
    the host."""
    idx = torch.as_tensor(i, device=p.raw_noise.device).reshape(1)
    return GPParams(*(a.index_select(0, idx)[0] for a in p))


def _fit_gp_grid(x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig) -> GPState:
    """Grid MLL selection: score every grid combo as one batch (one kernel
    launch, 15 batched Cholesky factorizations) and keep the argmax; a row
    with a non-finite MLL (failed factorization) scores −inf."""
    if config.fit_prior != "none":
        raise NotImplementedError("fit_prior != 'none' (the MAP prior) is not ported yet")
    dim = x_buf.shape[-1]
    y_std_buf, _, _ = T.standardize(T.warp_y(y_buf, config.y_warp), mask)
    inits = grid_params(dim, config, y_buf.dtype, y_buf.device)
    n_rows = inits.raw_noise.shape[0]
    n_cap = x_buf.shape[0]
    lane_bytes = 3 * n_cap * n_cap * y_buf.element_size()
    if n_rows * lane_bytes > _GRID_VMAP_BUDGET_BYTES:
        mlls = torch.stack([mll(_row(inits, i), x_buf, y_std_buf, mask, config) for i in range(n_rows)])
    else:
        mlls = mll(inits, x_buf, y_std_buf, mask, config)
    mlls = torch.where(torch.isfinite(mlls), mlls, torch.full_like(mlls, -torch.inf))
    return make_gp_state(x_buf, y_buf, mask, _row(inits, torch.argmax(mlls)), config)


def fit_gp(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig,
    warm_start: Optional[GPParams] = None,
) -> GPState:
    """Fit the hypers and cache the posterior factorization. Only the
    deterministic ``"grid"`` trainer is ported (``warm_start`` is what the
    gradient trainers will start from; the grid ignores it, as in JAX)."""
    if config.fit_optimizer == "grid":
        return _fit_gp_grid(x_buf, y_buf, mask, config)
    raise NotImplementedError(
        f"fit_optimizer={config.fit_optimizer!r} is not ported yet; only 'grid' is"
    )


def make_gp_state(x_buf: Tensor, y_buf: Tensor, mask: Tensor, raw: GPParams, config: GPConfig) -> GPState:
    """Factorize once for the given hypers (with the jitter ladder) and cache
    (chol, alpha)."""
    params = constrain_params(raw, config)
    y_std_buf, y_mean, y_sd = T.standardize(T.warp_y(y_buf, config.y_warp), mask)
    chol = _masked_kernel_chol(params, x_buf, mask, config, ladder=True)
    resid = torch.where(mask, y_std_buf - params["mean"], torch.zeros_like(y_std_buf))
    alpha = L.cho_solve(chol, resid)
    return GPState(
        x_buf=x_buf, mask=mask, params=params, raw=raw, chol=chol, alpha=alpha,
        y_mean=y_mean, y_std=y_sd,
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
    to joint Thompson sampling. O(m²) memory: chunk upstream."""
    k_cross = L.mask_cross_matrix(
        _kernel_matrix(state.params, state.x_buf, xs, config, add_noise=False), state.mask
    )
    v = L.solve_lower(state.chol, k_cross)
    mu_s = state.params["mean"] + k_cross.mT @ state.alpha
    cov_s = _kernel_matrix(state.params, xs, xs, config, add_noise=False) - v.mT @ v
    if include_noise:
        cov_s = cov_s + state.params["noise"] * torch.eye(xs.shape[0], dtype=cov_s.dtype, device=cov_s.device)
    if standardized:
        return mu_s, cov_s
    return T.unstandardize(mu_s, state.y_mean, state.y_std), cov_s * state.y_std**2
