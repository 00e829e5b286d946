"""GP surrogate: masked MLL, the grid, grid+Adam, Adam and L-BFGS restart
trainers, batched posterior (port of ``turbojax.gp``).

All state lives in statically shaped masked buffers (``linalg``). Inputs
are scaled by 1/ℓ and centered by ``_scale_center``; every kernel-matrix
build then goes through ``cuda_kernels.kernel_matrix`` and every
Thompson-chunk covariance through ``cuda_kernels.ts_cov``: the hand-written
CUDA kernels on CUDA tensors, their plain versions on CPU tensors.

The trainers take a leading batch axis on the buffers (one row per trust
region, in place of the JAX package's ``vmap``), and the grid rows or the
restarts of every region are one more batch axis, flattened with it: one
kernel launch and one batched Cholesky per loss evaluation, the backward
through ``cuda_kernels.KernelMatrix``. The lanes' losses are summed, so
each lane gets its own exact gradient, and no lane reads another.

Where JAX's ``fit_gp`` takes a key, the port takes a ``torch.Generator``
for the restart inits, or the uniforms themselves (``restart_uniforms``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from turbojax_torch import cuda_kernels as CK
from turbojax_torch import kernels as K
from turbojax_torch import linalg as L
from turbojax_torch import transforms as T
from turbojax_torch.config import GPConfig
from turbojax_torch.runlog import span

Tensor = torch.Tensor

_LOG_2PI = 1.8378770664093453

# Above this many bytes of batched grid-fit work (~3·N²·itemsize per row)
# the rows are scored one after another. Measured on an NVIDIA H100 80GB HBM3
# at 700 W (``python3 -m turbojax_torch.bench_large_n --rules``: 15 rows,
# d = 10, float32): one batch is faster up to N = 2048 (6.1 against 17.0 ms
# at 1024, 15.7 against 27.5 at 2048), ties at 4096 (54.5 against 55.8 ms),
# and is slower at 8192 (264 against 209 ms, and 19.0 GiB of peak memory
# against 1.5); at 16384 it runs out of the 80 GB. 4 GiB batches 15 rows up
# to N = 4096 and config 5's 80 rows at its 2048 rung (3.75 GiB), not 8192.
_GRID_VMAP_BUDGET_BYTES = 4 << 30
# gp_posterior auto-chunks the candidate axis when the (N_max, m) cross
# matrix exceeds this size. Measured on the same card (``bench_large_n
# --rules``, N = 16384 unless said): the unchunked posterior is faster than
# chunks of 1000 at every size timed, 12.3 against 19.8 ms at N = 8192 over
# 5000 candidates, and 37.6 / 108 / 160 / 263 against 53.2 / 168 / 252 /
# 419 ms over 5000 / 16000 / 24000 / 40000 (crosses of 0.31 / 0.98 / 1.46 /
# 2.44 GiB), but it holds ~3× the cross matrix on top of the state (peak
# 1.95 / 3.96 / 5.43 / 8.36 GiB against 1.22 chunked). So chunking is a
# memory cap, not a speed rule: from 1 GiB of cross matrix, where the
# unchunked posterior would need ~3 GiB more.
_POSTERIOR_AUTO_CHUNK_BYTES = 1 << 30


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


def sample_restart_params(
    dim: int, config: GPConfig, n: int, generator: Optional[torch.Generator] = None,
    dtype=torch.float32, device=None, uniforms: Optional[Tensor] = None,
) -> GPParams:
    """``n`` log-uniform restart inits over the interior of the constraint
    boxes, stacked on a leading axis. ``uniforms`` ((n, d_eff + 2) values in
    [0, 1): the lengthscales' columns, then the outputscale's and the
    noise's) replaces the random draw."""
    d_eff = dim if config.use_ard else 1
    if uniforms is None:
        uniforms = torch.rand((n, d_eff + 2), generator=generator, dtype=dtype, device=device)
    elif uniforms.shape != (n, d_eff + 2):
        raise ValueError(f"uniforms must have shape {(n, d_eff + 2)}, got {tuple(uniforms.shape)}")
    uniforms = uniforms.to(dtype=dtype, device=device)

    def logu(u, lo, hi):
        # stay inside [10%, 90%] of the log-box so that unconstrain is stable
        llo, lhi = math.log(lo * 1.5), math.log(hi / 1.5)
        return torch.exp(torch.clamp_min(u * (lhi - llo) + llo, llo))

    lo, hi = config.lengthscale_bounds
    so, sh = config.outputscale_bounds
    no, nh = config.noise_bounds
    return GPParams(
        raw_lengthscale=T.unconstrain(logu(uniforms[:, :d_eff], max(lo, 0.05), min(hi, 2.0)), lo, hi),
        raw_outputscale=T.unconstrain(logu(uniforms[:, d_eff], max(so, 0.2), min(sh, 5.0)), so, sh),
        raw_noise=T.unconstrain(logu(uniforms[:, d_eff + 1], max(no, 1e-4), min(nh, 1e-1)), no, nh),
        raw_mean=torch.zeros((n,), dtype=dtype, device=device),
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


def _masked_kernel_matrix(params: Dict[str, Tensor], x_buf: Tensor, mask: Tensor, config: GPConfig) -> Tensor:
    return L.mask_kernel_matrix(_kernel_matrix(params, x_buf, x_buf, config, add_noise=True), mask)


def _masked_kernel_chol(
    params: Dict[str, Tensor], x_buf: Tensor, mask: Tensor, config: GPConfig, ladder: bool = False
) -> Tensor:
    k_mat = _masked_kernel_matrix(params, x_buf, mask, config)
    if ladder:
        # escalating-jitter rescue for the cached factorization: near-duplicate
        # rows at fitted hypers can defeat the fixed jitter in f32
        return L.safe_cholesky(k_mat, (config.jitter, 1e2 * config.jitter, 1e4 * config.jitter))
    return L.cholesky_jittered(k_mat, config.jitter)


class _QuadLogdet(torch.autograd.Function):
    """(rᵀA⁻¹r, log|A_active|) of the bumped, masked kernel matrix A and the
    zero-padded residual r, the forward through the Cholesky as
    ``cholesky_jittered``, ``cho_solve`` and ``masked_logdet_from_chol``
    compute it, the backward in closed form from the saved factor:

        ḡA = g_ld · P A⁻¹ P − g_q · ααᵀ,   ḡr = 2 g_q α,   α = A⁻¹r,

    with P the mask's projection (A is block-diagonal between the active and
    the padded entries, and the padded block adds nothing to the masked
    log-determinant). A⁻¹ is ``linalg.chol_inverse``'s, 2N³/3 flops where
    reverse mode through the Cholesky takes 4N³; ḡA is written into its
    buffer. A lane whose factorization failed (a NaN factor) gets a NaN ḡA.
    Leading batch axes on A are independent lanes."""

    @staticmethod
    def forward(ctx, a_mat: Tensor, resid: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
        chol = L.cholesky_nan(a_mat)[0]
        alpha = L.cho_solve(chol, resid)
        ctx.save_for_backward(chol, alpha, mask)
        return (resid * alpha).sum(dim=-1), L.masked_logdet_from_chol(chol, mask)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_quad: Tensor, g_logdet: Tensor):
        chol, alpha, mask = ctx.saved_tensors
        with span("gp.mll_vjp"):
            # elementwise after the inverse, so that a lane's ḡA is the same
            # bits in any batch
            g_a = L.chol_inverse(chol).mul_(g_logdet[..., None, None])
            g_a.masked_fill_(~mask[..., :, None], 0.0).masked_fill_(~mask[..., None, :], 0.0)
            g_a.addcmul_((g_quad[..., None] * alpha)[..., :, None], alpha[..., None, :], value=-1.0)
            g_r = 2.0 * g_quad[..., None] * alpha if ctx.needs_input_grad[1] else None
        return g_a, g_r, None


def mll(raw: GPParams, x_buf: Tensor, y_std: Tensor, mask: Tensor, config: GPConfig) -> Tensor:
    """Exact marginal log-likelihood over the active block:
    −½ rᵀα − ½ log|K+σ²I| − (n/2) log 2π, with r = y_std − m. A leading
    batch axis on ``raw`` gives one MLL per row (the buffers either shared,
    or batched alike: x (B, N, d), y_std and mask (B, N)); a row whose
    factorization failed scores NaN. Its gradient is ``_QuadLogdet``'s
    closed form, then autograd through the jitter, the mask and the kernel
    matrix."""
    params = constrain_params(raw, config)
    a_mat = L._bumped(_masked_kernel_matrix(params, x_buf, mask, config), config.jitter)
    resid = torch.where(mask, y_std - params["mean"][..., None], torch.zeros_like(y_std))
    quad, logdet = _QuadLogdet.apply(a_mat, resid, mask)
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


def log_prior(raw: GPParams, dim: int, config: GPConfig) -> Tensor:
    """Fit-time MAP log-prior over the constrained hypers, up to constants
    (added to the MLL with no reparameterization Jacobian, so the argmax is
    the MAP in the constrained space). ``fit_prior="dimscaled"``:
    ℓᵢ ~ LogNormal(√2 + ln(d)/2, √3) and σ² ~ LogNormal(−4, 1); the
    outputscale stays prior-free. Only the fit objective sees this. A
    leading batch axis on ``raw`` gives one value per row."""
    if config.fit_prior == "none":
        return torch.zeros_like(raw.raw_outputscale)
    if config.fit_prior != "dimscaled":
        raise ValueError(f"unknown fit_prior {config.fit_prior!r}; expected 'none' or 'dimscaled'")
    p = constrain_params(raw, config)

    def ln_logpdf(x, mu, sigma):
        lx = torch.log(x)
        return -lx - 0.5 * ((lx - mu) / sigma) ** 2

    mu_ls = math.sqrt(2.0) + 0.5 * math.log(float(dim))
    return ln_logpdf(p["lengthscale"], mu_ls, math.sqrt(3.0)).sum(dim=-1) + ln_logpdf(p["noise"], -4.0, 1.0)


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _fit_one(
    raw0: GPParams, x_buf: Tensor, y_std: Tensor, mask: Tensor, config: GPConfig,
    stats: Optional[Dict[str, object]] = None,
) -> Tuple[GPParams, Tensor]:
    """One optimizer run from ``raw0``; returns (params, final −mll/n, with
    the MAP prior when ``fit_prior`` is on). A leading axis on ``raw0`` is a
    batch of independent lanes (with x (L, N, d), y_std and mask (L, N), or
    buffers shared by all): their losses are summed, so each lane gets its
    own exact gradient. ``fit_optimizer="adam"`` runs ``_fit_adam``,
    ``"lbfgs"`` ``_fit_lbfgs``. ``stats``, when given, receives
    ``loss_evals`` (batched loss evaluations with a gradient, each one
    kernel-matrix launch, one batched Cholesky and its closed-form backward) and
    ``steps`` (the optimizer steps each lane took)."""
    n_act = torch.clamp_min(mask.sum(dim=-1).to(y_std.dtype), 1.0)
    dim = x_buf.shape[-1]

    def loss(raw: GPParams) -> Tensor:
        with span("gp.loss"):
            val = mll(raw, x_buf, y_std, mask, config)
            if config.fit_prior != "none":
                val = val + log_prior(raw, dim, config)  # the MAP objective
            return -val / n_act

    raw0 = GPParams(*(a.detach() for a in raw0))
    if config.fit_optimizer == "adam":
        raw, steps, evals = _fit_adam(raw0, loss, config)
        with torch.no_grad():
            final = loss(raw)
    elif config.fit_optimizer == "lbfgs":
        raw, final, steps, evals = _fit_lbfgs(raw0, loss, config)
    else:
        raise ValueError(f"_fit_one runs fit_optimizer 'adam' or 'lbfgs', not {config.fit_optimizer!r}")
    if stats is not None:
        stats["loss_evals"] = stats.get("loss_evals", 0) + evals
        stats["steps"] = steps
    return raw, final


def _fit_adam(raw: GPParams, loss, config: GPConfig) -> Tuple[GPParams, Tensor, int]:
    """Adam from ``raw``: ``optax.adam(fit_lr)`` written out (b1 0.9, b2
    0.999, eps 1e-8 after the square root, bias-corrected) with the JAX
    package's NaN-robust step, per lane: a non-finite gradient element is
    zeroed, the update is applied (the moments still decay), and the
    previous iterate is kept only where the new one is non-finite. A failed
    factorization gives its lane NaN gradients, as in JAX, and they end as
    zero.

    ``fit_ftol == 0``: ``fit_maxiter`` steps. ``fit_ftol > 0``: a lane stops
    once its per-step improvement of the loss, |Δ(−mll/n)| read before each
    update, falls below ``fit_ftol``, after a warm-up of ``fit_maxiter // 4``
    steps; a non-finite improvement keeps it going. A stopped lane is frozen
    (iterate and moments) while the others go on; the loop ends when every
    lane has stopped (one read of the lanes' flags per step).
    Returns (params, steps per lane, loss evaluations)."""
    lead = raw.raw_noise.shape
    device, dtype = raw.raw_noise.device, raw.raw_noise.dtype
    mu = [torch.zeros_like(a) for a in raw]
    nu = [torch.zeros_like(a) for a in raw]
    early = config.fit_ftol > 0.0
    warmup = max(1, config.fit_maxiter // 4)
    active = torch.ones(lead, dtype=torch.bool, device=device)
    prev = torch.full(lead, torch.inf, dtype=dtype, device=device)
    improv = prev.clone()
    steps = torch.zeros(lead, dtype=torch.int64, device=device)
    evals = 0

    def where_active(new, old):
        return [torch.where(active.reshape(lead + (1,) * (n.dim() - len(lead))), n, o) for n, o in zip(new, old)]

    for step in range(1, config.fit_maxiter + 1):
        if early:
            if step > warmup:
                active = active & ((improv >= config.fit_ftol) | ~torch.isfinite(improv))
            with span("sync.gp.adam_active"):
                stopped = not bool(active.any())
            if stopped:
                break
        leaves = [a.clone().requires_grad_(True) for a in raw]
        values = loss(GPParams(*leaves))
        evals += 1
        with span("gp.polish_backward"):
            grads = torch.autograd.grad(values.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                 for a, g in zip(raw, grads)]
        mu_new = [(1 - _ADAM_B1) * g + _ADAM_B1 * m for g, m in zip(grads, mu)]
        nu_new = [(1 - _ADAM_B2) * g**2 + _ADAM_B2 * v for g, v in zip(grads, nu)]
        bc1, bc2 = 1 - _ADAM_B1**step, 1 - _ADAM_B2**step
        new = GPParams(*(
            p + (-config.fit_lr) * ((m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS))
            for p, m, v in zip(raw, mu_new, nu_new)
        ))
        new = _where_rows(_finite_rows(new), new, raw)
        if early:
            values = values.detach()
            improv = torch.where(active, torch.abs(prev - values), improv)
            prev = torch.where(active, values, prev)
            new, mu_new, nu_new = GPParams(*where_active(new, raw)), where_active(mu_new, mu), where_active(nu_new, nu)
        raw, mu, nu = new, mu_new, nu_new
        steps = steps + active
    return raw, steps, evals


_LBFGS_MEMORY = 10  # optax.lbfgs's default
_LBFGS_C1, _LBFGS_C2 = 1e-4, 0.9  # optax's zoom search: slope_rtol and curv_rtol
_LBFGS_GTOL = 1e-6  # a lane stops at ‖∇‖ ≤ this
_LBFGS_RESOLUTION = 10.0  # ... or when a step lowers its loss by less than this many eps of the dtype (relative)


def _flatten(raw: GPParams) -> Tensor:
    """(L, P) raw vectors of (L,)-stacked params, P = d_eff + 3."""
    return torch.cat([raw.raw_lengthscale, raw.raw_outputscale[:, None], raw.raw_noise[:, None],
                      raw.raw_mean[:, None]], dim=-1)


def _unflatten(vec: Tensor) -> GPParams:
    return GPParams(raw_lengthscale=vec[:, :-3], raw_outputscale=vec[:, -3], raw_noise=vec[:, -2],
                    raw_mean=vec[:, -1])


def _fit_lbfgs(raw0: GPParams, loss, config: GPConfig) -> Tuple[GPParams, Tensor, Tensor, int]:
    """L-BFGS over a batch of independent lanes (the restarts, times the
    trust regions): the two-loop recursion on the flattened raw vectors with
    a leading lane axis (memory 10, the initial Hessian scaled by sᵀy/yᵀy of
    the newest pair), and a strong-Wolfe line search by bisection (c1 1e-4,
    c2 0.9: expand while the slope stays negative, bisect once bracketed),
    capped at ``fit_linesearch_steps`` probes; each probe is one batched
    loss evaluation with its gradient, every lane at its own step length.
    A lane stops at ‖∇‖ ≤ 1e-6, at ``fit_maxiter`` iterations, when a
    search from the steepest-descent direction finds no decrease, or when an
    accepted step lowers the loss by less than 10 eps of the dtype, relative
    to max(|loss|, 1): below that the loss does not resolve a descent any
    more, and in float32 every further search would run to its cap (measured
    on config 2: ~10 probes an iteration once converged). Per lane: stop
    masks, curvature pairs, step lengths; no lane reads another.

    A failed factorization inside a probe makes that lane's loss +inf (its
    gradient zero): the probe fails the decrease test and the search
    shortens the step. When the cap ends a search the lowest probe that met
    the decrease test is taken; a pair with sᵀy ≤ 1e-10·yᵀy is dropped; a
    search without any decrease clears the lane's memory.

    This is not ``optax.lbfgs``'s zoom search step for step: the result is
    held against it (final loss, hyper recovery), not the trajectory. The
    host reads the lanes' flags once per probe to end a search or the fit
    early. Returns (params, final loss (+inf where it never was finite),
    iterations per lane, loss evaluations)."""
    single = raw0.raw_noise.dim() == 0
    if single:
        raw0 = GPParams(*(a[None] for a in raw0))
    x = _flatten(raw0)
    lanes, n_par = x.shape
    device, dtype = x.device, x.dtype
    evals = 0

    def value_and_grad(vec: Tensor) -> Tuple[Tensor, Tensor]:
        nonlocal evals
        evals += 1
        v = vec.detach().clone().requires_grad_(True)
        raw = _unflatten(v)
        values = loss(GPParams(*(a[0] for a in raw)) if single else raw).reshape(lanes)
        with span("gp.polish_backward"):
            (g,) = torch.autograd.grad(values.sum(), v)
        values = values.detach()
        return (torch.where(torch.isfinite(values), values, torch.full_like(values, torch.inf)),
                torch.where(torch.isfinite(g), g, torch.zeros_like(g)))

    def dot(a: Tensor, b: Tensor) -> Tensor:
        return (a * b).sum(dim=-1)

    f, g = value_and_grad(x)
    s_mem = torch.zeros((_LBFGS_MEMORY, lanes, n_par), dtype=dtype, device=device)
    y_mem = torch.zeros_like(s_mem)
    rho = torch.zeros((_LBFGS_MEMORY, lanes), dtype=dtype, device=device)  # 0 marks an empty slot
    gamma = torch.ones(lanes, dtype=dtype, device=device)
    done = ~torch.isfinite(f) | (torch.linalg.vector_norm(g, dim=-1) <= _LBFGS_GTOL)
    iters = torch.zeros(lanes, dtype=torch.int64, device=device)
    inf = torch.full((lanes,), torch.inf, dtype=dtype, device=device)
    tiny = _LBFGS_RESOLUTION * torch.finfo(dtype).eps

    for _ in range(config.fit_maxiter):
        with span("sync.gp.lbfgs_done"):
            all_done = bool(done.all())
        if all_done:
            break
        # the two-loop recursion, newest pair first (slot 0)
        q = g.clone()
        alphas = []
        for k in range(_LBFGS_MEMORY):
            a = rho[k] * dot(s_mem[k], q)
            q = q - a[:, None] * y_mem[k]
            alphas.append(a)
        r = gamma[:, None] * q
        for k in reversed(range(_LBFGS_MEMORY)):
            b = rho[k] * dot(y_mem[k], r)
            r = r + (alphas[k] - b)[:, None] * s_mem[k]
        has_mem = (rho > 0).any(dim=0)
        d = -r
        slope = dot(g, d)
        descent = has_mem & (slope < 0)
        d = torch.where(descent[:, None], d, -g)
        slope = torch.where(descent, slope, -dot(g, g))
        # the first step from steepest descent is at most one gradient length
        t = torch.where(descent, torch.ones_like(f),
                        torch.clamp_max(1.0 / torch.linalg.vector_norm(g, dim=-1).clamp_min(1e-30), 1.0))

        searching = ~done
        lo, hi = torch.zeros_like(t), inf.clone()
        best_f, best_x, best_g = inf.clone(), x, g
        for _ in range(config.fit_linesearch_steps):
            x_try = x + t[:, None] * d
            f_t, g_t = value_and_grad(x_try)
            slope_t = dot(g_t, d)
            armijo = f_t <= f + _LBFGS_C1 * t * slope
            better = searching & armijo & (f_t < best_f)
            best_f = torch.where(better, f_t, best_f)
            best_x = torch.where(better[:, None], x_try, best_x)
            best_g = torch.where(better[:, None], g_t, best_g)
            searching = searching & ~(armijo & (slope_t.abs() <= _LBFGS_C2 * slope.abs()))
            too_long = ~armijo | (slope_t > 0)
            hi = torch.where(searching & too_long, t, hi)
            lo = torch.where(searching & ~too_long, t, lo)
            t = torch.where(searching, torch.where(torch.isinf(hi), 2.0 * t, 0.5 * (lo + hi)), t)
            with span("sync.gp.lbfgs_search"):
                ended = not bool(searching.any())
            if ended:
                break

        moved = ~done & torch.isfinite(best_f)
        s_new, y_new = best_x - x, best_g - g
        sy, yy = dot(s_new, y_new), dot(y_new, y_new)
        keep = moved & (sy > 1e-10 * yy) & (yy > 0)
        safe_sy = torch.where(keep, sy, torch.ones_like(sy))
        s_mem = torch.cat([torch.where(keep[:, None], s_new, torch.zeros_like(s_new))[None], s_mem[:-1]])
        y_mem = torch.cat([torch.where(keep[:, None], y_new, torch.zeros_like(y_new))[None], y_mem[:-1]])
        rho = torch.cat([torch.where(keep, 1.0 / safe_sy, torch.zeros_like(sy))[None], rho[:-1]])
        gamma = torch.where(keep, sy / torch.where(keep, yy, torch.ones_like(yy)), gamma)
        # no decrease anywhere along the direction: forget the curvature and
        # try steepest descent next, or stop if this was steepest descent
        stuck = ~done & ~moved
        rho = torch.where(stuck[None, :], torch.zeros_like(rho), rho)
        gamma = torch.where(stuck, torch.ones_like(gamma), gamma)
        iters = iters + (~done)
        resolved = moved & (f - best_f <= tiny * torch.maximum(f.abs(), best_f.abs()).clamp_min(1.0))
        x = torch.where(moved[:, None], best_x, x)
        f = torch.where(moved, best_f, f)
        g = torch.where(moved[:, None], best_g, g)
        done = done | (stuck & ~descent) | resolved | (torch.linalg.vector_norm(g, dim=-1) <= _LBFGS_GTOL)

    raw = _unflatten(x)
    if single:
        return GPParams(*(a[0] for a in raw)), f[0], iters[0], evals
    return raw, f, iters, evals


def _repeat_lanes(n_rows: int, *buffers: Tensor):
    """Each fit's buffers repeated for its ``n_rows`` lanes (fit-major)."""
    return tuple(b.repeat_interleave(n_rows, dim=0) for b in buffers)


def grid_rows_batched(n_rows: int, n_cap: int, itemsize: int) -> bool:
    """Whether the grid fit scores its ``n_rows`` rows as one batch (one
    kernel launch, one batched Cholesky) rather than one after another: while
    their work, ~3·N²·itemsize bytes a row, fits ``_GRID_VMAP_BUDGET_BYTES``.
    Both branches return the same hypers."""
    return n_rows * 3 * n_cap * n_cap * itemsize <= _GRID_VMAP_BUDGET_BYTES


def _fit_gp_grid(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig, adam_polish: bool = False,
    warm_start: Optional[GPParams] = None, stats: Optional[Dict[str, object]] = None,
) -> GPState:
    """Grid MLL selection: score every grid combo as one batch (one kernel
    launch, one batched Cholesky) and keep the argmax; a row with a
    non-finite MLL (failed factorization) scores −inf. With ``fit_prior``
    the rows, the argmax and the polish comparison all rank by the MAP
    objective, as ``_fit_one``'s loss does.

    ``adam_polish`` (``fit_optimizer="grid+adam"``): the warm start (the
    previous refit's hypers, sanitized to the defaults when non-finite)
    joins the grid as one more row when ``grid_warm_start``; the argmax is
    refined by ``fit_maxiter_warm or 10`` Adam steps, and the polish is kept
    only when its loss beats the grid's. ``grid_polish_both`` (with a warm
    row): the warm row and the best grid-only row are both polished, as two
    lanes, and the better polish competes with the argmax.

    Leading axes on the buffers (x (T, N, d), y and mask (T, N), and on
    ``warm_start``) are independent fits, one per trust region: all their
    rows are scored in one batch and polished as one batch of lanes."""
    n_cap, dim = x_buf.shape[-2:]
    lead = x_buf.shape[:-2]
    n_fit = int(torch.Size(lead).numel())
    dtype, device = y_buf.dtype, y_buf.device
    x_t = x_buf.reshape(n_fit, n_cap, dim)
    mask_t = mask.expand(lead + (n_cap,)).reshape(n_fit, n_cap)
    y_std_t, _, _ = T.standardize(T.warp_y(y_buf.reshape(n_fit, n_cap), config.y_warp), mask_t)

    grid = grid_params(dim, config, dtype, device)
    inits = GPParams(*(a.expand((n_fit,) + a.shape) for a in grid))  # (T, R, ...)
    has_warm = adam_polish and config.grid_warm_start and warm_start is not None
    if has_warm:
        warm = GPParams(*(a.reshape((n_fit,) + a.shape[len(lead):]) for a in warm_start))
        defaults = GPParams(*(a.expand((n_fit,) + a.shape) for a in default_params(dim, config, dtype, device)))
        warm = _where_rows(_finite_rows(warm), warm, defaults)
        inits = GPParams(*(torch.cat([g, w.unsqueeze(1)], dim=1) for g, w in zip(inits, warm)))
    n_rows = inits.raw_noise.shape[1]
    flat = GPParams(*(a.reshape((n_fit * n_rows,) + a.shape[2:]) for a in inits))
    x_r, y_r, mask_r = _repeat_lanes(n_rows, x_t, y_std_t, mask_t)

    def score(r: GPParams, x: Tensor, y: Tensor, m: Tensor) -> Tensor:
        val = mll(r, x, y, m, config)
        return val + log_prior(r, dim, config) if config.fit_prior != "none" else val

    if grid_rows_batched(n_fit * n_rows, n_cap, y_buf.element_size()):
        mlls = score(flat, x_r, y_r, mask_r)
    else:
        mlls = torch.stack([score(_row(flat, i), x_r[i], y_r[i], mask_r[i]) for i in range(n_fit * n_rows)])
    mlls = mlls.reshape(n_fit, n_rows)
    mlls = torch.where(torch.isfinite(mlls), mlls, torch.full_like(mlls, -torch.inf))
    best = torch.argmax(mlls, dim=-1)
    lanes = torch.arange(n_fit, device=device)
    raw_best = GPParams(*(a[lanes, best] for a in inits))
    if adam_polish:
        steps = config.fit_maxiter_warm or 10
        cfg_a = dataclasses.replace(config, fit_optimizer="adam", fit_maxiter=steps)
        if config.grid_polish_both and has_warm:
            grid_best = torch.argmax(mlls[:, :-1], dim=-1)  # the best grid-only row
            seeds = GPParams(*(torch.stack([a[lanes, grid_best], a[:, -1]], dim=1) for a in inits))  # (T, 2, ...)
            seeds = GPParams(*(a.reshape((2 * n_fit,) + a.shape[2:]) for a in seeds))
            raw_pols, loss_pols = _fit_one(seeds, *_repeat_lanes(2, x_t, y_std_t, mask_t), cfg_a, stats)
            loss_pols = loss_pols.reshape(n_fit, 2)
            loss_pols = torch.where(torch.isfinite(loss_pols), loss_pols, torch.full_like(loss_pols, torch.inf))
            pbest = torch.argmin(loss_pols, dim=-1)
            raw_pol = GPParams(*(a.reshape((n_fit, 2) + a.shape[1:])[lanes, pbest] for a in raw_pols))
            loss_pol = loss_pols[lanes, pbest]
        else:
            raw_pol, loss_pol = _fit_one(raw_best, x_t, y_std_t, mask_t, cfg_a, stats)
        n_act = torch.clamp_min(mask_t.sum(dim=-1).to(dtype), 1.0)
        better = torch.isfinite(loss_pol) & (loss_pol < -mlls[lanes, best] / n_act)
        raw_best = _where_rows(better, raw_pol, raw_best)
    raw_best = GPParams(*(a.reshape(lead + a.shape[1:]) for a in raw_best))
    return make_gp_state(x_buf, y_buf, mask, raw_best, config)


def fit_gp(
    x_buf: Tensor, y_buf: Tensor, mask: Tensor, config: GPConfig,
    warm_start: Optional[GPParams] = None, generator: Optional[torch.Generator] = None,
    restart_uniforms: Optional[Tensor] = None, stats: Optional[Dict[str, object]] = None,
) -> GPState:
    """Fit the hypers and cache the posterior factorization.

    ``"grid"`` and ``"grid+adam"``: see ``_fit_gp_grid`` (``warm_start`` is
    the grid+adam warm row; the grid alone ignores it). ``"lbfgs"`` and
    ``"adam"``: standardize y, run ``fit_restarts`` optimizer restarts as one
    batch of lanes and keep the best. Restart 0 is the warm start (the
    previous refit's hypers) when given, else the defaults, sanitized to the
    defaults when non-finite; the others are log-uniform inits from
    ``generator``, or from ``restart_uniforms`` ((fit_restarts − 1, d_eff +
    2), or with the buffers' leading axes in front). A warm-started fit runs
    ``fit_maxiter_warm`` iterations when that is set. A restart whose params
    or loss are non-finite is excluded; when all failed, the (finite) base
    init is kept: ``fit_gp`` never returns non-finite hypers.

    Leading axes on the buffers are independent fits (one per trust region);
    ``stats`` is passed to ``_fit_one``."""
    if config.fit_optimizer in ("grid", "grid+adam"):
        return _fit_gp_grid(
            x_buf, y_buf, mask, config,
            adam_polish=config.fit_optimizer == "grid+adam", warm_start=warm_start, stats=stats,
        )
    if config.fit_optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown fit_optimizer {config.fit_optimizer!r}")
    if warm_start is not None and config.fit_maxiter_warm:
        config = dataclasses.replace(config, fit_maxiter=config.fit_maxiter_warm)
    n_cap, dim = x_buf.shape[-2:]
    lead = x_buf.shape[:-2]
    n_fit = int(torch.Size(lead).numel())
    dtype, device = y_buf.dtype, y_buf.device
    x_t = x_buf.reshape(n_fit, n_cap, dim)
    mask_t = mask.expand(lead + (n_cap,)).reshape(n_fit, n_cap)
    y_std_t, _, _ = T.standardize(T.warp_y(y_buf.reshape(n_fit, n_cap), config.y_warp), mask_t)

    defaults = GPParams(*(a.expand((n_fit,) + a.shape) for a in default_params(dim, config, dtype, device)))
    if warm_start is not None:
        base = GPParams(*(a.reshape((n_fit,) + a.shape[len(lead):]).to(dtype) for a in warm_start))
        base = _where_rows(_finite_rows(base), base, defaults)
    else:
        base = defaults
    inits = GPParams(*(a.unsqueeze(1) for a in base))  # (T, 1, ...)
    n_rand = max(config.fit_restarts - 1, 0)
    if n_rand:
        if restart_uniforms is not None:
            restart_uniforms = restart_uniforms.reshape(n_fit * n_rand, -1)
        rand = sample_restart_params(dim, config, n_fit * n_rand, generator, dtype, device, restart_uniforms)
        inits = GPParams(*(torch.cat([b, r.reshape((n_fit, n_rand) + r.shape[1:])], dim=1) for b, r in zip(inits, rand)))
    n_rows = 1 + n_rand
    flat = GPParams(*(a.reshape((n_fit * n_rows,) + a.shape[2:]) for a in inits))
    fitted, losses = _fit_one(flat, *_repeat_lanes(n_rows, x_t, y_std_t, mask_t), config, stats)
    ok = torch.isfinite(losses) & _finite_rows(fitted)
    losses = torch.where(ok, losses, torch.full_like(losses, torch.inf)).reshape(n_fit, n_rows)
    best = torch.argmin(losses, dim=-1)
    lanes = torch.arange(n_fit, device=device)
    all_failed = ~torch.isfinite(losses[lanes, best])
    picked = GPParams(*(a.reshape((n_fit, n_rows) + a.shape[1:])[lanes, best] for a in fitted))
    raw_best = _where_rows(all_failed, base, picked)
    raw_best = GPParams(*(a.reshape(lead + a.shape[1:]) for a in raw_best))
    return make_gp_state(x_buf, y_buf, mask, raw_best, config)


def make_gp_state(x_buf: Tensor, y_buf: Tensor, mask: Tensor, raw: GPParams, config: GPConfig) -> GPState:
    """Factorize once for the given hypers (with the jitter ladder, per
    matrix) and cache (chol, alpha). Leading axes on the buffers and on
    ``raw`` give a stacked state; ``state_lane`` takes one out."""
    with span("gp.factor"):
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
    with span("gp.ts_cov"):
        cov_s = ts_cov(zs, v, state.params["outputscale"], 0.0, config.kernel)
    if include_noise:
        cov_s = cov_s + state.params["noise"] * torch.eye(xs.shape[0], dtype=cov_s.dtype, device=cov_s.device)
    if standardized:
        return mu_s, cov_s
    return T.unstandardize(mu_s, state.y_mean, state.y_std), cov_s * state.y_std**2
