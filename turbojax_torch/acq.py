"""Acquisition functions: EI, UCB/LCB, chunked joint Thompson sampling and
q-batch selection (port of ``turbojax.acq``, main-path part).

Convention: the framework **minimizes**. EI is improvement below the
incumbent; LCB = μ − κσ is minimized.

Three Thompson samplers, each with its draws injectable (``Draws``):

* ``thompson_samples``: the joint posterior factorized per candidate chunk,
  in the working dtype or (``dtype="float64"``) from a state refactorized in
  float64 (``_state_f64``); on CUDA tensors both kernels then run in their
  double instantiation;
* ``rff_paths``: weight-space paths over random Fourier features
  (``rff_frequencies``), conditioned by Bayesian linear regression;
* ``pathwise_paths``: prior paths over the same features with the exact
  data update through the cached factor (Matheron's rule), the cross
  covariance built by ``gp._kernel_matrix``.

``thompson_values`` dispatches on the loops' ``ts_sampler``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch.config import GPConfig
from turbojax_torch.runlog import span

Tensor = torch.Tensor

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _norm_pdf(z: Tensor) -> Tensor:
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _norm_cdf(z: Tensor) -> Tensor:
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))


def expected_improvement(mu: Tensor, var: Tensor, best: Tensor, xi: float = 0.0) -> Tensor:
    """EI for minimization: (f*−μ−ξ)Φ(z) + σφ(z), z=(f*−μ−ξ)/σ; σ→0 takes
    the exact limit max(f*−μ−ξ, 0)."""
    sigma = torch.sqrt(var)
    imp = best - mu - xi
    tiny = 1e-12
    z = imp / torch.clamp_min(sigma, tiny)
    ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
    return torch.where(sigma > tiny, ei, torch.clamp_min(imp, 0.0))


def lower_confidence_bound(mu: Tensor, var: Tensor, kappa: float = 2.0) -> Tensor:
    """LCB = μ − κσ; minimize it."""
    return mu - kappa * torch.sqrt(var)


def upper_confidence_bound(mu: Tensor, var: Tensor, kappa: float = 2.0) -> Tensor:
    """UCB = μ + κσ for maximization callers."""
    return mu + kappa * torch.sqrt(var)


#: Escalating absolute-floor rungs for the TS-covariance factorization, in
#: units of outputscale·y_std². The f32 assembly of cov = k** − vᵀv is a
#: cancellation whose absolute error stays O(√n·eps·operand) however small
#: the covariance gets at deep trust-region refinement (see
#: ``turbojax.acq._TS_EPS_RUNGS`` for the measurements behind the values).
_TS_EPS_RUNGS = (3e-5, 3e-4, 3e-3)
#: f64: the cancellation floor is ~1e-14·scale, so the first rung sits lower.
_TS_EPS_RUNGS_F64 = (1e-9, 3e-5, 3e-3)


def _robust_cov_chol(cov: Tensor, scale_abs: Tensor) -> Tensor:
    """Cholesky of the TS covariance with an escalating error-floor bump.

    Rung i adds ``1e-6·max(diag) + rungs[i]·scale_abs``; the next rung runs
    only if the factorization failed (``info != 0``, one host sync per rung
    tried). A failure at the last rung returns an all-NaN factor, whose
    draws ``select_q_batch`` never selects."""
    rungs = _TS_EPS_RUNGS_F64 if cov.dtype == torch.float64 else _TS_EPS_RUNGS
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    cmax = torch.clamp_min(cov.diagonal().max(), 1e-12)

    def attempt(rung: float):
        with span("linalg.cholesky_rung"):
            return L.cholesky_nan(cov + (1e-6 * cmax + rung * scale_abs) * eye)

    with span("linalg.cholesky_ladder"):
        for rung in rungs[:-1]:
            l_cov, info = attempt(rung)
            with span("sync.acq.ts_ladder"):
                ok = int(info) == 0
            if ok:
                return l_cov
        return attempt(rungs[-1])[0]


def _residual(state: G.GPState) -> Tensor:
    """The standardized residual r = y_std − m of the active rows, recovered
    from the cached solve as r = L (Lᵀ α) in the state's dtype (zero on the
    padding)."""
    resid = state.chol @ (state.chol.mT @ state.alpha)
    return torch.where(state.mask, resid, torch.zeros_like(resid))


def _state_f64(state: G.GPState, config: GPConfig) -> G.GPState:
    """The posterior cache rebuilt in float64 from a fitted state
    (``ts_dtype="float64"``): buffers and hypers cast, K + σ²I refactorized
    through ``gp._masked_kernel_chol`` (on CUDA tensors the kernel's double
    instantiation), and α re-solved from the residual recovered in the
    working dtype. An f32 residual perturbs only the posterior mean (~1e-7·y);
    the covariance depends on X and the hypers alone and is fully f64."""
    f64 = torch.float64
    x64 = state.x_buf.to(f64)
    raw64 = G.GPParams(*(a.to(f64) for a in state.raw))
    params64 = G.constrain_params(raw64, config)
    chol64 = G._masked_kernel_chol(params64, x64, state.mask, config)
    alpha64 = L.cho_solve(chol64, _residual(state).to(f64))
    return G.GPState(
        x_buf=x64, mask=state.mask, params=params64, raw=raw64, chol=chol64, alpha=alpha64,
        y_mean=state.y_mean.to(f64), y_std=state.y_std.to(f64),
    )


def thompson_samples(
    state: G.GPState,
    xs: Tensor,
    q: int,
    config: GPConfig,
    chunk_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    normals: Optional[Tensor] = None,
    dtype: Optional[str] = None,
) -> Tensor:
    """Draw ``q`` joint posterior sample rows over the candidate set.

    Returns (q, n_cand) draws in original y units, in the dtype of ``xs``.
    The joint covariance is factorized per chunk of the candidate axis
    (exact joint law within a chunk, independent across chunks).
    ``dtype="float64"`` computes the covariance, its factor and the draws in
    float64 from ``_state_f64`` (one f64 refactorization per call): at deep
    trust-region refinement the f32 covariance's error floor exceeds the
    covariance itself. ``normals`` (q, n_cand) replaces the standard-normal
    draws (columns in candidate order); otherwise they come from
    ``generator``, in the sampling dtype."""
    with span("acq.sample"):
        m = xs.shape[0]
        out_dtype = xs.dtype
        if dtype == "float64":
            state = _state_f64(state, config)
            xs = xs.to(torch.float64)
        elif dtype is not None:
            raise ValueError(f"unknown ts_dtype {dtype!r}; expected None or 'float64'")
        scale_abs = (state.params["outputscale"] * state.y_std**2).to(xs.dtype)
        if normals is None:
            normals = torch.randn((q, m), generator=generator, dtype=xs.dtype, device=xs.device)
        elif normals.shape != (q, m):
            raise ValueError(f"normals must have shape {(q, m)}, got {tuple(normals.shape)}")

        def sample_chunk(chunk: Tensor, z: Tensor) -> Tensor:
            mu, cov = G.posterior_cov(state, chunk, config)
            l_cov = _robust_cov_chol(cov, scale_abs)
            return (mu[None, :] + z.to(cov.dtype) @ l_cov.mT).to(out_dtype)

        if chunk_size is not None and m > chunk_size and m % chunk_size == 0:
            return torch.cat(
                [sample_chunk(c, z) for c, z in zip(xs.split(chunk_size), normals.split(chunk_size, dim=1))],
                dim=1,
            )
        return sample_chunk(xs, normals)


def select_q_batch(samples: Tensor, valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """q-batch argmin without replacement: sample row j picks the best
    not-yet-chosen candidate. A non-finite draw (failed covariance factor)
    is never selectable. Returns (indices (q,), values (q,))."""
    q, m = samples.shape
    big = torch.finfo(samples.dtype).max
    taken = torch.zeros(m, dtype=torch.bool, device=samples.device) if valid is None else ~valid
    idxs, vals = [], []
    for row in samples:
        masked = torch.where(taken | ~torch.isfinite(row), torch.full_like(row, big), row)
        idx = torch.argmin(masked)
        taken = taken.index_fill(0, idx[None], True)
        idxs.append(idx)
        vals.append(masked.index_select(0, idx.reshape(1)))  # masked[idx] would sync
    return torch.stack(idxs), torch.cat(vals)


def thompson_select(
    state: G.GPState,
    xs: Tensor,
    q: int,
    config: GPConfig,
    chunk_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    normals: Optional[Tensor] = None,
    dtype: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    """Batched-TS acquisition: draw, then select q points."""
    samples = thompson_samples(state, xs, q, config, chunk_size, generator, normals, dtype)
    idxs, vals = select_q_batch(samples)
    return xs[idxs], vals


# Random-Fourier-feature samplers. f(x) ≈ φ(x)ᵀw with
# φ(x) = sqrt(2 s²/M) cos(Ωx/ℓ + b), Ω drawn from the kernel's spectral
# density: one M × M factorization (rff) or none (pathwise) gives globally
# joint paths over every candidate, with no chunking.

_MATERN_NU = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def rff_frequencies(
    dim: int, n_features: int, kernel: str, generator: Optional[torch.Generator] = None,
    dtype=torch.float32, device=None,
) -> Tuple[Tensor, Tensor]:
    """Spectral frequencies Ω (M, d) for unit lengthscale and phases b (M,)
    ~ U[0, 2π).

    RBF: Ω ~ N(0, I). Matérn-ν: Ω = Z·sqrt(ν/G) row-wise with G ~ Gamma(ν, 1),
    a multivariate t with 2ν degrees of freedom. 2ν ∈ {1, 3, 5}, so
    G = ½ Σ of 2ν squared standard normals is exact: every draw comes from
    ``generator``, with no rejection loop."""
    z = torch.randn((n_features, dim), generator=generator, dtype=dtype, device=device)
    if kernel == "rbf":
        omega = z
    elif kernel in _MATERN_NU:
        nu = _MATERN_NU[kernel]
        chi = torch.randn((n_features, int(2 * nu)), generator=generator, dtype=dtype, device=device)
        g = 0.5 * (chi * chi).sum(dim=-1, keepdim=True)
        omega = z * torch.sqrt(nu / torch.clamp_min(g, 1e-12))
    else:
        raise ValueError(f"no spectral density for kernel {kernel!r}")
    b = 2.0 * math.pi * torch.rand((n_features,), generator=generator, dtype=dtype, device=device)
    return omega, b


def _rff_phi(x: Tensor, omega: Tensor, b: Tensor, lengthscale: Tensor, outputscale: Tensor) -> Tensor:
    """(n, M) feature map; Ωx is one full-fp32 matrix product."""
    m = omega.shape[0]
    proj = (x / lengthscale) @ omega.mT + b[None, :]
    return torch.sqrt(2.0 * outputscale / m) * torch.cos(proj)


class Draws(NamedTuple):
    """Draws of a Thompson sampler that replace the generator's: ``normals``
    (q, n_cand) of ``thompson_samples``; ``omega`` (M, d) and ``b`` (M,) of
    ``rff_frequencies``; ``weights`` (q, M) standard normals (rff: the
    posterior-weight draws z; pathwise: the prior weights w); ``eps``
    (q, N_max) standard normals of the pathwise noise draw (scaled by σ
    inside)."""

    normals: Optional[Tensor] = None
    omega: Optional[Tensor] = None
    b: Optional[Tensor] = None
    weights: Optional[Tensor] = None
    eps: Optional[Tensor] = None


def _features(state: G.GPState, xs: Tensor, n_features: int, config: GPConfig,
              generator: Optional[torch.Generator], draws: Draws) -> Tuple[Tensor, Tensor, Tensor]:
    """(Ω, b, the broadcast lengthscales): injected or drawn."""
    dim = xs.shape[-1]
    omega, b = draws.omega, draws.b
    if omega is None or b is None:
        omega, b = rff_frequencies(dim, n_features, config.kernel, generator, xs.dtype, xs.device)
    kw = dict(dtype=xs.dtype, device=xs.device)
    return omega.to(**kw), b.to(**kw), torch.broadcast_to(state.params["lengthscale"], (dim,))


def _normals(shape, given: Optional[Tensor], generator, like: Tensor) -> Tensor:
    if given is None:
        return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"injected draws must have shape {tuple(shape)}, got {tuple(given.shape)}")
    return given.to(dtype=like.dtype, device=like.device)


def rff_paths(
    state: G.GPState,
    xs: Tensor,
    n_paths: int,
    config: GPConfig,
    n_features: int = 1024,
    generator: Optional[torch.Generator] = None,
    draws: Draws = Draws(),
) -> Tensor:
    """``n_paths`` globally joint posterior sample paths at ``xs`` by
    weight-space conditioning, (n_paths, n_cand) in original y units:
    A = ΦᵀΦ/σ² + I, w ~ N(A⁻¹Φᵀr/σ², A⁻¹) drawn as mean + L_A⁻ᵀ z.

    Known failure mode, **variance starvation**: the prior is a rank-M
    degenerate GP, so near noise-free data the paths under-disperse at any
    practical M (``tests/test_acq.py::test_rff_variance_starvation_characterization``).
    Draws (``draws.omega``, ``.b``, ``.weights``) are injectable."""
    with span("acq.sample"):
        p = state.params
        omega, b, ls = _features(state, xs, n_features, config, generator, draws)
        phi_x = _rff_phi(state.x_buf, omega, b, ls, p["outputscale"])  # (N_max, M)
        phi_x = torch.where(state.mask[:, None], phi_x, torch.zeros_like(phi_x))
        noise = p["noise"]
        eye = torch.eye(omega.shape[0], dtype=xs.dtype, device=xs.device)
        chol_a = L.cholesky_nan(phi_x.mT @ phi_x / noise + eye)[0]
        mean_w = L.cho_solve(chol_a, phi_x.mT @ _residual(state) / noise)
        z = _normals((n_paths, omega.shape[0]), draws.weights, generator, xs)
        w = mean_w[None, :] + L.solve_upper_t(chol_a, z.mT).mT  # (n_paths, M): mean + L⁻ᵀ z
        phi_c = _rff_phi(xs, omega, b, ls, p["outputscale"])  # (n_cand, M)
        draws_std = p["mean"] + w @ phi_c.mT
        return draws_std * state.y_std + state.y_mean


def pathwise_paths(
    state: G.GPState,
    xs: Tensor,
    n_paths: int,
    config: GPConfig,
    n_features: int = 1024,
    generator: Optional[torch.Generator] = None,
    draws: Draws = Draws(),
) -> Tensor:
    """Decoupled pathwise posterior sampling (Matheron's rule), globally
    joint draws at ``xs`` with the exact data update,

        f_post(x*) = φ(x*)ᵀw + k(x*, X)(K + σ²I)⁻¹(r − φ(X)ᵀw − ε),

    w ~ N(0, I_M) a prior weight path, ε ~ N(0, σ²I). Returns (n_paths,
    n_cand) draws in original y units. The M-feature truncation perturbs
    only the prior path, so there is no variance starvation
    (``tests/test_acq.py::test_pathwise_no_variance_starvation``). The cross
    k(x*, X) is built by ``gp._kernel_matrix`` (the kernel on CUDA
    tensors), its inactive columns zeroed, and the update solves against
    the cached factor. Draws (``draws.omega``, ``.b``, ``.weights`` as w,
    ``.eps``) are injectable."""
    with span("acq.sample"):
        p = state.params
        omega, b, ls = _features(state, xs, n_features, config, generator, draws)
        n_max = state.mask.shape[0]
        w = _normals((n_paths, omega.shape[0]), draws.weights, generator, xs)
        eps = torch.sqrt(p["noise"]) * _normals((n_paths, n_max), draws.eps, generator, xs)
        prior_x = w @ _rff_phi(state.x_buf, omega, b, ls, p["outputscale"]).mT  # (n_paths, N_max)
        prior_c = w @ _rff_phi(xs, omega, b, ls, p["outputscale"]).mT  # (n_paths, n_cand)
        # the exact update direction u = (K+σ²I)⁻¹(r − prior_x − ε), inactive
        # rows zeroed: the identity-padded factor keeps them zero
        rhs = torch.where(state.mask[None, :], _residual(state)[None, :] - prior_x - eps, torch.zeros_like(prior_x))
        u = L.cho_solve(state.chol, rhs.mT)  # (N_max, n_paths)
        k_cross = G._kernel_matrix(p, xs, state.x_buf, config, add_noise=False)  # (n_cand, N_max)
        k_cross = torch.where(state.mask[None, :], k_cross, torch.zeros_like(k_cross))
        draws_std = p["mean"] + prior_c + (k_cross @ u).mT
        return draws_std * state.y_std + state.y_mean


def rff_thompson_select(
    state: G.GPState, xs: Tensor, q: int, config: GPConfig, n_features: int = 1024,
    generator: Optional[torch.Generator] = None, draws: Draws = Draws(),
) -> Tuple[Tensor, Tensor]:
    """Weight-space TS (``ts_sampler="rff"``): q joint paths, q-batch
    selection without replacement."""
    idxs, vals = select_q_batch(rff_paths(state, xs, q, config, n_features, generator, draws))
    return xs[idxs], vals


def pathwise_thompson_select(
    state: G.GPState, xs: Tensor, q: int, config: GPConfig, n_features: int = 1024,
    generator: Optional[torch.Generator] = None, draws: Draws = Draws(),
) -> Tuple[Tensor, Tensor]:
    """Pathwise TS (``ts_sampler="pathwise"``): q decoupled posterior
    paths, q-batch selection without replacement."""
    idxs, vals = select_q_batch(pathwise_paths(state, xs, q, config, n_features, generator, draws))
    return xs[idxs], vals


def thompson_values(
    state: G.GPState, xs: Tensor, q: int, config: GPConfig, sampler: str = "exact",
    chunk_size: Optional[int] = None, dtype: Optional[str] = None, n_features: int = 1024,
    generator: Optional[torch.Generator] = None, draws: Draws = Draws(),
) -> Tensor:
    """(q, n_cand) Thompson values from the loops' ``ts_sampler``:
    ``"exact"`` (chunked joint factorization, ``chunk_size`` and ``dtype``),
    ``"rff"`` or ``"pathwise"`` (``n_features`` random Fourier features)."""
    if sampler == "exact":
        return thompson_samples(state, xs, q, config, chunk_size, generator, draws.normals, dtype)
    if sampler == "rff":
        return rff_paths(state, xs, q, config, n_features, generator, draws)
    if sampler == "pathwise":
        return pathwise_paths(state, xs, q, config, n_features, generator, draws)
    raise ValueError(f"unknown ts_sampler {sampler!r}; expected 'exact', 'rff' or 'pathwise'")
