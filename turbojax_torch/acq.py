"""Acquisition functions: EI, UCB/LCB, chunked joint Thompson sampling and
q-batch selection (port of ``turbojax.acq``, main-path part).

Convention: the framework **minimizes**. EI is improvement below the
incumbent; LCB = μ − κσ is minimized.

Ported: ``expected_improvement``, ``lower_/upper_confidence_bound``,
``_robust_cov_chol``, ``thompson_samples`` (``dtype=None`` only),
``select_q_batch`` and ``thompson_select``. The RFF and pathwise samplers
and ``ts_dtype="float64"`` are later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch.config import GPConfig

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
        return L.cholesky_nan(cov + (1e-6 * cmax + rung * scale_abs) * eye)

    for rung in rungs[:-1]:
        l_cov, info = attempt(rung)
        if int(info) == 0:
            return l_cov
    return attempt(rungs[-1])[0]


def thompson_samples(
    state: G.GPState,
    xs: Tensor,
    q: int,
    config: GPConfig,
    chunk_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    normals: Optional[Tensor] = None,
) -> Tensor:
    """Draw ``q`` joint posterior sample rows over the candidate set.

    Returns (q, n_cand) draws in original y units. The joint covariance is
    factorized per chunk of the candidate axis (exact joint law within a
    chunk, independent across chunks). ``normals`` (q, n_cand) replaces the
    standard-normal draws (columns in candidate order); otherwise they come
    from ``generator``."""
    m = xs.shape[0]
    scale_abs = (state.params["outputscale"] * state.y_std**2).to(xs.dtype)
    if normals is None:
        normals = torch.randn((q, m), generator=generator, dtype=xs.dtype, device=xs.device)
    elif normals.shape != (q, m):
        raise ValueError(f"normals must have shape {(q, m)}, got {tuple(normals.shape)}")

    def sample_chunk(chunk: Tensor, z: Tensor) -> Tensor:
        mu, cov = G.posterior_cov(state, chunk, config)
        l_cov = _robust_cov_chol(cov, scale_abs)
        return (mu[None, :] + z.to(cov.dtype) @ l_cov.mT).to(xs.dtype)

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
) -> Tuple[Tensor, Tensor]:
    """Batched-TS acquisition: draw, then select q points."""
    samples = thompson_samples(state, xs, q, config, chunk_size, generator, normals)
    idxs, vals = select_q_batch(samples)
    return xs[idxs], vals
