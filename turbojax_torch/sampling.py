"""Init designs and trust-region candidate generation (port of
``turbojax.sampling``, main path).

The Joe-Kuo direction numbers come once from scipy on the host
(``scipy.stats.qmc.Sobol``); point generation is a gray-code XOR
accumulation on the device, randomized per call with a digital shift (XOR
with per-dimension random 30-bit offsets). The values have 30 bits, so the
XOR runs in ``int64``: exact, and clear of gaps in PyTorch's ``uint32``
operator coverage on CUDA.

Every stochastic function takes an explicit ``torch.Generator`` and also
accepts its draws as optional arguments, so that tests can hand in the
draws the JAX twin made. The ``"lms"`` scramble is later work.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

_SOBOL_BITS = 30


@functools.lru_cache(maxsize=None)
def _direction_numbers(dim: int) -> np.ndarray:
    """Host-side Joe-Kuo direction numbers, (dim, 30) int64."""
    from scipy.stats import qmc

    return np.asarray(qmc.Sobol(d=dim, scramble=False)._sv, dtype=np.int64)


def _gray_sobol(dim: int, idx: Tensor) -> Tensor:
    """(n, dim) int64 Sobol integers of the points ``idx`` (int64, (n,))."""
    sv = torch.as_tensor(_direction_numbers(dim), device=idx.device)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((idx.shape[0], dim), dtype=torch.int64, device=idx.device)
    for b in range(_SOBOL_BITS):
        take = (gray >> b) & 1
        acc = acc ^ (take[:, None] * sv[None, :, b])
    return acc


def sobol_raw(dim: int, n: int, start_index: int = 0, dtype=torch.float32, device=None) -> Tensor:
    """Unscrambled Sobol points start..start+n−1 in [0,1)^dim: the
    bit-exactness witness against scipy and ``turbojax.sampling.sobol_raw``."""
    idx = torch.arange(n, dtype=torch.int64, device=device) + start_index
    return _gray_sobol(dim, idx).to(dtype) / (2.0**_SOBOL_BITS)


def sobol_sample(
    dim: int, n: int, generator: Optional[torch.Generator] = None, dtype=torch.float32,
    device=None, scramble: str = "shift", shift: Optional[Tensor] = None,
) -> Tensor:
    """Digitally shifted Sobol points (RQMC), a fresh shift per call.
    ``shift`` ((dim,) integers below 2**30) replaces the random draw."""
    if scramble == "lms":
        raise NotImplementedError("scramble='lms' is not ported yet; use 'shift'")
    if scramble != "shift":
        raise ValueError(f"unknown scramble {scramble!r}; use 'shift' or 'lms'")
    if shift is None:
        shift = torch.randint(0, 2**_SOBOL_BITS, (dim,), generator=generator, device=device)
    acc = _gray_sobol(dim, torch.arange(n, dtype=torch.int64, device=device))
    acc = acc ^ shift.to(device=acc.device, dtype=torch.int64)[None, :]
    return acc.to(dtype) / (2.0**_SOBOL_BITS)


def latin_hypercube(
    n: int, dim: int, generator: Optional[torch.Generator] = None, dtype=torch.float32,
    device=None, perms: Optional[Tensor] = None, u: Optional[Tensor] = None,
) -> Tensor:
    """Latin-hypercube design in [0,1)^dim: one stratified sample per row per
    dimension through independent permutations. ``perms`` ((dim, n)
    permutations of 0..n−1) and ``u`` ((n, dim) uniforms) replace the draws."""
    if perms is None:
        perms = torch.rand((dim, n), generator=generator, device=device).argsort(dim=-1)
    if u is None:
        u = torch.rand((n, dim), generator=generator, dtype=dtype, device=device)
    return (perms.mT.to(dtype) + u.to(dtype)) / n


def perturbation_mask(
    n: int, dim: int, generator: Optional[torch.Generator] = None, device=None,
    bern: Optional[Tensor] = None, fallback_dim: Optional[Tensor] = None,
) -> Tensor:
    """TuRBO per-candidate perturbation mask: each dimension is perturbed
    with probability ``min(20/d, 1)``; a row that would perturb nothing gets
    one random dimension. ``bern`` ((n, dim) bool) and ``fallback_dim``
    ((n,) ints) replace the draws."""
    prob = min(20.0 / dim, 1.0)
    if bern is None:
        bern = torch.rand((n, dim), generator=generator, device=device) < prob
    if fallback_dim is None:
        fallback_dim = torch.randint(0, dim, (n,), generator=generator, device=device)
    fallback = torch.nn.functional.one_hot(fallback_dim.long(), dim).bool()
    return torch.where(bern.any(dim=-1, keepdim=True), bern, fallback)


def tr_candidates(
    center: Tensor,
    length: Tensor,
    lengthscale: Tensor,
    n_cand: int,
    generator: Optional[torch.Generator] = None,
    local_frac: float = 0.0,
    scramble: str = "shift",
    shift: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """TuRBO trust-region candidates in the unit cube.

    The box side per dimension is the TR length scaled by the normalized ARD
    weights ``w = ℓ/mean(ℓ) / prod(ℓ/mean(ℓ))^(1/d)``; Sobol points fill the
    clipped box, and each candidate perturbs only a masked subset of
    dimensions away from the center. ``shift`` (the Sobol digital shift) and
    ``mask`` ((n_cand, d) bool perturbation mask) replace the draws.
    ``local_frac > 0`` (Gaussian local candidates) is later work."""
    if local_frac:
        raise NotImplementedError("local_frac > 0 is not ported yet")
    dim = center.shape[-1]
    w = lengthscale / lengthscale.mean()
    w = w / torch.exp(torch.log(w).mean())  # prod(w)^(1/d) normalization
    half = w * length / 2.0
    lb = torch.clamp(center - half, 0.0, 1.0)
    ub = torch.clamp(center + half, 0.0, 1.0)
    pert = lb + (ub - lb) * sobol_sample(
        dim, n_cand, generator, center.dtype, center.device, scramble, shift
    )
    if mask is None:
        mask = perturbation_mask(n_cand, dim, generator, center.device)
    return torch.where(mask, pert, center[None, :])


def n_candidates(dim: int, cap: int = 5000) -> int:
    """Reference candidate-set size: min(100·d, 5000)."""
    return min(100 * dim, cap)
