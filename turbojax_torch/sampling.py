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
draws the JAX twin made (the LMS rows and the shift as integers).
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


def _gray_sobol(dim: int, idx: Tensor, sv: Optional[Tensor] = None) -> Tensor:
    """(n, dim) int64 Sobol integers of the points ``idx`` (int64, (n,)),
    from the Joe-Kuo direction numbers or from ``sv`` ((dim, 30) int64)."""
    if sv is None:
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


def _parity(x: Tensor) -> Tensor:
    """Bitwise parity (popcount mod 2) of non-negative int64 values below 2**32."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def lms_scramble_sv(sv: Tensor, rows: Tensor) -> Tensor:
    """Apply a linear matrix scramble (Matousek) to Sobol direction numbers.

    ``sv``: (dim, 30) int64 direction numbers (30-bit, the top bit the most
    significant fraction bit). ``rows``: (dim, 30) int64 GF(2) matrix rows in
    integer-bit encoding: row ``i`` (i = 0 acts on the most significant
    output bit) has its forced diagonal at bit 29 − i, random bits only
    above it, zeros below. Bit 29 − i of each scrambled direction number is
    ``parity(rows[d, i] & v)``: scipy's ``Sobol(scramble=True)``
    ``_cscramble`` convention, bit for bit. Scrambling the 30 direction
    numbers once equals scrambling every point."""
    par = _parity(rows[:, :, None] & sv[:, None, :])  # (dim, i, b)
    weights = 1 << (_SOBOL_BITS - 1 - torch.arange(_SOBOL_BITS, dtype=torch.int64, device=sv.device))
    return (par * weights[None, :, None]).sum(dim=1)


def lms_random_rows(
    dim: int, generator: Optional[torch.Generator] = None, device=None, bits: Optional[Tensor] = None
) -> Tensor:
    """Random LMS row masks for ``lms_scramble_sv``: per dimension an
    independent lower-triangular (most significant bit first) random GF(2)
    matrix with unit diagonal. ``bits`` ((dim, 30) non-negative integers)
    replaces the random draw; only their bits above each row's diagonal,
    within the low 30, are used."""
    if bits is None:
        bits = torch.randint(0, 2**_SOBOL_BITS, (dim, _SOBOL_BITS), generator=generator, device=device)
    bits = bits.to(device=device, dtype=torch.int64)
    i = torch.arange(_SOBOL_BITS, dtype=torch.int64, device=bits.device)
    diag = 1 << (_SOBOL_BITS - 1 - i)
    # strictly above the diagonal: positions ≥ 30 − i (none for i = 0)
    high = ((1 << _SOBOL_BITS) - 1) & ~((1 << (_SOBOL_BITS - i)) - 1)
    return (bits & high[None, :]) | diag[None, :]


def sobol_sample(
    dim: int, n: int, generator: Optional[torch.Generator] = None, dtype=torch.float32,
    device=None, scramble: str = "shift", shift: Optional[Tensor] = None,
    lms_bits: Optional[Tensor] = None,
) -> Tensor:
    """Randomized Sobol points (RQMC), a fresh randomization per call.
    ``scramble="shift"``: a digital shift only (XOR with per-dimension random
    30-bit offsets). ``"lms"``: a Matousek linear matrix scramble of the
    direction numbers, then the shift: the randomization class of
    ``scipy.stats.qmc.Sobol(scramble=True)``. ``shift`` ((dim,) integers
    below 2**30) and ``lms_bits`` (see ``lms_random_rows``) replace the
    random draws."""
    sv = None
    if scramble == "lms":
        sv = torch.as_tensor(_direction_numbers(dim), device=device)
        sv = lms_scramble_sv(sv, lms_random_rows(dim, generator, sv.device, lms_bits))
    elif scramble != "shift":
        raise ValueError(f"unknown scramble {scramble!r}; use 'shift' or 'lms'")
    if shift is None:
        shift = torch.randint(0, 2**_SOBOL_BITS, (dim,), generator=generator, device=device)
    acc = _gray_sobol(dim, torch.arange(n, dtype=torch.int64, device=device), sv)
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
    local_sigma: float = 0.3,
    local_normals: Optional[Tensor] = None,
) -> Tensor:
    """TuRBO trust-region candidates in the unit cube.

    The box side per dimension is the TR length scaled by the normalized ARD
    weights ``w = ℓ/mean(ℓ) / prod(ℓ/mean(ℓ))^(1/d)``; Sobol points fill the
    clipped box, and each candidate perturbs only a masked subset of
    dimensions away from the center. ``local_frac > 0`` replaces
    round(local_frac·n_cand) of the Sobol points (the last rows) with
    Gaussian draws around the center, σ = ``local_sigma`` × the per-dimension
    half width, clipped to the box; they get the same perturbation masks.
    ``shift`` (the Sobol digital shift), ``mask`` ((n_cand, d) bool
    perturbation mask) and ``local_normals`` ((n_local, d) standard normals)
    replace the draws."""
    dim = center.shape[-1]
    w = lengthscale / lengthscale.mean()
    w = w / torch.exp(torch.log(w).mean())  # prod(w)^(1/d) normalization
    half = w * length / 2.0
    lb = torch.clamp(center - half, 0.0, 1.0)
    ub = torch.clamp(center + half, 0.0, 1.0)
    n_local = int(round(local_frac * n_cand))
    pert = lb + (ub - lb) * sobol_sample(
        dim, n_cand - n_local, generator, center.dtype, center.device, scramble, shift
    )
    if n_local:
        if local_normals is None:
            local_normals = torch.randn((n_local, dim), generator=generator, dtype=center.dtype, device=center.device)
        g = center + local_sigma * half * local_normals.to(center.dtype)
        pert = torch.cat([pert, torch.minimum(torch.maximum(g, lb), ub)], dim=0)
    if mask is None:
        mask = perturbation_mask(n_cand, dim, generator, center.device)
    return torch.where(mask, pert, center[None, :])


def n_candidates(dim: int, cap: int = 5000) -> int:
    """Reference candidate-set size: min(100·d, 5000)."""
    return min(100 * dim, cap)
