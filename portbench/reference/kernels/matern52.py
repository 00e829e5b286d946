"""Matérn-5/2: k = s (1 + √5 r + 5r²/3) exp(−√5 r)."""

import math

import torch

_SQRT5 = math.sqrt(5.0)
NU = 2.5


def value(d2: torch.Tensor, outputscale: torch.Tensor) -> torch.Tensor:
    r = torch.sqrt(d2)
    return outputscale * (1.0 + _SQRT5 * r + (5.0 / 3.0) * d2) * torch.exp(-_SQRT5 * r)


def value_and_slope(d2: torch.Tensor, outputscale: torch.Tensor):
    r = torch.sqrt(d2)
    e = torch.exp(-_SQRT5 * r)
    value = outputscale * (1.0 + _SQRT5 * r + (5.0 / 3.0) * d2) * e
    slope = (-(5.0 / 6.0) * outputscale) * (1.0 + _SQRT5 * r) * e
    return value, slope


def spectral(m: int, d: int, generator: torch.Generator, device) -> torch.Tensor:
    """A multivariate t with 2ν degrees of freedom: Z·√(ν/G), G = ½ Σ of
    2ν squared normals."""
    kw = dict(generator=generator, device=device)
    z = torch.randn((m, d), **kw)
    chi = torch.randn((m, int(2 * NU)), **kw)
    return z * torch.sqrt(NU / torch.clamp_min(0.5 * (chi * chi).sum(dim=-1, keepdim=True), 1e-12))
