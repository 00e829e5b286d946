"""Covariance kernels: RBF and the Matérn family with ARD (port of
``turbojax.kernels``).

The kernel matrix comes from one matrix product (the cross term of the
pairwise squared distance) plus elementwise math. Every function takes
inputs with any leading batch dimensions, ``(..., n, d)`` and
``(..., m, d)``, and keeps their dtype and device. Kernel params are a dict
``{"lengthscale": (d,) or (), "outputscale": ()}``.

The hand-written CUDA kernel that fuses the same chain is in
``turbojax_torch.cuda_kernels``; ``gp._kernel_matrix`` routes through it.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

Tensor = torch.Tensor
KernelFn = Callable[[Dict[str, Tensor], Tensor, Tensor], Tensor]

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


def pairwise_sqdist(x1: Tensor, x2: Tensor) -> Tensor:
    """Pairwise squared Euclidean distances, (..., n, d) x (..., m, d) ->
    (..., n, m), through the expansion ‖a‖² + ‖b‖² − 2a·b, **centered
    first**: the expansion's absolute error is ~eps·‖x‖², so for clustered
    inputs (trust-region candidates at small TR length, scaled by 1/ℓ) the
    uncentered form loses the signal in f32. Subtracting the shared mean is
    distance-invariant; the remaining cancellation is clamped at 0.

    When ``x2`` is ``x1`` the squared norms are read off the diagonal of
    the Gram matrix itself, so the diagonal of K(X, X) is exactly 0, as it
    is in the CUDA kernel (whose norms share the cross term's FMA order)."""
    c = 0.5 * (x1.mean(dim=-2, keepdim=True) + x2.mean(dim=-2, keepdim=True))
    if x2 is x1:
        xc = x1 - c
        cross = xc @ xc.mT
        sq = cross.diagonal(dim1=-2, dim2=-1)
        return torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * cross, 0.0)
    x1 = x1 - c
    x2 = x2 - c
    cross = x1 @ x2.mT
    sq1 = (x1 * x1).sum(dim=-1)[..., :, None]
    sq2 = (x2 * x2).sum(dim=-1)[..., None, :]
    return torch.clamp_min(sq1 + sq2 - 2.0 * cross, 0.0)


def from_sqdist(kernel_name: str, d2: Tensor, outputscale: Tensor) -> Tensor:
    """outputscale · k(d²) for a squared distance, in the expression order of
    ``turbojax.kernels`` (outputscale · polynomial · exp)."""
    if kernel_name == "rbf":
        return outputscale * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-30)
    if kernel_name == "matern12":
        return outputscale * torch.exp(-r)
    if kernel_name == "matern32":
        sr = _SQRT3 * r
        return outputscale * (1.0 + sr) * torch.exp(-sr)
    if kernel_name == "matern52":
        sr = _SQRT5 * r
        return outputscale * (1.0 + sr + (5.0 / 3.0) * d2) * torch.exp(-sr)
    raise ValueError(f"unknown kernel {kernel_name!r}; available: {sorted(KERNELS)}")


def _sqdist_scaled(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    z1 = x1 / params["lengthscale"]
    z2 = z1 if x2 is x1 else x2 / params["lengthscale"]
    return pairwise_sqdist(z1, z2)


def rbf(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    """Squared-exponential: s² · exp(−½‖(x1−x2)/ℓ‖²)."""
    return from_sqdist("rbf", _sqdist_scaled(params, x1, x2), params["outputscale"])


def matern12(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    """Matérn-1/2 (exponential): s² · exp(−r)."""
    return from_sqdist("matern12", _sqdist_scaled(params, x1, x2), params["outputscale"])


def matern32(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    """Matérn-3/2: s² · (1 + √3 r) exp(−√3 r)."""
    return from_sqdist("matern32", _sqdist_scaled(params, x1, x2), params["outputscale"])


def matern52(params: Dict[str, Tensor], x1: Tensor, x2: Tensor) -> Tensor:
    """Matérn-5/2: s² · (1 + √5 r + 5r²/3) exp(−√5 r)."""
    return from_sqdist("matern52", _sqdist_scaled(params, x1, x2), params["outputscale"])


KERNELS: Dict[str, KernelFn] = {
    "rbf": rbf,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
}


def get_kernel(name: str) -> KernelFn:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(KERNELS)}") from None


def kernel_diag(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """k(x, x) for each row: the outputscale for every stationary kernel."""
    return torch.broadcast_to(params["outputscale"], x.shape[:-1])
