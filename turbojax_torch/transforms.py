"""Input/output normalization and constraint transforms (port of
``turbojax.transforms``).

X is mapped to the unit cube before any GP math, y is standardized over the
active entries of its masked buffer, and hyperparameters go through a
sigmoid box so the fit is unconstrained. All functions are
shape-polymorphic and keep the dtype and device of their inputs.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def to_unit_cube(x: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Map points from the box [lb, ub] to [0, 1]^d."""
    return (x - lb) / (ub - lb)


def from_unit_cube(x: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
    """Map points from [0, 1]^d back to the box [lb, ub]."""
    return x * (ub - lb) + lb


def masked_mean_std(y: Tensor, mask: Tensor, eps: float = 1e-8):
    """Mean/std over the active entries of a masked buffer (over the last
    axis; leading axes are a batch of buffers); the std has a floor of
    ``eps`` so a constant history stays finite."""
    w = mask.to(y.dtype)
    n = torch.clamp_min(w.sum(dim=-1), 1.0)
    mean = (y * w).sum(dim=-1) / n
    var = (w * (y - mean[..., None]) ** 2).sum(dim=-1) / n
    std = torch.clamp_min(torch.sqrt(var), eps)
    return mean, std


def standardize(y: Tensor, mask: Tensor, eps: float = 1e-8):
    """Standardize the active entries of y; inactive entries are zeroed.
    Returns (y_std, mean, std)."""
    mean, std = masked_mean_std(y, mask, eps)
    y_std = torch.where(mask, (y - mean[..., None]) / std[..., None], torch.zeros_like(y))
    return y_std, mean, std


def warp_y(y: Tensor, kind: str) -> Tensor:
    """Monotone output warp applied before standardization: ``"none"`` or
    ``"bilog"`` = sign(y)·log1p(|y|)."""
    if kind in (None, "none"):
        return y
    if kind == "bilog":
        return torch.sign(y) * torch.log1p(torch.abs(y))
    raise ValueError(f"unknown y_warp {kind!r} (expected 'none' or 'bilog')")


def unstandardize(y_std: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return y_std * std + mean


def unstandardize_var(var_std: Tensor, std: Tensor) -> Tensor:
    return var_std * std**2


#: Penalty scale when a batch fails with no finite reference at all (empty
#: history and an all-NaN batch); it must never pass for a good value.
_IMPUTE_FLOOR = 1e6


def impute_failures(y_new: Tensor, y_buf: Tensor, mask: Tensor) -> Tensor:
    """Replace NaN/inf objective values with a penalty strictly worse than
    every finite observation in scope, so masked buffers never hold
    non-finite values and an imputed value never becomes the incumbent."""
    finite_new = torch.isfinite(y_new)
    neg_inf = torch.full_like(y_new[:1], -torch.inf)
    worst_hist = torch.where(mask, y_buf, neg_inf).max()
    worst_new = torch.where(finite_new, y_new, neg_inf).max()
    worst = torch.maximum(worst_hist, worst_new)
    worst = torch.where(torch.isfinite(worst), worst, torch.full_like(worst, _IMPUTE_FLOOR))
    penalty = worst + 3.0 * (torch.abs(worst) + 1.0)
    return torch.where(finite_new, y_new, penalty)


def softplus(x: Tensor) -> Tensor:
    return torch.nn.functional.softplus(x)


def inv_softplus(y: Tensor) -> Tensor:
    """Inverse of softplus, stable for large y: y + log(-expm1(-y))."""
    return y + torch.log(-torch.expm1(-y))


def constrain(raw: Tensor, lo: float, hi: float) -> Tensor:
    """Map an unconstrained value into (lo, hi) via a scaled sigmoid."""
    return lo + (hi - lo) * torch.sigmoid(raw)


def unconstrain(value: Tensor, lo: float, hi: float) -> Tensor:
    """Inverse of ``constrain``; clips into the open interval for safety."""
    t = (value - lo) / (hi - lo)
    t = torch.clamp(t, 1e-6, 1.0 - 1e-6)
    return torch.log(t) - torch.log1p(-t)
