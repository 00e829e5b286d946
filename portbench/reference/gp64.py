"""Exact GP regression with the configuration's stationary kernel (the
module ``reference/kernels/<gp.kernel>.py``, found by name), its marginal
likelihood's gradient in closed form, Adam, and the two Thompson samplers
of the configurations (pathwise with random Fourier features, and exact
joint sampling in chunks), in plain PyTorch in ``dtype`` (float64 for the
reference; the control runs the same code in float32 with TF32 on).

The semantics follow the configuration files: hyperparameters through a
scaled sigmoid into their boxes, y standardized over the history, a relative
diagonal jitter of ``jitter`` times the mean of K's diagonal before every
factorization (a ladder of ×1, ×1e2, ×1e4 for the posterior's factor, where
a failed rung moves to the next), the marginal likelihood's factorization
failing to a zero gradient, and the Thompson covariance's bumps of
``1e-6·max(diag) + rung·outputscale·y_std²`` over the float32 rungs
(3e-5, 3e-4, 3e-3)."""

from __future__ import annotations

import math
from types import ModuleType
from typing import NamedTuple, Optional, Tuple

import torch

from portbench import manifest

Tensor = torch.Tensor

_TS_RUNGS = (3e-5, 3e-4, 3e-3)
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def kernel_module(gp: dict) -> ModuleType:
    """The covariance function ``gp["kernel"]`` names; a ``ValueError``
    where the reference implements none of that name."""
    try:
        return manifest.find("reference/kernels", gp["kernel"])
    except LookupError as e:
        raise ValueError(f"the reference implements no kernel {gp['kernel']!r}: {e}") from None


class Hypers(NamedTuple):
    lengthscale: Tensor  # (d,)
    outputscale: Tensor  # ()
    noise: Tensor  # ()


def _sigmoid_box(raw: Tensor, box) -> Tensor:
    lo, hi = box
    return lo + (hi - lo) * torch.sigmoid(raw)


def constrain(raw: Tensor, gp: dict) -> Hypers:
    """raw = [ℓ₁..ℓ_d, outputscale, noise, mean] (the mean is not learned)."""
    d = raw.shape[0] - 3
    noise = torch.clamp_min(_sigmoid_box(raw[d + 1], gp["noise_bounds"]), gp["noise_floor"])
    return Hypers(_sigmoid_box(raw[:d], gp["lengthscale_bounds"]), _sigmoid_box(raw[d], gp["outputscale_bounds"]),
                  noise)


def raw_from_values(lengthscale: float, outputscale: float, noise: float, dim: int, gp: dict,
                    dtype=torch.float64, device=None) -> Tensor:
    def logit(v, box):
        t = min(max((v - box[0]) / (box[1] - box[0]), 1e-6), 1.0 - 1e-6)
        return math.log(t) - math.log1p(-t)

    vals = [logit(lengthscale, gp["lengthscale_bounds"])] * dim
    vals += [logit(outputscale, gp["outputscale_bounds"]), logit(max(noise, gp["noise_floor"]), gp["noise_bounds"]), 0.0]
    return torch.tensor(vals, dtype=dtype, device=device)


def standardize(y: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    mean = y.mean()
    sd = torch.clamp_min(torch.sqrt(((y - mean) ** 2).mean()), 1e-8)
    return (y - mean) / sd, mean, sd


def sqdist(z1: Tensor, z2: Optional[Tensor] = None) -> Tensor:
    """Pairwise squared distances of scaled inputs, centered first; with
    one input the diagonal is exactly 0."""
    same = z2 is None
    z2 = z1 if same else z2
    c = 0.5 * (z1.mean(dim=0) + z2.mean(dim=0))
    a, b = z1 - c, z2 - c
    d2 = (a * a).sum(dim=1)[:, None] + (b * b).sum(dim=1)[None, :] - 2.0 * (a @ b.T)
    d2.clamp_(min=0.0)
    if same:
        d2.fill_diagonal_(0.0)
    return d2


def kernel(x1: Tensor, x2: Optional[Tensor], h: Hypers, gp: dict) -> Tensor:
    z1 = x1 / h.lengthscale
    return kernel_module(gp).value(sqdist(z1, None if x2 is None else x2 / h.lengthscale), h.outputscale)


def _eye_add_(a: Tensor, value) -> Tensor:
    a.diagonal().add_(value)
    return a


def train_shift(h: Hypers, jitter: float, rel: float) -> Tensor:
    """What goes on K_f's diagonal: the noise, then ``rel`` times the mean
    of (K_f + σ²I)'s diagonal, outputscale + noise."""
    return h.noise + rel * (h.outputscale + h.noise)


def cholesky(a: Tensor) -> Tuple[Tensor, bool]:
    l_mat, info = torch.linalg.cholesky_ex(a)
    return l_mat, int(info) == 0


def factor(x: Tensor, h: Hypers, gp: dict) -> Tensor:
    """The factor of K_f + σ²I + rel·mean(diag)·I over the ladder
    rel = jitter, 1e2·jitter, 1e4·jitter; NaN when every rung fails."""
    k_f = kernel(x, None, h, gp)
    jitter = gp["jitter"]
    for rel in (jitter, 1e2 * jitter, 1e4 * jitter):
        l_mat, ok = cholesky(_eye_add_(k_f.clone(), train_shift(h, jitter, rel)))
        if ok:
            return l_mat
    return torch.full_like(k_f, math.nan)


def cho_solve(l_mat: Tensor, b: Tensor) -> Tensor:
    return torch.cholesky_solve(b if b.dim() == 2 else b[:, None], l_mat).reshape(b.shape)


def loss_and_grad(x: Tensor, y_std: Tensor, raw: Tensor, gp: dict) -> Tuple[Tensor, Tensor]:
    """(−mll/n, its gradient in the raw parameters) at a fixed jitter.

    With K = K_f + cI, c = σ² + jitter·(s + σ²) and W = K⁻¹ − ααᵀ:
    ∂(−mll/n)/∂θ = tr(W ∂K/∂θ)/(2n), where ∂K/∂s = K_f/s + jitter·I,
    ∂K/∂σ² = (1 + jitter)·I and ∂K/∂ℓ_k = G ⊙ D_k · (−2/ℓ_k³), G the
    kernel's derivative in the scaled squared distance (its module's
    ``value_and_slope``) and D_k the pairwise squared differences in
    dimension k. A failed factorization gives a NaN
    loss and a zero gradient."""
    n, d = x.shape
    jitter = gp["jitter"]
    raw = raw.detach()
    h = constrain(raw, gp)
    d2 = sqdist(x / h.lengthscale)
    k_mat, g_mat = kernel_module(gp).value_and_slope(d2, h.outputscale)  # k and ∂k/∂d²
    del d2
    c = train_shift(h, jitter, jitter)
    _eye_add_(k_mat, c)
    l_mat, ok = cholesky(k_mat)
    del k_mat
    if not ok:
        return torch.tensor(math.nan, dtype=x.dtype, device=x.device), torch.zeros_like(raw)
    alpha = cho_solve(l_mat, y_std)
    logdet = 2.0 * torch.log(l_mat.diagonal()).sum()
    loss = 0.5 * ((y_std * alpha).sum() + logdet + n * math.log(2.0 * math.pi)) / n
    w = torch.cholesky_inverse(l_mat)
    del l_mat
    tr_kinv = w.diagonal().sum()
    w.addr_(alpha, alpha, alpha=-1.0)  # W = K⁻¹ − ααᵀ
    tr_w = tr_kinv - (alpha * alpha).sum()
    tr_wk_f = n - (alpha * y_std).sum() - c * tr_w  # tr(W K) = n − αᵀy, K = K_f + cI
    w.mul_(g_mat)  # M = W ⊙ G
    del g_mat
    xc = x - x.mean(dim=0)
    s_k = 2.0 * ((xc * xc) * w.sum(dim=1)[:, None]).sum(dim=0) - 2.0 * (xc * (w @ xc)).sum(dim=0)
    grad_ls = (-2.0 / h.lengthscale**3) * s_k / (2 * n)
    grad_s = (tr_wk_f / h.outputscale + jitter * tr_w) / (2 * n)
    grad_noise = (1.0 + jitter) * tr_w / (2 * n)

    def dbox(raw_v, box):
        sig = torch.sigmoid(raw_v)
        return (box[1] - box[0]) * sig * (1.0 - sig)

    grad = torch.zeros_like(raw)
    grad[:d] = grad_ls * dbox(raw[:d], gp["lengthscale_bounds"])
    grad[d] = grad_s * dbox(raw[d], gp["outputscale_bounds"])
    grad[d + 1] = grad_noise * dbox(raw[d + 1], gp["noise_bounds"])
    return loss, grad


def fit_adam(x: Tensor, y_std: Tensor, raw0: Tensor, gp: dict, steps: int) -> Tensor:
    """``steps`` Adam steps of learning rate ``fit_lr`` (b1 0.9, b2 0.999,
    eps 1e-8 after the square root, bias-corrected) on −mll/n from
    ``raw0``; a non-finite gradient element is zeroed, a non-finite iterate
    keeps the previous one."""
    raw = raw0.clone()
    m, v = torch.zeros_like(raw), torch.zeros_like(raw)
    lr = gp["fit_lr"]
    for t in range(1, steps + 1):
        _, g = loss_and_grad(x, y_std, raw, gp)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        m = (1 - _ADAM_B1) * g + _ADAM_B1 * m
        v = (1 - _ADAM_B2) * g * g + _ADAM_B2 * v
        new = raw - lr * ((m / (1 - _ADAM_B1**t)) / (torch.sqrt(v / (1 - _ADAM_B2**t)) + _ADAM_EPS))
        if bool(torch.isfinite(new).all()):
            raw = new
    return raw


class Posterior(NamedTuple):
    x: Tensor
    h: Hypers
    l_mat: Tensor
    alpha: Tensor  # K⁻¹ y_std
    y_std: Tensor
    y_mean: Tensor
    y_sd: Tensor
    gp: dict


def posterior(x: Tensor, y: Tensor, raw: Tensor, gp: dict) -> Posterior:
    h = constrain(raw, gp)
    y_std, y_mean, y_sd = standardize(y)
    l_mat = factor(x, h, gp)
    return Posterior(x, h, l_mat, cho_solve(l_mat, y_std), y_std, y_mean, y_sd, gp)


def rff(x: Tensor, omega: Tensor, b: Tensor, h: Hypers) -> Tensor:
    m = omega.shape[0]
    return torch.sqrt(2.0 * h.outputscale / m) * torch.cos((x / h.lengthscale) @ omega.T + b)


def pathwise_values(post: Posterior, cands: Tensor, omega: Tensor, b: Tensor, weights: Tensor,
                    eps: Tensor) -> Tensor:
    """(q, m) posterior paths by Matheron's rule, original units:
    φ(x*)ᵀw + k(x*, X)K⁻¹(y_std − φ(X)ᵀw − σε)."""
    h = post.h
    prior_x = weights @ rff(post.x, omega, b, h).T
    prior_c = weights @ rff(cands, omega, b, h).T
    rhs = post.y_std[None, :] - prior_x - torch.sqrt(h.noise) * eps
    u = cho_solve(post.l_mat, rhs.T)
    values = prior_c + (kernel(cands, post.x, h, post.gp) @ u).T
    return values * post.y_sd + post.y_mean


def exact_values(post: Posterior, cands: Tensor, normals: Tensor, chunk: int) -> Tensor:
    """(q, m) joint posterior draws per chunk of the candidates, original
    units: μ + z Lᵀ with L the factor of the chunk's covariance plus the
    float32 sampler's bumps."""
    h, sd = post.h, post.y_sd
    scale_abs = h.outputscale * sd * sd
    out = []
    for c, z in zip(cands.split(chunk), normals.split(chunk, dim=1)):
        k_cross = kernel(post.x, c, h, post.gp)
        v = torch.linalg.solve_triangular(post.l_mat, k_cross, upper=False)
        mu = (k_cross.T @ post.alpha) * sd + post.y_mean
        cov = (kernel(c, None, h, post.gp) - v.T @ v) * (sd * sd)
        cmax = torch.clamp_min(cov.diagonal().max(), 1e-12)
        l_cov = None
        for rung in _TS_RUNGS:
            l_cov, ok = cholesky(_eye_add_(cov.clone(), 1e-6 * cmax + rung * scale_abs))
            if ok:
                break
        if not ok:
            l_cov = torch.full_like(cov, math.nan)
        out.append(mu[None, :] + z @ l_cov.T)
    return torch.cat(out, dim=1)


def select_q(values: Tensor) -> Tensor:
    """Row j takes the lowest value among the candidates no earlier row
    took; non-finite values are never taken."""
    taken = torch.zeros(values.shape[1], dtype=torch.bool, device=values.device)
    picks = []
    for row in values:
        masked = torch.where(taken | ~torch.isfinite(row), torch.full_like(row, math.inf), row)
        i = int(torch.argmin(masked))
        taken[i] = True
        picks.append(i)
    return torch.tensor(picks, device=values.device)
