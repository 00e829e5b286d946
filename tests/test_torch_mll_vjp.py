"""The marginal likelihood's closed-form backward (``gp._QuadLogdet``) and
``linalg.chol_inverse``.

In float64 on the CPU the gradient of the fit's loss, −(mll + log prior)/n,
is held to reverse mode through ``torch.linalg.cholesky`` and
``torch.cholesky_solve`` (written out below) at round-off: one lane, lanes
with different masks (padded rows), and a batch with one lane whose
factorization fails. The forward is held bitwise to the chain of operations
it replaced. On a card (``cuda``), the same comparison at N = 4096 in
float32, each route against float64, and ``chol_inverse`` across the
recursion's base against ``torch.cholesky_inverse``.
"""

import pytest
import torch

from turbojax_torch import cuda_kernels as CK
from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

D = 3
FAILING = dict(noise_bounds=(-1.0, 0.2), noise_floor=-1.0)  # the noise can make K + σ²I indefinite


def _problem(ns, n_max, dtype=torch.float64, device="cpu", seed=0, dim=D):
    """Lanes of ``n_max``-row buffers with ``ns[i]`` active rows each, and
    one set of raw hypers per lane."""
    g = torch.Generator(device=device).manual_seed(seed)
    lanes = len(ns)
    mask = torch.arange(n_max, device=device)[None] < torch.tensor(ns, device=device)[:, None]
    x = torch.where(mask[..., None], torch.rand((lanes, n_max, dim), generator=g, dtype=dtype, device=device), 0.0)
    y = torch.sin(3 * x[..., 0]) + x[..., 1] ** 2 + 0.1 * torch.randn((lanes, n_max), generator=g, dtype=dtype,
                                                                      device=device)
    y = torch.where(mask, y, 0.0)
    mean = y.sum(-1, keepdim=True) / mask.sum(-1, keepdim=True)
    sd = torch.sqrt(torch.where(mask, (y - mean) ** 2, 0.0).sum(-1, keepdim=True) / mask.sum(-1, keepdim=True))
    y_std = torch.where(mask, (y - mean) / sd, 0.0)
    raw = G.GPParams(
        raw_lengthscale=0.3 * torch.randn((lanes, dim), generator=g, dtype=dtype, device=device),
        raw_outputscale=torch.linspace(-0.5, 0.5, lanes, dtype=dtype, device=device),
        raw_noise=torch.linspace(-4.0, -2.0, lanes, dtype=dtype, device=device),
        raw_mean=torch.linspace(-0.2, 0.3, lanes, dtype=dtype, device=device),
    )
    return raw, x, y_std, mask


def _reverse_mode_mll(raw, x, y_std, mask, config):
    """The MLL with its gradient by reverse mode through the Cholesky."""
    p = G.constrain_params(raw, config)
    a_mat = L._bumped(L.mask_kernel_matrix(G._kernel_matrix(p, x, x, config, add_noise=True), mask), config.jitter)
    chol = torch.linalg.cholesky(a_mat)
    resid = torch.where(mask, y_std - p["mean"][..., None], torch.zeros_like(y_std))
    alpha = torch.cholesky_solve(resid[..., None], chol)[..., 0]
    diag = torch.where(mask, chol.diagonal(dim1=-2, dim2=-1), torch.ones_like(resid))
    n_act = mask.sum(dim=-1).to(y_std.dtype)
    return -0.5 * ((resid * alpha).sum(-1) + 2.0 * torch.log(diag).sum(-1) + n_act * G._LOG_2PI)


def _loss_grads(mll_fn, raw, x, y_std, mask, config):
    """(−(mll + log prior)/n per lane, the gradient of their sum by leaf),
    ``_fit_one``'s loss."""
    leaves = [a.detach().clone().requires_grad_(True) for a in raw]
    r = G.GPParams(*leaves)
    val = mll_fn(r, x, y_std, mask, config)
    if config.fit_prior != "none":
        val = val + G.log_prior(r, x.shape[-1], config)
    loss = -val / mask.sum(dim=-1).to(y_std.dtype)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(a) if g is None else g for a, g in zip(raw, grads)]


@pytest.mark.parametrize("layout", ["one_lane", "lanes_with_padding"])
@pytest.mark.parametrize("learn_mean", [False, True])
@pytest.mark.parametrize("fit_prior", ["none", "dimscaled"])
def test_closed_form_gradient_matches_reverse_mode(layout, learn_mean, fit_prior):
    cfg = GPConfig(kernel="matern52", learn_mean=learn_mean, fit_prior=fit_prior)
    raw, x, y_std, mask = _problem([24, 17, 9] if layout == "lanes_with_padding" else [24], 24)
    if layout == "one_lane":
        raw, x, y_std, mask = G.GPParams(*(a[0] for a in raw)), x[0], y_std[0], mask[0]
    loss, grads = _loss_grads(G.mll, raw, x, y_std, mask, cfg)
    loss_ref, grads_ref = _loss_grads(_reverse_mode_mll, raw, x, y_std, mask, cfg)
    torch.testing.assert_close(loss, loss_ref, rtol=1e-12, atol=0.0)
    for name, g, g_ref in zip(G.GPParams._fields, grads, grads_ref):
        torch.testing.assert_close(g, g_ref, rtol=1e-9, atol=1e-12, msg=name)
    assert bool(grads[3].abs().max() > 0) == learn_mean


def test_a_failing_lane_leaves_the_others_gradients_as_they_were():
    """Lane 1's noise makes its K + σ²I indefinite: its gradient is
    non-finite (``_fit_adam`` zeroes it), and lanes 0 and 2 get what they get
    alone, and what reverse mode gives them."""
    cfg = GPConfig(kernel="matern52", learn_mean=True, **FAILING)
    raw, x, y_std, mask = _problem([20, 16, 11], 20)
    raw = raw._replace(raw_noise=torch.tensor([2.5, -3.0, 2.0], dtype=torch.float64))  # σ² 0.11, −0.94, 0.057
    loss, grads = _loss_grads(G.mll, raw, x, y_std, mask, cfg)
    assert not bool(torch.isfinite(loss[1])) and bool(torch.isfinite(loss[[0, 2]]).all())
    assert not bool(torch.isfinite(torch.cat([g[1].reshape(-1) for g in grads])).all())
    good = torch.tensor([0, 2])
    sub = (G.GPParams(*(a[good] for a in raw)), x[good], y_std[good], mask[good])
    _, grads_alone = _loss_grads(G.mll, *sub, cfg)
    _, grads_ref = _loss_grads(_reverse_mode_mll, *sub, cfg)
    for name, g, g_alone, g_ref in zip(G.GPParams._fields, grads, grads_alone, grads_ref):
        torch.testing.assert_close(g[good], g_alone, rtol=1e-12, atol=1e-14, msg=name)
        torch.testing.assert_close(g[good], g_ref, rtol=1e-9, atol=1e-12, msg=name)


@pytest.mark.parametrize("layout", ["one_lane", "lanes_with_padding"])
def test_forward_is_bitwise_the_cholesky_chain(layout):
    """``mll``'s values are those of the chain it replaced: ``cholesky_nan``
    (through ``cholesky_jittered``), ``cho_solve`` and
    ``masked_logdet_from_chol`` on the bumped, masked matrix."""
    cfg = GPConfig(kernel="matern52", learn_mean=True)
    raw, x, y_std, mask = _problem([24, 17, 9] if layout == "lanes_with_padding" else [24], 24, seed=3)
    if layout == "one_lane":
        raw, x, y_std, mask = G.GPParams(*(a[0] for a in raw)), x[0], y_std[0], mask[0]
    p = G.constrain_params(raw, cfg)
    k_mat = L.mask_kernel_matrix(G._kernel_matrix(p, x, x, cfg, add_noise=True), mask)
    chol = L.cholesky_nan(L._bumped(k_mat, cfg.jitter))[0]
    resid = torch.where(mask, y_std - p["mean"][..., None], torch.zeros_like(y_std))
    alpha = L.cho_solve(chol, resid)
    quad = (resid * alpha).sum(dim=-1)
    logdet = L.masked_logdet_from_chol(chol, mask)
    want = -0.5 * (quad + logdet + mask.sum(dim=-1).to(y_std.dtype) * G._LOG_2PI)
    assert torch.equal(G.mll(raw, x, y_std, mask, cfg), want)
    with torch.no_grad():
        assert torch.equal(G.mll(raw, x, y_std, mask, cfg), want)


@pytest.mark.cuda
def test_cuda_closed_form_gradient_within_the_routes_float32_spread():
    """N = 4096, d = 10, float32 (TF32 off) on the card: each route's
    gradient against reverse mode in float64; the closed form's error at
    most twice reverse mode's in float32, or 1e-4 of the gradient's size.
    Then ``chol_inverse`` in float64 against ``torch.cholesky_inverse``
    across the recursion's base (set to 256 here): a batch of two at
    N = 1000, one lane NaN."""
    if not CK.available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel matrix has no CPU mode on a CUDA tensor)")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = GPConfig(kernel="matern52", learn_mean=True)
    raw64, x64, y64, mask = _problem([4000], 4096, device="cuda", seed=11, dim=10)
    raw64 = raw64._replace(raw_noise=torch.full_like(raw64.raw_noise, -5.0))
    grads = {}
    for label, fn, dtype in (("closed32", G.mll, torch.float32), ("reverse32", _reverse_mode_mll, torch.float32),
                             ("reverse64", _reverse_mode_mll, torch.float64)):
        raw = G.GPParams(*(a.to(dtype) for a in raw64))
        _, g = _loss_grads(fn, raw, x64.to(dtype), y64.to(dtype), mask, cfg)
        grads[label] = torch.cat([a.reshape(-1).double() for a in g])
    ref = grads["reverse64"]
    err_closed = float((grads["closed32"] - ref).abs().max())
    err_reverse = float((grads["reverse32"] - ref).abs().max())
    assert err_closed <= max(2.0 * err_reverse, 1e-4 * float(ref.abs().max())), (err_closed, err_reverse)

    base = L._CHOL_INVERSE_BASE
    try:
        L._CHOL_INVERSE_BASE = 256
        g = torch.Generator(device="cuda").manual_seed(5)
        a = torch.randn((2, 1000, 1000), generator=g, dtype=torch.float64, device="cuda")
        l_mat = torch.linalg.cholesky(a @ a.mT / 1000 + 0.1 * torch.eye(1000, dtype=torch.float64, device="cuda"))
        l_mat[1] = torch.nan
        got = L.chol_inverse(l_mat)
    finally:
        L._CHOL_INVERSE_BASE = base
    torch.testing.assert_close(got[0], torch.cholesky_inverse(l_mat[0]), rtol=1e-10, atol=1e-10)
    assert torch.equal(got[0], got[0].mT) and bool(torch.isnan(got[1]).all())
