"""The grid+Adam trainer against ``turbojax.gp`` in float64.

The MLL gradient (autograd through the kernel wrapper's backward) is held
to ``jax.grad`` at rtol 1e-9; the Adam lane and the grid+Adam polish with
its warm row to the JAX functions at rtol 1e-8. One problem forces a
failed Cholesky mid-trajectory: the noise may go negative
(``noise_bounds=(-1, 0.2)``), and the MLL gradient drives it below
−λ_min(K) after five steps, so every later step has NaN gradients in JAX
(zeros in the port) and both must end on the same iterate. The batched
trainer (a leading axis of independent fits, one per trust region) must
equal the per-fit trainer lane by lane, also when one lane fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import gp as JG
from turbojax import transforms as JT
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import convert as C
from turbojax_torch import gp as TG
from turbojax_torch import transforms as TT
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

N_MAX, D = 16, 3
RTOL = 1e-8
FAILING = dict(noise_bounds=(-1.0, 0.2), noise_floor=-1.0)  # the noise can make K + σ²I indefinite


def _data(seed, n=12, near_duplicates=False):
    rng = np.random.RandomState(seed)
    x = np.zeros((N_MAX, D))
    x[:n] = rng.rand(n, D)
    if near_duplicates:
        x[1:n:2] = x[0:n - 1:2] + 1e-3 * rng.rand(n // 2, D)
    y = np.zeros(N_MAX)
    y[:n] = np.sin(3 * x[:n, 0]) + x[:n, 1] ** 2
    return x, y, np.arange(N_MAX) < n


def _configs(optimizer, **kw):
    return JGPConfig(kernel="matern52", fit_optimizer=optimizer, **kw), GPConfig(kernel="matern52", fit_optimizer=optimizer, **kw)


def _raw_j(raw):
    return JG.GPParams(*(jnp.asarray(np.asarray(a)) for a in raw))


def _assert_raw_close(raw_t, raw_j, rtol=RTOL):
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(raw_t, name).numpy(), np.asarray(getattr(raw_j, name)),
                                   rtol=rtol, atol=1e-12, err_msg=name)


def test_mll_gradient_matches_jax_grad():
    x, y, mask = _data(0)
    jcfg, tcfg = _configs("adam")
    rng = np.random.RandomState(1)
    raw_np = JG.GPParams(raw_lengthscale=rng.randn(D) * 0.5, raw_outputscale=np.asarray(0.3),
                         raw_noise=np.asarray(-2.0), raw_mean=np.asarray(0.0))
    ys = JT.standardize(jnp.asarray(y), jnp.asarray(mask))[0]
    g_j = jax.grad(lambda r: JG.mll(r, jnp.asarray(x), ys, jnp.asarray(mask), jcfg))(_raw_j(raw_np))
    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True) for a in raw_np]
    val = TG.mll(TG.GPParams(*leaves), torch.as_tensor(x), torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask), tcfg)
    val_j = JG.mll(_raw_j(raw_np), jnp.asarray(x), ys, jnp.asarray(mask), jcfg)
    np.testing.assert_allclose(float(val), float(val_j), rtol=1e-12)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    for name, g in zip(JG.GPParams._fields[:3], grads[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(g_j, name)), rtol=1e-9, atol=1e-12, err_msg=name)
    assert grads[3] is None and float(np.asarray(g_j.raw_mean)) == 0.0  # learn_mean=False


@pytest.mark.parametrize("case", ["finite", "failure_mid_trajectory"])
def test_adam_lane_matches_jax(case):
    x, y, mask = _data(0)
    kw = dict(fit_lr=0.02, fit_maxiter=12, **(FAILING if case != "finite" else {}))
    jcfg, tcfg = _configs("adam", **kw)
    ys = JT.standardize(jnp.asarray(y), jnp.asarray(mask))[0]
    raw0 = JG.default_params(D, jcfg, jnp.float64)
    raw_j, loss_j = JG._fit_one(raw0, jnp.asarray(x), ys, jnp.asarray(mask), jcfg)
    raw_t, loss_t = TG._fit_one(C.gp_params_from_numpy(jax.tree.map(np.asarray, raw0)), torch.as_tensor(x),
                                torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask), tcfg)
    _assert_raw_close(raw_t, raw_j)
    if case == "finite":
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    else:
        # the trajectory went through failed factorizations: both end NaN
        assert np.isnan(float(loss_j)) and np.isnan(float(loss_t))
        half, _ = TG._fit_one(C.gp_params_from_numpy(jax.tree.map(np.asarray, raw0)), torch.as_tensor(x),
                              torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask),
                              dataclasses.replace(tcfg, fit_maxiter=5))
        ok = TG.mll(half, torch.as_tensor(x), torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask), tcfg)
        assert np.isfinite(float(ok))  # finite for five steps: the failure is mid-trajectory


@pytest.mark.parametrize("warm", ["none", "finite", "nonfinite", "failing_polish"])
def test_grid_adam_polish_matches_jax(warm):
    x, y, mask = _data(0 if warm == "failing_polish" else 2)
    kw = dict(fit_lr=0.1, fit_maxiter_warm=12)
    if warm == "failing_polish":
        kw.update(FAILING, fit_lr=0.05)
    jcfg, tcfg = _configs("grid+adam", **kw)
    rng = np.random.RandomState(3)
    warm_np = None
    if warm != "none":
        warm_np = JG.GPParams(raw_lengthscale=rng.randn(D) * 0.3 - 0.5, raw_outputscale=np.asarray(-1.0),
                              raw_noise=np.asarray(-3.0), raw_mean=np.asarray(0.0))
        if warm == "nonfinite":
            warm_np = warm_np._replace(raw_lengthscale=np.array([0.1, np.nan, 0.2]))
    js = JG._fit_gp_grid(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg, adam_polish=True,
                         warm_start=None if warm_np is None else _raw_j(warm_np))
    ts = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask), tcfg,
                   warm_start=None if warm_np is None else C.gp_params_from_numpy(warm_np))
    _assert_raw_close(ts.raw, js.raw)
    np.testing.assert_allclose(ts.chol.numpy(), np.asarray(js.chol), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=1e-6, atol=1e-9)
    assert all(bool(torch.isfinite(a).all()) for a in ts.raw)
    if warm == "failing_polish":
        # the polish from the kept row fails mid-way, so the grid's row is kept
        ys = TT.standardize(torch.as_tensor(y), torch.as_tensor(mask))[0]
        _, loss = TG._fit_one(ts.raw, torch.as_tensor(x), ys, torch.as_tensor(mask),
                              dataclasses.replace(tcfg, fit_optimizer="adam", fit_maxiter=12))
        assert np.isnan(float(loss))


def _stack(arrays):
    return torch.as_tensor(np.stack(arrays))


def test_batched_lanes_equal_per_lane_fits_with_one_lane_failing():
    """Three fits as one batch (the per-TR fit of TuRBO-m) against three
    separate fits: the Adam lanes (one of them fails mid-trajectory and must
    not freeze the others) and the whole grid+adam fit."""
    problems = [_data(0), _data(5, n=10, near_duplicates=True), _data(7, n=14)]
    _, tcfg = _configs("adam", fit_lr=0.02, fit_maxiter=12, **FAILING)
    xs = _stack([p[0] for p in problems])
    masks = _stack([p[2] for p in problems])
    ys = torch.stack([TT.standardize(torch.as_tensor(p[1]), torch.as_tensor(p[2]))[0] for p in problems])
    raw0 = TG.default_params(D, tcfg, torch.float64)
    lanes = TG.GPParams(*(a.expand((3,) + a.shape).clone() for a in raw0))
    raw_b, loss_b = TG._fit_one(lanes, xs, ys, masks, tcfg)
    finite = []
    for i in range(3):
        raw_i, loss_i = TG._fit_one(raw0, xs[i], ys[i], masks[i], tcfg)
        for a, b in zip(raw_b, raw_i):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(loss_b[i]), float(loss_i), rtol=1e-12)
        finite.append(bool(torch.isfinite(loss_i)))
    assert False in finite and True in finite  # one lane failed, the others went on

    _, gcfg = _configs("grid+adam", fit_lr=0.05, fit_maxiter_warm=12, **FAILING)
    warm = TG.GPParams(*(a.expand((3,) + a.shape).clone() for a in raw0))
    y_raw = _stack([p[1] for p in problems])
    state_b = TG.fit_gp(xs, y_raw, masks, gcfg, warm_start=warm)
    for i in range(3):
        state_i = TG.fit_gp(xs[i], y_raw[i], masks[i], gcfg, warm_start=TG.GPParams(*(a[i] for a in warm)))
        lane = TG.state_lane(state_b, i)
        for a, b in zip(lane.raw, state_i.raw):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(lane.chol.numpy(), state_i.chol.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(lane.alpha.numpy(), state_i.alpha.numpy(), rtol=1e-10, atol=1e-12)
