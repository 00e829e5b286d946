"""The restart trainers of the port against ``turbojax.gp`` in float64.

``log_prior`` and ``sample_restart_params`` (fed the uniforms behind JAX's
draws) to 1e-12; the Adam restart trainer, its ``fit_ftol`` early stop (the
same step count and final raw values) and ``fit_gp("adam")`` as a whole from
the same inits to 1e-8. L-BFGS is held by its result, not its trajectory
(the port's line search is its own): from the same inits each lane's final
−mll/n is at most JAX's + 1e-3, and the fit recovers the hypers of data
drawn from a known GP. ``grid_polish_both`` equals JAX's and never loses
MLL; no trainer returns non-finite hypers.
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

N_MAX, D = 20, 3
RTOL = 1e-8


def _data(seed, n=15):
    rng = np.random.RandomState(seed)
    x = np.zeros((N_MAX, D))
    x[:n] = rng.rand(n, D)
    y = np.zeros(N_MAX)
    y[:n] = np.sin(3 * x[:n, 0]) + x[:n, 1] ** 2 + 0.05 * rng.randn(n)
    return x, y, np.arange(N_MAX) < n


def _configs(**kw):
    return JGPConfig(kernel="matern52", **kw), GPConfig(kernel="matern52", **kw)


def _raw_j(raw):
    return JG.GPParams(*(jnp.asarray(np.asarray(a)) for a in raw))


def _to_torch(raw_j):
    return C.gp_params_from_numpy(jax.tree.map(np.asarray, raw_j))


def _assert_raw_close(raw_t, raw_j, rtol=RTOL):
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(raw_t, name).numpy(), np.asarray(getattr(raw_j, name)),
                                   rtol=rtol, atol=1e-10, err_msg=name)


def _restart_uniforms(key, n, d_eff):
    """The [0, 1) draws behind ``turbojax.gp.sample_restart_params(key, ...)``,
    in the port's column order."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (n, d_eff), jnp.float64)),
                           np.asarray(jax.random.uniform(k2, (n,), jnp.float64))[:, None],
                           np.asarray(jax.random.uniform(k3, (n,), jnp.float64))[:, None]], axis=1)


@pytest.mark.parametrize("use_ard", [True, False])
def test_sample_restart_params_with_injected_uniforms_matches_jax(use_ard):
    jcfg, tcfg = _configs(use_ard=use_ard)
    key = jax.random.key(4)
    ref = JG.sample_restart_params(key, D, jcfg, 5, jnp.float64)
    u = _restart_uniforms(key, 5, D if use_ard else 1)
    got = TG.sample_restart_params(D, tcfg, 5, dtype=torch.float64, uniforms=torch.as_tensor(u))
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-12, atol=1e-12)
    drawn = TG.sample_restart_params(D, tcfg, 5, torch.Generator().manual_seed(0), torch.float64)
    assert drawn.raw_lengthscale.shape == (5, D if use_ard else 1) and bool(TG._finite_rows(drawn).all())
    with pytest.raises(ValueError):
        TG.sample_restart_params(D, tcfg, 4, dtype=torch.float64, uniforms=torch.as_tensor(u))


@pytest.mark.parametrize("prior", ["none", "dimscaled"])
def test_log_prior_matches_jax(prior, rng):
    jcfg, tcfg = _configs(fit_prior=prior)
    raws = JG.GPParams(raw_lengthscale=rng.randn(4, D), raw_outputscale=rng.randn(4), raw_noise=rng.randn(4) - 2.0,
                       raw_mean=np.zeros(4))
    ref = jax.vmap(lambda r: JG.log_prior(r, D, jcfg))(_raw_j(raws))
    got = TG.log_prior(C.gp_params_from_numpy(raws), D, tcfg)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    one = TG.log_prior(TG.GPParams(*(a[0] for a in C.gp_params_from_numpy(raws))), D, tcfg)
    np.testing.assert_allclose(float(one), float(ref[0]), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        TG.log_prior(C.gp_params_from_numpy(raws), D, dataclasses.replace(tcfg, fit_prior="horseshoe"))


@pytest.mark.parametrize("prior", ["none", "dimscaled"])
def test_adam_restart_lanes_match_jax(prior):
    """Three lanes from JAX's restart inits, as one batch: each equals JAX's
    ``_fit_one`` from the same init."""
    x, y, mask = _data(0)
    jcfg, tcfg = _configs(fit_optimizer="adam", fit_lr=0.05, fit_maxiter=15, fit_prior=prior)
    ys = JT.standardize(jnp.asarray(y), jnp.asarray(mask))[0]
    inits = JG.sample_restart_params(jax.random.key(1), D, jcfg, 3, jnp.float64)
    raw_j, loss_j = jax.vmap(lambda r: JG._fit_one(r, jnp.asarray(x), ys, jnp.asarray(mask), jcfg))(inits)
    stats = {}
    raw_t, loss_t = TG._fit_one(_to_torch(inits), torch.as_tensor(x), torch.as_tensor(np.asarray(ys)),
                                torch.as_tensor(mask), tcfg, stats)
    _assert_raw_close(raw_t, raw_j)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=RTOL)
    assert stats["loss_evals"] == 15 and stats["steps"].tolist() == [15, 15, 15]


@pytest.mark.parametrize("ftol", [1e-30, 2e-3, 5e-2])
def test_fit_ftol_stops_each_lane_where_jax_stops(ftol):
    """The early stop per lane: the final raw values equal JAX's, and the
    lane's step count k is JAX's: JAX's fixed-trip trainer run for k steps
    gives the same iterate, and an unreachable tolerance runs all steps."""
    x, y, mask = _data(2)
    maxiter = 24
    jcfg, tcfg = _configs(fit_optimizer="adam", fit_lr=0.05, fit_maxiter=maxiter, fit_ftol=ftol)
    ys = JT.standardize(jnp.asarray(y), jnp.asarray(mask))[0]
    inits = JG.sample_restart_params(jax.random.key(3), D, jcfg, 3, jnp.float64)
    stats = {}
    raw_t, loss_t = TG._fit_one(_to_torch(inits), torch.as_tensor(x), torch.as_tensor(np.asarray(ys)),
                                torch.as_tensor(mask), tcfg, stats)
    steps = stats["steps"].tolist()
    for lane in range(3):
        init = jax.tree.map(lambda a: a[lane], inits)
        raw_j, loss_j = JG._fit_one(init, jnp.asarray(x), ys, jnp.asarray(mask), jcfg)
        lane_t = TG.GPParams(*(a[lane] for a in raw_t))
        _assert_raw_close(lane_t, raw_j)
        np.testing.assert_allclose(float(loss_t[lane]), float(loss_j), rtol=RTOL)
        fixed = dataclasses.replace(jcfg, fit_ftol=0.0, fit_maxiter=steps[lane])
        raw_k, _ = JG._fit_one(init, jnp.asarray(x), ys, jnp.asarray(mask), fixed)
        _assert_raw_close(lane_t, raw_k)
    warmup = maxiter // 4
    if ftol == 1e-30:
        assert steps == [maxiter] * 3
    else:
        assert all(warmup <= k <= maxiter for k in steps)
    if ftol == 5e-2:
        assert min(steps) == warmup and len(set(steps)) > 1  # lanes stop on their own, the first right after the warm-up
    assert stats["loss_evals"] == max(steps)


@pytest.mark.parametrize("warm", ["none", "finite", "nan"])
def test_fit_gp_adam_restarts_match_jax(warm):
    x, y, mask = _data(5)
    kw = dict(fit_optimizer="adam", fit_lr=0.05, fit_maxiter=12, fit_maxiter_warm=8, fit_restarts=3)
    jcfg, tcfg = _configs(**kw)
    key = jax.random.key(6)
    warm_np = None
    if warm != "none":
        warm_np = JG.GPParams(raw_lengthscale=np.array([0.2, -0.4, 0.1]), raw_outputscale=np.asarray(0.5),
                              raw_noise=np.asarray(-3.0), raw_mean=np.asarray(0.0))
        if warm == "nan":
            warm_np = warm_np._replace(raw_noise=np.asarray(np.nan))
    js = JG.fit_gp(key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg,
                   warm_start=None if warm_np is None else _raw_j(warm_np))
    ts = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask), tcfg,
                   warm_start=None if warm_np is None else C.gp_params_from_numpy(warm_np),
                   restart_uniforms=torch.as_tensor(_restart_uniforms(key, 2, D)))
    _assert_raw_close(ts.raw, js.raw)
    np.testing.assert_allclose(ts.chol.numpy(), np.asarray(js.chol), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(ts.y_mean), float(js.y_mean), rtol=1e-12)


def test_fit_gp_batched_restarts_equal_per_fit_restarts():
    """Two fits on a leading axis (one per trust region), their restarts one
    batch of lanes: each equals the fit run alone with its own uniforms."""
    problems = [_data(7), _data(8, n=12)]
    _, tcfg = _configs(fit_optimizer="adam", fit_lr=0.05, fit_maxiter=8, fit_restarts=3)
    xs = torch.as_tensor(np.stack([p[0] for p in problems]))
    ys = torch.as_tensor(np.stack([p[1] for p in problems]))
    masks = torch.as_tensor(np.stack([p[2] for p in problems]))
    u = torch.rand((2, 2, D + 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    both = TG.fit_gp(xs, ys, masks, tcfg, restart_uniforms=u)
    for i in range(2):
        alone = TG.fit_gp(xs[i], ys[i], masks[i], tcfg, restart_uniforms=u[i])
        lane = TG.state_lane(both, i)
        for a, b in zip(lane.raw, alone.raw):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(lane.chol.numpy(), alone.chol.numpy(), rtol=1e-12, atol=1e-14)


def test_lbfgs_lanes_reach_jax_final_loss():
    """From the same inits, lane by lane: final −mll/n ≤ JAX's + 1e-3."""
    x, y, mask = _data(9)
    jcfg, tcfg = _configs(fit_optimizer="lbfgs", fit_maxiter=40)
    ys = JT.standardize(jnp.asarray(y), jnp.asarray(mask))[0]
    rand = JG.sample_restart_params(jax.random.key(10), D, jcfg, 3, jnp.float64)
    inits = jax.tree.map(lambda d0, r: jnp.concatenate([d0[None], r]), JG.default_params(D, jcfg, jnp.float64), rand)
    _, loss_j = jax.vmap(lambda r: JG._fit_one(r, jnp.asarray(x), ys, jnp.asarray(mask), jcfg))(inits)
    stats = {}
    raw_t, loss_t = TG._fit_one(_to_torch(inits), torch.as_tensor(x), torch.as_tensor(np.asarray(ys)),
                                torch.as_tensor(mask), tcfg, stats)
    assert bool(TG._finite_rows(raw_t).all())
    assert np.all(loss_t.numpy() <= np.asarray(loss_j) + 1e-3), (loss_t.numpy(), np.asarray(loss_j))
    # the reported loss is the loss at the returned params
    check = -TG.mll(raw_t, torch.as_tensor(x), torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask), tcfg) / 15.0
    np.testing.assert_allclose(loss_t.numpy(), check.numpy(), rtol=1e-10)
    # every probe is one batched evaluation: at most (1 + linesearch cap) per iteration, plus the first
    assert 4 <= stats["loss_evals"] <= 1 + 40 * tcfg.fit_linesearch_steps
    print("lbfgs loss evaluations:", stats["loss_evals"], "iterations per lane:", stats["steps"].tolist())
    # lanes never read each other: lane 2 alone takes the same path
    alone, loss_alone = TG._fit_one(TG.GPParams(*(a[2] for a in _to_torch(inits))), torch.as_tensor(x),
                                    torch.as_tensor(np.asarray(ys)), torch.as_tensor(mask), tcfg)
    np.testing.assert_allclose(float(loss_alone), float(loss_t[2]), rtol=1e-9)
    for a, b in zip(alone, raw_t):
        np.testing.assert_allclose(a.numpy(), b[2].numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_fit_recovers_hypers(rng, optimizer):
    """Data drawn from a known GP: the fitted MLL is competitive with the
    MLL at the true hypers (the JAX package's own test, for the port)."""
    n, d, n_max = 60, 2, 64
    x = rng.rand(n, d)
    true_cfg = GPConfig(kernel="matern52", fit_optimizer=optimizer, fit_maxiter=60, fit_restarts=3)

    def raw_of(ls, s, nz):
        lo, hi = true_cfg.lengthscale_bounds
        so, sh = true_cfg.outputscale_bounds
        no, nh = true_cfg.noise_bounds
        t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
        return TG.GPParams(TT.unconstrain(t([ls] * d), lo, hi), TT.unconstrain(t(s), so, sh),
                           TT.unconstrain(t(nz), no, nh), t(0.0))

    x_buf = torch.zeros((n_max, d), dtype=torch.float64)
    x_buf[:n] = torch.as_tensor(x)
    mask = torch.arange(n_max) < n
    k = TG._kernel_matrix(TG.constrain_params(raw_of(0.3, 1.0, 1e-4), true_cfg), x_buf[:n], x_buf[:n], true_cfg, True)
    y_buf = torch.zeros(n_max, dtype=torch.float64)
    y_buf[:n] = torch.linalg.cholesky(k) @ torch.as_tensor(rng.randn(n))
    stats = {}
    state = TG.fit_gp(x_buf, y_buf, mask, true_cfg, generator=torch.Generator().manual_seed(0), stats=stats)
    y_std, _, y_sd = TT.standardize(y_buf, mask)
    fitted = float(TG.mll(state.raw, x_buf, y_std, mask, true_cfg))
    true = float(TG.mll(raw_of(0.3, 1.0 / float(y_sd) ** 2, 1e-4), x_buf, y_std, mask, true_cfg))
    assert fitted > true - 3.0
    ls = state.params["lengthscale"].numpy()
    assert np.all(ls > 0.03) and np.all(ls < 5.0)
    assert stats["loss_evals"] >= 1


@pytest.mark.parametrize("warm", ["finite", "nan"])
def test_grid_polish_both_matches_jax_and_never_loses_mll(warm):
    x, y, mask = _data(11)
    kw = dict(fit_optimizer="grid+adam", fit_lr=0.1, fit_maxiter_warm=10)
    jcfg, tcfg = _configs(grid_polish_both=True, **kw)
    warm_np = JG.GPParams(raw_lengthscale=np.array([0.3, -0.2, 0.4]), raw_outputscale=np.asarray(-0.5),
                          raw_noise=np.asarray(-3.0 if warm == "finite" else np.nan), raw_mean=np.asarray(0.0))
    js = JG.fit_gp(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg,
                   warm_start=_raw_j(warm_np))
    ts = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask), tcfg,
                   warm_start=C.gp_params_from_numpy(warm_np))
    _assert_raw_close(ts.raw, js.raw)
    ys = TT.standardize(torch.as_tensor(y), torch.as_tensor(mask))[0]
    both = float(TG.mll(ts.raw, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg))
    grid_only = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask),
                          dataclasses.replace(tcfg, fit_optimizer="grid"))
    assert both >= float(TG.mll(grid_only.raw, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg)) - 1e-9
    # two polish lanes per fit, 10 steps each, as one batch
    stats = {}
    TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask), tcfg,
              warm_start=C.gp_params_from_numpy(warm_np), stats=stats)
    assert stats["loss_evals"] == 10 and stats["steps"].shape == (2,)


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam"])
def test_fit_gp_never_returns_nan_hypers(rng, optimizer):
    """A poisoned warm start plus near-duplicate rows that defeat
    factorizations inside the probes: the fitted hypers stay finite."""
    n, d, n_max = 24, 2, 32
    base = rng.rand(4, d)
    x_buf = torch.zeros((n_max, d), dtype=torch.float64)
    x_buf[:n] = torch.as_tensor(np.repeat(base, 6, axis=0) + 1e-7 * rng.randn(n, d))
    y_buf = torch.zeros(n_max, dtype=torch.float64)
    y_buf[:n] = torch.as_tensor(np.repeat(rng.randn(4), 6) + 1e-7 * rng.randn(n))
    mask = torch.arange(n_max) < n
    cfg = GPConfig(fit_optimizer=optimizer, fit_maxiter=15, fit_restarts=2)
    nan_warm = TG.GPParams(*(torch.full_like(a, float("nan")) for a in TG.default_params(d, cfg, torch.float64)))
    state = TG.fit_gp(x_buf, y_buf, mask, cfg, warm_start=nan_warm, generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(a).all()) for a in state.raw), "fit_gp returned non-finite hypers"
    assert bool(torch.isfinite(state.chol).all())


def test_lbfgs_probe_with_a_failed_factorization_keeps_the_lane_finite():
    """The noise may go negative here, so probes along the search direction
    hit indefinite matrices: such a probe's loss is +inf for its lane, the
    search shortens the step, and the lane ends finite and no worse than its
    start; all lanes failing falls back to the base init."""
    x, y, mask = _data(0)
    _, tcfg = _configs(fit_optimizer="lbfgs", fit_maxiter=12, noise_bounds=(-1.0, 0.2), noise_floor=-1.0)
    ys = TT.standardize(torch.as_tensor(y), torch.as_tensor(mask))[0]
    raw0 = TG.default_params(D, tcfg, torch.float64)
    start = float(-TG.mll(raw0, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg) / 15.0)
    raw, loss = TG._fit_one(raw0, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg)
    assert np.isfinite(float(loss)) and float(loss) <= start and all(bool(torch.isfinite(a).all()) for a in raw)
    bad = TG.GPParams(*(a.clone() for a in raw0))._replace(raw_noise=torch.tensor(-30.0, dtype=torch.float64))
    start_bad = TG.mll(bad, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg)
    assert not bool(torch.isfinite(start_bad))  # σ² ≈ −1: the factorization fails at the init itself
    raw_b, loss_b = TG._fit_one(bad, torch.as_tensor(x), ys, torch.as_tensor(mask), tcfg)
    assert float(loss_b) == float("inf") and all(torch.equal(a, b) for a, b in zip(raw_b, bad))
    state = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask),
                      dataclasses.replace(tcfg, fit_restarts=1), warm_start=bad)
    assert all(torch.equal(a, b) for a, b in zip(state.raw, bad))  # all restarts failed: the finite base is kept
