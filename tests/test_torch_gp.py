"""The port's GP (``turbojax_torch.gp``) against ``turbojax.gp`` in f64 on
the same numpy-seeded masked buffers. Tolerances: the cached factorization
and the grid's hypers and MLLs rtol 1e-9 / atol 1e-12 (deterministic f64;
the grid argmax must be equal); posterior mean and variance rtol 1e-7, inside
the rtol 1e-5 that the posterior is held to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import gp as JG
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import convert as C
from turbojax_torch import gp as TG
from turbojax_torch import linalg as TL
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)
POST = dict(rtol=1e-7, atol=1e-10)
N_MAX, N, D = 40, 29, 5
GP_FIELDS = TG.GPParams._fields


def _problem(rng):
    x = np.zeros((N_MAX, D))
    x[:N] = rng.rand(N, D)
    y = np.zeros(N_MAX)
    y[:N] = np.sin(4 * x[:N, 0]) + x[:N, 1] ** 2 + 0.05 * rng.randn(N)
    return x, y, np.arange(N_MAX) < N


def _configs(**kw):
    return JGPConfig(kernel="matern52", fit_optimizer="grid", **kw), GPConfig(
        kernel="matern52", fit_optimizer="grid", **kw)


def _raw(rng):
    return JG.GPParams(
        raw_lengthscale=jnp.asarray(rng.randn(D) * 0.5),
        raw_outputscale=jnp.asarray(0.3), raw_noise=jnp.asarray(-2.0), raw_mean=jnp.asarray(0.0),
    )


def _states(rng, y_warp="none"):
    x, y, mask = _problem(rng)
    jcfg, tcfg = _configs(y_warp=y_warp)
    raw = _raw(rng)
    js = JG.make_gp_state(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), raw, jcfg)
    ts = TG.make_gp_state(torch.as_tensor(x), torch.as_tensor(y), TL.row_mask(N_MAX, N),
                          C.gp_params_from_numpy(jax.tree.map(np.asarray, raw)), tcfg)
    return js, ts, jcfg, tcfg


@pytest.mark.parametrize("y_warp", ["none", "bilog"])
def test_make_gp_state_matches_jax(y_warp, rng):
    js, ts, _, _ = _states(rng, y_warp)
    for name in ("chol", "alpha", "y_mean", "y_std"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), **F64, err_msg=name)
    for k in ("lengthscale", "outputscale", "noise", "mean"):
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), **F64, err_msg=k)


def test_grid_fit_matches_jax(rng):
    x, y, mask = _problem(rng)
    jcfg, tcfg = _configs()
    js = JG.fit_gp(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg)
    ts = TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), TL.row_mask(N_MAX, N), tcfg)
    for name in GP_FIELDS:
        np.testing.assert_allclose(getattr(ts.raw, name).numpy(), np.asarray(getattr(js.raw, name)), **F64, err_msg=name)
    np.testing.assert_allclose(ts.chol.numpy(), np.asarray(js.chol), **F64)
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), **F64)

    # the argmax over the same 15 rows, scored one batch against JAX's vmap
    y_std, _, _ = TG.T.standardize(torch.as_tensor(y), torch.as_tensor(mask))
    grid_t = TG.grid_params(D, tcfg, torch.float64)
    grid_j = JG.grid_params(D, jcfg, jnp.float64)
    for name in GP_FIELDS:
        np.testing.assert_allclose(getattr(grid_t, name).numpy(), np.asarray(getattr(grid_j, name)), **F64)
    m_t = TG.mll(grid_t, torch.as_tensor(x), y_std, torch.as_tensor(mask), tcfg)
    m_j = jax.vmap(lambda r: JG.mll(r, jnp.asarray(x), jnp.asarray(y_std.numpy()), jnp.asarray(mask), jcfg))(grid_j)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **F64)
    assert int(torch.argmax(m_t)) == int(jnp.argmax(m_j))


def test_grid_rows_one_by_one_equal_the_batch(rng, monkeypatch):
    x, y, mask = _problem(rng)
    _, tcfg = _configs()
    args = (torch.as_tensor(x), torch.as_tensor(y), TL.row_mask(N_MAX, N), tcfg)
    batched = TG.fit_gp(*args)
    monkeypatch.setattr(TG, "_GRID_VMAP_BUDGET_BYTES", 0)
    one_by_one = TG.fit_gp(*args)
    for name in GP_FIELDS:
        np.testing.assert_array_equal(getattr(one_by_one.raw, name).numpy(), getattr(batched.raw, name).numpy())
    np.testing.assert_allclose(one_by_one.chol.numpy(), batched.chol.numpy(), **F64)


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("include_noise", [False, True])
def test_gp_posterior_matches_jax(chunk, include_noise, rng):
    js, ts, jcfg, tcfg = _states(rng)
    xs = rng.rand(64, D)
    mu_j, var_j = JG.gp_posterior(js, jnp.asarray(xs), jcfg, include_noise, chunk)
    mu_t, var_t = TG.gp_posterior(ts, torch.as_tensor(xs), tcfg, include_noise, chunk)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **POST)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), **POST)


def test_gp_posterior_auto_chunk_matches_unchunked(rng, monkeypatch):
    _, ts, _, tcfg = _states(rng)
    xs = torch.as_tensor(rng.rand(64, D))
    whole = TG.gp_posterior(ts, xs, tcfg)
    monkeypatch.setattr(TG, "_POSTERIOR_AUTO_CHUNK_BYTES", 0)  # forces chunks of 32
    auto = TG.gp_posterior(ts, xs, tcfg)
    for a, b in zip(auto, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F64)


def test_posterior_cov_matches_jax(rng):
    js, ts, jcfg, tcfg = _states(rng)
    xs = rng.rand(24, D)
    for standardized in (False, True):
        mu_j, cov_j = JG.posterior_cov(js, jnp.asarray(xs), jcfg, standardized=standardized)
        mu_t, cov_t = TG.posterior_cov(ts, torch.as_tensor(xs), tcfg, standardized=standardized)
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **POST)
        np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-7, atol=1e-10)


def test_gp_state_round_trips_through_convert(rng):
    js, ts, _, _ = _states(rng)
    back = C.gp_state_from_numpy(C.gp_state_to_numpy(ts))
    for a, b in zip(jax.tree.leaves(C.gp_state_to_numpy(back)), jax.tree.leaves(C.gp_state_to_numpy(ts))):
        np.testing.assert_array_equal(a, b)
    from_jax = C.gp_state_from_numpy(jax.tree.map(np.asarray, js))
    np.testing.assert_allclose(from_jax.chol.numpy(), ts.chol.numpy(), **F64)
    assert from_jax.mask.dtype == torch.bool


@pytest.mark.parametrize("optimizer", ["lbfgs", "adam", "grid+adam"])
def test_unported_trainers_raise(optimizer, rng):
    """The trainers off the ported paths raise; grid+adam is ported, and its
    dual polish (``grid_polish_both``) and early-stop lane are not."""
    x, y, _ = _problem(rng)
    configs = [GPConfig(fit_optimizer=optimizer)]
    if optimizer == "grid+adam":
        configs = [GPConfig(fit_optimizer=optimizer, grid_polish_both=True),
                   GPConfig(fit_optimizer=optimizer, fit_ftol=1e-3)]
    for config in configs:
        with pytest.raises(NotImplementedError):
            TG.fit_gp(torch.as_tensor(x), torch.as_tensor(y), TL.row_mask(N_MAX, N), config)
