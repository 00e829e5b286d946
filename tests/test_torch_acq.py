"""The port's acquisition functions against ``turbojax.acq`` in f64.
Thompson draws are compared with the normals injected: the port's
``thompson_samples(normals=z)`` against ``mu + z @ L.T`` built from JAX's
``posterior_cov`` and ``_robust_cov_chol``. Tolerances: EI/UCB/LCB and the
factor rtol 1e-9 / atol 1e-12; the draws rtol 1e-7 (posterior quantities);
selected indices equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import acq as JA
from turbojax import gp as JG
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import acq as TA
from turbojax_torch import convert as C
from turbojax_torch import gp as TG
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_ei_ucb_lcb_match_jax_including_zero_variance(rng):
    mu = rng.randn(50)
    var = rng.rand(50) ** 4
    var[::7] = 0.0  # the σ → 0 limit max(f* − μ, 0)
    var[3] = 1e-30
    best = 0.1
    ei_t = TA.expected_improvement(_t(mu), _t(var), _t(best))
    ei_j = JA.expected_improvement(jnp.asarray(mu), jnp.asarray(var), jnp.asarray(best))
    np.testing.assert_allclose(ei_t.numpy(), np.asarray(ei_j), **F64)
    np.testing.assert_array_equal(ei_t.numpy()[::7], np.maximum(best - mu[::7], 0.0))
    np.testing.assert_allclose(TA.lower_confidence_bound(_t(mu), _t(var), 1.5).numpy(),
                               np.asarray(JA.lower_confidence_bound(jnp.asarray(mu), jnp.asarray(var), 1.5)), **F64)
    np.testing.assert_allclose(TA.upper_confidence_bound(_t(mu), _t(var)).numpy(),
                               np.asarray(JA.upper_confidence_bound(jnp.asarray(mu), jnp.asarray(var))), **F64)


@pytest.mark.parametrize("kind", ["pd", "rank_deficient"])
def test_robust_cov_chol_matches_jax(kind, rng):
    if kind == "pd":
        a = rng.randn(12, 12)
        cov = a @ a.T / 12 + 0.1 * np.eye(12)
    else:
        a = rng.randn(12, 3)
        cov = a @ a.T - 1e-4 * np.eye(12)  # indefinite: needs a rung beyond the first
    scale = 0.7
    got = TA._robust_cov_chol(_t(cov), _t(scale)).numpy()
    ref = np.asarray(JA._robust_cov_chol(jnp.asarray(cov), jnp.asarray(scale)))
    np.testing.assert_allclose(got, ref, **F64)
    assert np.all(np.isfinite(got))


def _state_pair(rng, n_max=32, n=24, d=4):
    x = np.zeros((n_max, d))
    x[:n] = rng.rand(n, d)
    y = np.zeros(n_max)
    y[:n] = np.cos(3 * x[:n, 0]) + 0.05 * rng.randn(n)
    mask = np.arange(n_max) < n
    jcfg = JGPConfig(kernel="matern52", fit_optimizer="grid")
    tcfg = GPConfig(kernel="matern52", fit_optimizer="grid")
    js = JG.fit_gp(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg)
    ts = C.gp_state_from_numpy(jax.tree.map(np.asarray, js))
    return js, ts, jcfg, tcfg


@pytest.mark.parametrize("chunk", [None, 16])
def test_thompson_samples_with_injected_normals(chunk, rng):
    js, ts, jcfg, tcfg = _state_pair(rng)
    xs = rng.rand(48, 4)
    q = 5
    z = rng.randn(q, 48)
    got = TA.thompson_samples(ts, _t(xs), q, tcfg, chunk, normals=_t(z)).numpy()
    scale = js.params["outputscale"] * js.y_std**2
    parts = []
    for c0, c1 in ([(0, 48)] if chunk is None else [(i, i + chunk) for i in range(0, 48, chunk)]):
        mu, cov = JG.posterior_cov(js, jnp.asarray(xs[c0:c1]), jcfg)
        l_cov = JA._robust_cov_chol(cov, scale)
        parts.append(np.asarray(mu)[None] + z[:, c0:c1] @ np.asarray(l_cov).T)
    np.testing.assert_allclose(got, np.concatenate(parts, axis=1), rtol=1e-7, atol=1e-9)


def test_select_q_batch_with_nan_rows_matches_jax(rng):
    s = rng.randn(6, 30)
    s[1] = np.nan  # a failed factor's row: never selectable
    s[2, :10] = np.inf
    s[4, 5] = np.nan
    s[5, :] = s[0]  # same draws as row 0: argmin without replacement picks another
    idx_t, val_t = TA.select_q_batch(_t(s))
    idx_j, val_j = JA.select_q_batch(jnp.asarray(s))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    assert len(set(idx_t.tolist())) == 6
    valid = np.arange(30) % 2 == 0
    idx_t, _ = TA.select_q_batch(_t(s), _t(valid))
    idx_j, _ = JA.select_q_batch(jnp.asarray(s), jnp.asarray(valid))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_thompson_select_returns_selected_candidates(rng):
    _, ts, _, tcfg = _state_pair(rng)
    xs = _t(rng.rand(40, 4))
    g = torch.Generator().manual_seed(3)
    picked, vals = TA.thompson_select(ts, xs, 4, tcfg, generator=g)
    assert picked.shape == (4, 4) and bool(torch.isfinite(vals).all())
    assert len({tuple(r) for r in picked.tolist()}) == 4
    assert all(any(torch.equal(p, x) for x in xs) for p in picked)
