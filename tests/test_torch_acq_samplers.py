"""The port's f64, RFF and pathwise Thompson samplers and the local
candidate pool against ``turbojax`` in float64, JAX's draws injected.

``_state_f64``, ``thompson_samples(dtype="float64")``, ``rff_paths``,
``pathwise_paths`` and ``tr_candidates(local_frac > 0)`` match to f64
round-off (rtol 1e-10). From a float32 state the residual r = L(Lᵀα) is
recovered in float32 by both packages, whose summation orders differ, so
there α matches at the f32 residual's level (rtol 1e-4) while the buffers,
hypers and factor match at 1e-10. ``rff_frequencies`` (its Matérn branch
draws Gamma(ν) as ½ a chi-square of 2ν normals) is held by the moment
checks of ``tests/test_acq.py``, and both samplers' calibration by the
variance-starvation tests there, at their sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import acq as JA
from turbojax import gp as JG
from turbojax import sampling as JS
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import acq as TA
from turbojax_torch import convert as C
from turbojax_torch import gp as TG
from turbojax_torch import sampling as TS
from turbojax_torch import transforms as TT
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-10, atol=1e-12)
N_MAX, N, D = 48, 40, 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _state_pair(rng, dtype=np.float64, kernel="matern52"):
    x = np.zeros((N_MAX, D), dtype)
    x[:N] = rng.rand(N, D)
    y = np.zeros(N_MAX, dtype)
    y[:N] = np.cos(3 * x[:N, 0]) + 0.05 * rng.randn(N)
    mask = np.arange(N_MAX) < N
    jcfg = JGPConfig(kernel=kernel, fit_optimizer="grid")
    tcfg = GPConfig(kernel=kernel, fit_optimizer="grid")
    js = JG.fit_gp(jax.random.key(0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jcfg)
    ts = C.gp_state_from_numpy(jax.tree.map(np.asarray, js), dtype=torch.float64 if dtype == np.float64 else torch.float32)
    return js, ts, jcfg, tcfg


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_state_f64_matches_jax(dtype, rng):
    js, ts, jcfg, tcfg = _state_pair(rng, np.dtype(dtype).type)
    want = JA._state_f64(js, jcfg)
    got = TA._state_f64(ts, tcfg)
    for name in ("x_buf", "chol", "y_mean", "y_std"):
        assert getattr(got, name).dtype == torch.float64
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **F64, err_msg=name)
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]), **F64, err_msg=k)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    resid = np.asarray(js.chol @ (js.chol.T @ js.alpha))
    np.testing.assert_allclose(TA._residual(ts).numpy()[:N], resid[:N], rtol=1e-5 if dtype == "float32" else 1e-10,
                               atol=1e-5 if dtype == "float32" else 1e-12)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else F64
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), **tol)


@pytest.mark.parametrize("chunk", [None, 16])
def test_thompson_samples_f64_with_injected_normals(chunk, rng):
    """The f64 lane from an f64 state with JAX's per-chunk normals; the
    result comes back in the candidates' dtype."""
    js, ts, jcfg, tcfg = _state_pair(rng)
    xs = rng.rand(48, D)
    q, key = 5, jax.random.key(3)
    want = np.asarray(JA.thompson_samples(key, js, jnp.asarray(xs), q, jcfg, chunk, dtype="float64"))
    if chunk is None:
        z = np.asarray(jax.random.normal(key, (q, 48), jnp.float64))
    else:
        keys = jax.random.split(key, 48 // chunk)
        z = np.concatenate([np.asarray(jax.random.normal(k, (q, chunk), jnp.float64)) for k in keys], axis=1)
    got = TA.thompson_samples(ts, _t(xs), q, tcfg, chunk, normals=_t(z), dtype="float64")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)
    picked, vals = TA.thompson_select(ts, _t(xs).float(), q, tcfg, chunk, normals=_t(z),
                                      dtype="float64")
    assert picked.dtype == torch.float32 and vals.dtype == torch.float32  # back in the working dtype
    with pytest.raises(ValueError, match="ts_dtype"):
        TA.thompson_samples(ts, _t(xs), q, tcfg, normals=_t(z), dtype="float16")


def test_rff_frequencies_distributions():
    """The moment checks of tests/test_acq.py: RBF a standard normal,
    Matérn-5/2 a t with 5 degrees of freedom (std sqrt(5/3)); phases in
    [0, 2π). Matérn-3/2's t3 has a median |Ω| of 0.765 (a quantile of t3)."""
    g = torch.Generator().manual_seed(0)
    om_rbf, b = TA.rff_frequencies(3, 4000, "rbf", g, torch.float64)
    assert om_rbf.shape == (4000, 3) and b.shape == (4000,)
    assert abs(float(om_rbf.mean())) < 0.05 and abs(float(om_rbf.std()) - 1.0) < 0.05
    assert float(b.min()) >= 0 and float(b.max()) < 2 * np.pi
    om_m52, _ = TA.rff_frequencies(3, 4000, "matern52", g, torch.float64)
    assert abs(float(om_m52.std()) - np.sqrt(5.0 / 3.0)) < 0.1
    om_m32, _ = TA.rff_frequencies(3, 4000, "matern32", g, torch.float64)
    assert abs(float(om_m32.abs().median()) - 0.765) < 0.05
    om_m12, _ = TA.rff_frequencies(3, 4000, "matern12", g, torch.float64)
    assert abs(float(om_m12.abs().median()) - 1.0) < 0.08  # Cauchy: median |Ω| = 1
    with pytest.raises(ValueError):
        TA.rff_frequencies(3, 8, "periodic", g)


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_rff_paths_with_injected_draws_match_jax(kernel, rng):
    js, ts, jcfg, tcfg = _state_pair(rng, kernel=kernel)
    xs = rng.rand(30, D)
    n_paths, m, key = 6, 64, jax.random.key(5)
    want = np.asarray(JA.rff_paths(key, js, jnp.asarray(xs), n_paths, jcfg, m))
    kf, kw = jax.random.split(key)
    omega, b = JA.rff_frequencies(kf, D, m, kernel, jnp.float64)
    z = jax.random.normal(kw, (n_paths, m), jnp.float64)
    draws = TA.Draws(omega=_t(omega), b=_t(b), weights=_t(z))
    got = TA.rff_paths(ts, _t(xs), n_paths, tcfg, m, draws=draws)
    np.testing.assert_allclose(got.numpy(), want, **F64)
    idx, _ = TA.select_q_batch(got)
    picked, _ = TA.rff_thompson_select(ts, _t(xs), n_paths, tcfg, m, draws=draws)
    np.testing.assert_array_equal(picked.numpy(), xs[idx.numpy()])


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_pathwise_paths_with_injected_draws_match_jax(kernel, rng):
    js, ts, jcfg, tcfg = _state_pair(rng, kernel=kernel)
    xs = rng.rand(30, D)
    n_paths, m, key = 6, 64, jax.random.key(6)
    want = np.asarray(JA.pathwise_paths(key, js, jnp.asarray(xs), n_paths, jcfg, m))
    kf, kw, ke = jax.random.split(key, 3)
    omega, b = JA.rff_frequencies(kf, D, m, kernel, jnp.float64)
    draws = TA.Draws(omega=_t(omega), b=_t(b), weights=_t(jax.random.normal(kw, (n_paths, m), jnp.float64)),
                     eps=_t(jax.random.normal(ke, (n_paths, N_MAX), jnp.float64)))
    got = TA.pathwise_paths(ts, _t(xs), n_paths, tcfg, m, draws=draws)
    np.testing.assert_allclose(got.numpy(), want, **F64)
    values = TA.thompson_values(ts, _t(xs), n_paths, tcfg, "pathwise", n_features=m, draws=draws)
    np.testing.assert_array_equal(values.numpy(), got.numpy())
    picked, _ = TA.pathwise_thompson_select(ts, _t(xs), n_paths, tcfg, m, draws=draws)
    np.testing.assert_array_equal(picked.numpy(), xs[TA.select_q_batch(got)[0].numpy()])
    with pytest.raises(ValueError, match="shape"):
        TA.pathwise_paths(ts, _t(xs), n_paths, tcfg, m, draws=draws._replace(eps=draws.eps[:, :5]))


def test_thompson_values_dispatch(rng):
    _, ts, _, tcfg = _state_pair(rng)
    xs = _t(rng.rand(20, D))
    g = torch.Generator().manual_seed(1)
    for sampler in ("exact", "rff", "pathwise"):
        values = TA.thompson_values(ts, xs, 3, tcfg, sampler, n_features=32, generator=g)
        assert values.shape == (3, 20) and bool(torch.isfinite(values).all())
    with pytest.raises(ValueError, match="ts_sampler"):
        TA.thompson_values(ts, xs, 3, tcfg, "sobol", generator=g)


@pytest.mark.parametrize("dim", [4, 30])
def test_tr_candidates_local_frac_matches_jax(dim, rng):
    key = jax.random.key(11)
    center = rng.rand(dim)
    ls = rng.uniform(0.05, 1.5, dim)
    length, n_cand, frac, sigma = 0.4, 128, 0.3, 0.25
    ref = np.asarray(JS.tr_candidates(key, jnp.asarray(center), jnp.asarray(length), jnp.asarray(ls), n_cand,
                                      local_frac=frac, local_sigma=sigma))
    n_local = int(round(frac * n_cand))
    ks, km, kl = jax.random.split(key, 3)
    shift = np.asarray(jax.random.bits(ks, (dim,), jnp.uint32) >> 2).astype(np.int64)
    mask = np.asarray(JS.perturbation_mask(km, n_cand, dim))
    local = np.asarray(jax.random.normal(kl, (n_local, dim), jnp.float64))
    length_t = torch.tensor(length, dtype=torch.float64)
    got = TS.tr_candidates(torch.as_tensor(center), length_t, torch.as_tensor(ls), n_cand, local_frac=frac,
                           shift=torch.as_tensor(shift), mask=torch.tensor(mask), local_sigma=sigma,
                           local_normals=torch.as_tensor(local))
    np.testing.assert_allclose(got.numpy(), ref, **F64)
    g = torch.Generator().manual_seed(0)
    drawn = TS.tr_candidates(torch.as_tensor(center), length_t, torch.as_tensor(ls), n_cand, g, frac,
                             local_sigma=sigma).numpy()
    half = ls / ls.mean()
    half = half / np.exp(np.log(half).mean()) * length / 2
    assert drawn.shape == (n_cand, dim)
    assert np.all(drawn >= np.clip(center - half, 0, 1) - 1e-12) and np.all(drawn <= np.clip(center + half, 0, 1) + 1e-12)
    # the local pool sits closer to the center than the Sobol rows
    spread = np.abs(drawn - center).max(axis=1)
    assert spread[-n_local:].mean() < spread[:-n_local].mean()


def _starvation_problem(rng, n=96, n_max=128, m_cand=64):
    x = np.sort(rng.rand(n))[:, None]
    y = np.sin(6 * x[:, 0])  # a deterministic objective (the TuRBO regime)
    cfg = GPConfig(kernel="matern52", jitter=0.0)
    x_buf = torch.zeros((n_max, 1), dtype=torch.float64)
    x_buf[:n] = torch.as_tensor(x)
    y_buf = torch.zeros(n_max, dtype=torch.float64)
    y_buf[:n] = torch.as_tensor(y)
    mask = torch.arange(n_max) < n
    xs = torch.as_tensor(rng.rand(m_cand, 1))

    def state(noise):
        raw = TG.GPParams(
            raw_lengthscale=TT.unconstrain(torch.full((1,), 0.2, dtype=torch.float64), *cfg.lengthscale_bounds),
            raw_outputscale=TT.unconstrain(torch.tensor(1.0, dtype=torch.float64), *cfg.outputscale_bounds),
            raw_noise=TT.unconstrain(torch.tensor(noise, dtype=torch.float64), *cfg.noise_bounds),
            raw_mean=torch.tensor(0.0, dtype=torch.float64),
        )
        return TG.make_gp_state(x_buf, y_buf, mask, raw, cfg)

    return state, xs, cfg


def test_rff_variance_starvation_characterization(rng):
    """tests/test_acq.py's characterization at its size (n = 96, 64
    candidates, 4000 paths): near the noise floor the RFF paths under-disperse badly, at
    σ² = 0.1 they are accurate, and fewer features do not help."""
    state_at, xs, cfg = _starvation_problem(rng)

    def signed_err(noise, n_features):
        state = state_at(noise)
        _, var_exact = TG.gp_posterior(state, xs, cfg)
        paths = TA.rff_paths(state, xs, 4000, cfg, n_features, torch.Generator().manual_seed(0))
        var_emp = paths.var(dim=0, unbiased=False)
        return float(((var_emp - var_exact) / (var_exact + 1e-12)).median())

    starved = signed_err(1e-4, 1024)
    assert starved < -0.4, f"expected severe starvation at σ²=1e-4: {starved:+.3f}"
    noisy = signed_err(1e-1, 1024)
    assert abs(noisy) < 0.15, f"rff should be accurate at σ²=0.1: {noisy:+.3f}"
    assert signed_err(1e-4, 128) <= starved + 0.02


def test_pathwise_no_variance_starvation(rng):
    """tests/test_acq.py's check at its size: at the noise floor that
    starves RFF, pathwise paths stay calibrated, and their mean is the
    exact posterior mean."""
    state_at, xs, cfg = _starvation_problem(rng)
    state = state_at(1e-4)
    mu_exact, var_exact = TG.gp_posterior(state, xs, cfg)
    n_paths = 4000
    paths = TA.pathwise_paths(state, xs, n_paths, cfg, 1024, torch.Generator().manual_seed(0))
    err = float(((paths.var(dim=0, unbiased=False) - var_exact) / (var_exact + 1e-12)).median())
    assert abs(err) < 0.2, f"pathwise should stay calibrated at the noise floor: {err:+.3f}"
    np.testing.assert_allclose(paths.mean(dim=0).numpy(), mu_exact.numpy(),
                               atol=4 * float(var_exact.max().sqrt()) / np.sqrt(n_paths) + 0.02)
