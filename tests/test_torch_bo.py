"""Plain BO of the port against ``turbojax.bo``.

From one JAX carry (float64): ``_state_from_carry``, ``_append_batch`` in
both Cholesky modes and ``_suggest`` for EI, LCB and Thompson sampling with
JAX's candidates and normals injected, choosing the same points; tied scores
resolve to the lowest index on both sides. A 10-iteration run of config 1
(fixed hypers, incremental Cholesky) is fed the init design and candidates
replayed from JAX's key chain (``_bo_init``: split 3 → LHS; each step: split
3 → ``_suggest``: split 3 → Sobol) and must visit the same points (JAX runs
that loop in float32, the port here in float64: the points are candidates,
so they agree exactly while the same candidate wins; 1e-8). Reduced configs
1 and 2 end to end under the thresholds of ``tests/test_configs.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from configs import registry as JR
from turbojax import benchmarks as JB
from turbojax import bo as JBO
from turbojax import gp as JG
from turbojax import linalg as JL
from turbojax import sampling as JS
from turbojax import transforms as JT
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import acq as TA
from turbojax_torch import benchmarks as TB
from turbojax_torch import bo as TBO
from turbojax_torch import convert as C
from turbojax_torch import gp as TG
from turbojax_torch import registry as TR
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

N_MAX, N, D, Q, N_CAND = 24, 14, 3, 3, 48
F64 = dict(rtol=1e-9, atol=1e-11)


def _carries(y_warp="none", seed=0):
    """A JAX BOCarry in float64 with fitted-looking hypers, and its port twin."""
    rng = np.random.RandomState(seed)
    jcfg = JGPConfig(kernel="matern52", y_warp=y_warp)
    tcfg = GPConfig(kernel="matern52", y_warp=y_warp)
    x = np.zeros((N_MAX, D))
    x[:N] = rng.rand(N, D)
    y = np.zeros(N_MAX)
    y[:N] = 5.0 * np.sin(3 * x[:N, 0]) + 20.0 * x[:N, 1] ** 2 + 0.1 * rng.randn(N)
    raw = JG.GPParams(raw_lengthscale=jnp.asarray(rng.randn(D) * 0.3 - 1.0), raw_outputscale=jnp.asarray(0.2),
                      raw_noise=jnp.asarray(-3.0), raw_mean=jnp.asarray(0.0))
    state = JG.make_gp_state(jnp.asarray(x), jnp.asarray(y), JL.row_mask(N_MAX, N), raw, jcfg)
    carry_j = JBO.BOCarry(x_buf=jnp.asarray(x), y_buf=jnp.asarray(y), n=jnp.asarray(N), chol=state.chol, raw=raw,
                          y_mean=state.y_mean, y_std=state.y_std, key=jax.random.key(seed))
    carry_t = C.bo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
    return carry_j, carry_t, jcfg, tcfg, rng


@pytest.mark.parametrize("y_warp", ["none", "bilog"])
def test_state_from_carry_matches_jax(y_warp):
    carry_j, carry_t, jcfg, tcfg, _ = _carries(y_warp)
    sj, st = JBO._state_from_carry(carry_j, jcfg), TBO._state_from_carry(carry_t, tcfg)
    np.testing.assert_allclose(st.alpha.numpy(), np.asarray(sj.alpha), **F64)
    np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask))
    np.testing.assert_array_equal(st.chol.numpy(), np.asarray(sj.chol))
    for k in sj.params:
        np.testing.assert_allclose(st.params[k].numpy(), np.asarray(sj.params[k]), rtol=1e-12)
    back = C.bo_carry_to_numpy(carry_t)
    assert back.n == N and isinstance(back.chol, np.ndarray)
    np.testing.assert_array_equal(back.x_buf, np.asarray(carry_j.x_buf))


@pytest.mark.parametrize("mode", ["incremental", "refactor"])
@pytest.mark.parametrize("q", [1, Q])
def test_append_batch_matches_jax(mode, q):
    carry_j, carry_t, jcfg, tcfg, rng = _carries()
    x_new, y_new = rng.rand(q, D), rng.randn(q) + 3.0
    before = [a.clone() for a in (carry_t.x_buf, carry_t.y_buf, carry_t.chol)]
    cj = JBO._append_batch(carry_j, jnp.asarray(x_new), jnp.asarray(y_new), jcfg, mode)
    ct = TBO._append_batch(carry_t, torch.as_tensor(x_new), torch.as_tensor(y_new), tcfg, mode)
    assert ct.n == N + q == int(cj.n)
    np.testing.assert_array_equal(ct.x_buf.numpy(), np.asarray(cj.x_buf))
    np.testing.assert_array_equal(ct.y_buf.numpy(), np.asarray(cj.y_buf))
    np.testing.assert_allclose(ct.chol.numpy(), np.asarray(cj.chol), rtol=1e-9, atol=1e-12)
    for a, b in zip(before, (carry_t.x_buf, carry_t.y_buf, carry_t.chol)):
        assert torch.equal(a, b)  # the carry handed in stays valid
    # the appended factor is the factor of the grown matrix
    other = TBO._append_batch(carry_t, torch.as_tensor(x_new), torch.as_tensor(y_new), tcfg,
                              "refactor" if mode == "incremental" else "incremental")
    np.testing.assert_allclose(ct.chol.numpy(), other.chol.numpy(), rtol=0, atol=1e-5)  # they differ by the jitter


def test_append_batch_guards_capacity_and_mode():
    _, carry_t, _, tcfg, rng = _carries()
    with pytest.raises(ValueError, match="capacity"):
        TBO._append_batch(carry_t, torch.as_tensor(rng.rand(N_MAX, D)), torch.zeros(N_MAX, dtype=torch.float64), tcfg)
    with pytest.raises(ValueError, match="chol_mode"):
        TBO._append_batch(carry_t, torch.as_tensor(rng.rand(1, D)), torch.zeros(1, dtype=torch.float64), tcfg, "auto")


def _jax_draws(key, dtype=jnp.float64):
    kc, _, kt = jax.random.split(key, 3)
    return (np.asarray(JS.sobol_sample(kc, D, N_CAND, dtype=dtype)),
            np.asarray(jax.random.normal(kt, (Q, N_CAND), dtype)))


@pytest.mark.parametrize("acq,y_warp", [("ei", "none"), ("ei", "bilog"), ("lcb", "none"), ("ts", "none")])
def test_suggest_picks_the_points_jax_picks(acq, y_warp):
    carry_j, carry_t, jcfg, tcfg, _ = _carries(y_warp)
    kw = dict(n_init=N, max_evals=N_MAX, batch_size=Q, acq=acq, n_candidates=N_CAND, xi=0.01, kappa=1.5)
    key = jax.random.key(7)
    cands, normals = _jax_draws(key)
    want = np.asarray(JBO._suggest(carry_j, jcfg, JBO.BOConfig(**kw), key))
    got = TBO._suggest(carry_t, tcfg, TBO.BOConfig(**kw), cands=torch.as_tensor(cands),
                         draws=TA.Draws(normals=torch.as_tensor(normals)))
    assert got.shape == (Q, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    drawn = TBO._suggest(carry_t, tcfg, TBO.BOConfig(**kw), torch.Generator().manual_seed(0))
    assert drawn.shape == (Q, D) and float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0


def test_suggest_local_pool_and_unported_samplers():
    _, carry_t, _, tcfg, _ = _carries()
    bo = TBO.BOConfig(n_init=N, batch_size=Q, acq="ei", n_candidates=40, local_frac=0.5, local_sigma=0.01)
    g = torch.Generator().manual_seed(1)
    xs = TBO._suggest(carry_t, tcfg, bo, g)
    assert xs.shape == (Q, D) and float(xs.min()) >= 0.0 and float(xs.max()) <= 1.0
    for field, value in (("ts_sampler", "rff"), ("ts_sampler", "pathwise"), ("ts_dtype", "float64")):
        picked = TBO._suggest(carry_t, tcfg, dataclasses.replace(bo, acq="ts", **{field: value}), g)
        assert picked.shape == (Q, D) and float(picked.min()) >= 0.0 and float(picked.max()) <= 1.0
        assert len({tuple(r) for r in picked.tolist()}) == Q  # without replacement
    with pytest.raises(ValueError):
        TBO._suggest(carry_t, tcfg, dataclasses.replace(bo, acq="ts", ts_sampler="sobol"), g)
    with pytest.raises(ValueError):
        TBO._suggest(carry_t, tcfg, dataclasses.replace(bo, acq="pi"), g)


def test_lowest_k_is_stable_like_lax_top_k(rng):
    scores = rng.randint(0, 4, size=200).astype(np.float64)  # many ties
    scores[[5, 17, 60]] = -1.0
    for k in (1, 3, 10, 50):
        want = np.asarray(lax.top_k(-jnp.asarray(scores), k)[1])
        np.testing.assert_array_equal(TBO.lowest_k(torch.as_tensor(scores), k).numpy(), want)
    assert TBO.lowest_k(torch.zeros(30), 4).tolist() == [0, 1, 2, 3]


def test_suggest_with_tied_scores_takes_the_lowest_indices():
    """EI underflows to exactly 0 at candidates beside bad observations (a
    tiny posterior deviation far above the incumbent): all tie, and both
    packages take the first q."""
    carry_j, carry_t, jcfg, tcfg, rng = _carries()
    y = np.asarray(carry_j.y_buf).copy()
    y[:N] = 500.0 + np.arange(N)
    y[0] = 0.0  # the incumbent, far below the rest
    raw = carry_j.raw._replace(raw_noise=jnp.asarray(-9.0))
    state = JG.make_gp_state(carry_j.x_buf, jnp.asarray(y), JL.row_mask(N_MAX, N), raw, jcfg)
    carry_j = carry_j._replace(y_buf=jnp.asarray(y), raw=raw, chol=state.chol, y_mean=state.y_mean, y_std=state.y_std)
    carry_t = C.bo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
    x = np.asarray(carry_j.x_buf)
    cands = np.clip(np.repeat(x[1:N], 3, axis=0) + 1e-7 * rng.randn(3 * (N - 1), D), 0.0, 1.0)
    mu, var = TG.gp_posterior(TBO._state_from_carry(carry_t, tcfg), torch.as_tensor(cands), tcfg)
    ei = TA.expected_improvement(mu, var, torch.tensor(0.0, dtype=torch.float64))
    assert bool((ei == 0.0).all())  # exactly tied
    bo_t = TBO.BOConfig(n_init=N, batch_size=Q, acq="ei", n_candidates=len(cands))
    got = TBO._suggest(carry_t, tcfg, bo_t, cands=torch.as_tensor(cands))
    np.testing.assert_array_equal(got.numpy(), cands[:Q])
    scores_j = -np.zeros(len(cands))
    np.testing.assert_array_equal(np.asarray(lax.top_k(-jnp.asarray(scores_j), Q)[1]), np.arange(Q))


def test_config1_run_with_replayed_draws_visits_jax_points():
    cfg_j = JR.reduced(JR.get_config("branin_ei"), max_evals=20, n_init=10)
    cfg_t = TR.reduced(TR.get_config("branin_ei"), max_evals=20, n_init=10)
    assert cfg_t.bo.n_iters == 10 and cfg_t.bo.chol_mode == "incremental" and cfg_t.bo.fit_every == 0
    bj, bt = JB.get_benchmark("branin"), TB.get_benchmark("branin")
    n_max, dim = 20, 2
    key = jax.random.key(0)
    fixed_j = JG.default_params(dim, cfg_j.gp)
    carry_j = JBO._bo_init(key, bj.fn, bj.lb, bj.ub, cfg_j.bo, cfg_j.gp, n_max, fixed_j)
    step_j = jax.jit(JBO._make_bo_step(bj.fn, bj.lb, bj.ub, cfg_j.bo, cfg_j.gp, n_max))

    f64 = torch.float64
    lb_t, ub_t = torch.tensor(bt.lb, dtype=f64), torch.tensor(bt.ub, dtype=f64)
    k_init, _, _ = jax.random.split(key, 3)
    x0 = torch.tensor(np.asarray(JS.latin_hypercube(k_init, 10, dim)), dtype=f64)
    carry_t = TBO._bo_init(bt.fn, lb_t, ub_t, cfg_t.bo, cfg_t.gp, n_max, TG.default_params(dim, cfg_t.gp, f64), x0=x0)
    np.testing.assert_allclose(carry_t.y_buf.numpy(), np.asarray(carry_j.y_buf), rtol=1e-5, atol=1e-5)
    for it in range(10):
        k_it, _, _ = jax.random.split(carry_j.key, 3)
        kc, _, _ = jax.random.split(k_it, 3)
        cands = np.asarray(JS.sobol_sample(kc, dim, cfg_j.bo.n_candidates, dtype=jnp.float32))
        carry_j, best_j = step_j(carry_j, jnp.asarray(it))
        carry_t, best_t = TBO._bo_step(carry_t, it, bt.fn, lb_t, ub_t, cfg_t.bo, cfg_t.gp,
                                       cands=torch.tensor(cands, dtype=f64))
        assert carry_t.n == int(carry_j.n) == 11 + it
        np.testing.assert_allclose(carry_t.x_buf.numpy(), np.asarray(carry_j.x_buf), rtol=0, atol=1e-8,
                                   err_msg=f"iteration {it}")
        np.testing.assert_allclose(float(best_t), float(best_j), rtol=1e-5)
    res = TBO._bo_result(carry_t, lb_t, ub_t, torch.zeros(10, dtype=f64))
    assert float(res.best_y) == float(carry_t.y_buf[:20].min()) and res.n == 20
    np.testing.assert_allclose(float(bt.fn(res.best_x[None])[0]), float(res.best_y), rtol=1e-12)


def test_bo_init_imputes_failures_against_a_masked_dummy_row():
    """An init design with failed evaluations: the failures become the
    penalty JAX imputes (the floor when nothing succeeded)."""
    bt = TB.get_benchmark("branin")
    bo = TBO.BOConfig(n_init=6, max_evals=8, fit_every=0)
    lb_t, ub_t = torch.tensor(bt.lb, dtype=torch.float64), torch.tensor(bt.ub, dtype=torch.float64)

    def failing(x):
        y = bt.fn(x)
        y[::2] = float("nan")
        return y

    carry = TBO._bo_init(failing, lb_t, ub_t, bo, GPConfig(kernel="rbf"), 8, None, torch.Generator().manual_seed(0))
    raw = failing(lb_t + carry.x_buf[:6] * (ub_t - lb_t)).numpy()
    assert np.isnan(raw).sum() == 3
    want = np.asarray(JT.impute_failures(jnp.asarray(raw), jnp.zeros((1,)), jnp.zeros((1,), bool)))
    got = carry.y_buf[:6].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(np.isfinite(got)) and got[0] > np.nanmax(raw) and bool(torch.isfinite(carry.chol).all())

    all_failed = TBO._bo_init(lambda x: torch.full_like(x[:, 0], float("nan")), lb_t, ub_t, bo, GPConfig(kernel="rbf"),
                              8, None, torch.Generator().manual_seed(0))
    assert bool((all_failed.y_buf[:6] >= 1e6).all())  # the floor: never a penalty that ranks as the best


@pytest.mark.parametrize("name,max_evals,threshold", [("branin_ei", 20, 8.0), ("hartmann6_lbfgs", 20, -0.5)])
def test_reduced_config_end_to_end(name, max_evals, threshold):
    cfg = TR.reduced(TR.get_config(name), max_evals=max_evals)
    ref = JR.reduced(JR.get_config(name), max_evals=max_evals)
    drop = ("use_pallas", "use_kernel")
    assert {k: v for k, v in dataclasses.asdict(cfg.bo).items()} == dataclasses.asdict(ref.bo)
    assert ({k: v for k, v in dataclasses.asdict(cfg.gp).items() if k not in drop}
            == {k: v for k, v in dataclasses.asdict(ref.gp).items() if k not in drop})
    b = TB.get_benchmark(cfg.benchmark)
    fixed = TG.default_params(b.dim, cfg.gp) if cfg.bo.fit_every == 0 else None
    seen = []
    res = TBO.run_bo(b.fn, b.lb, b.ub, cfg.bo, cfg.gp, torch.Generator().manual_seed(0), fixed_params=fixed,
                     on_iteration=lambda it, best: seen.append((it, float(best))))
    trace = res.incumbent_trace.numpy()
    assert trace.shape == (cfg.bo.n_iters,) and [it for it, _ in seen] == list(range(cfg.bo.n_iters))
    assert np.all(np.isfinite(trace)) and np.all(np.diff(trace) <= 1e-6), "the incumbent must be monotone"
    assert float(res.best_y) < threshold and res.n == max_evals
    assert [float(v) for _, v in seen] == trace.tolist()


def test_resolved_chol_mode():
    assert TBO.BOConfig(chol_mode="refactor").resolved_chol_mode("cpu") == "refactor"
    assert TBO.BOConfig(chol_mode="incremental").resolved_chol_mode("cuda") == "incremental"
    assert TBO.BOConfig(batch_size=64).resolved_chol_mode("cpu") == "incremental"
    assert TBO.BOConfig(batch_size=1).resolved_chol_mode("cuda") == "incremental"
    assert TBO.BOConfig(batch_size=2).resolved_chol_mode("cuda:0") == "refactor"
    assert TBO.BOConfig(batch_size=64).resolved_chol_mode(torch.device("cuda")) == "refactor"
