"""The TuRBO-1 slice as a whole: the port's trust-region state machine
against the tables of ``tests/test_trust_region.py``, one search-phase
propose + absorb step from a JAX state carried across with ``convert``
(the candidates and normals JAX made injected) against the JAX
composition in f64 (rtol 1e-9), and a short port-only ``optimize`` run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import acq as JA
from turbojax import gp as JG
from turbojax import sampling as JS
from turbojax import trust_region as JT
from turbojax.config import GPConfig as JGPConfig
from turbojax.config import TRConfig as JTRConfig
from turbojax_torch import acq as TA
from turbojax_torch import benchmarks as TB
from turbojax_torch import convert as C
from turbojax_torch import optimize
from turbojax_torch import registry as TRG
from turbojax_torch import trust_region as TT
from turbojax_torch.config import GPConfig, TRConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)

# (length, succ, fail, improved, counted): the transitions of
# tests/test_trust_region.py, run through both packages
TABLE = [
    (0.8, 1, 0, True, True),  # success counter accumulates
    (0.8, 2, 0, True, True),  # expand on succ_tol
    (1.0, 2, 0, True, True),  # expand caps at length_max
    (0.8, 0, 2, False, True),  # fail counter
    (0.8, 0, 3, False, True),  # shrink on fail_tol
    (0.8, 2, 2, False, True),  # failure resets succ
    (0.8, 1, 3, True, True),  # success resets fail
    (0.8, 2, 3, True, False),  # uncounted step is the identity
]


@pytest.mark.parametrize("length, succ, fail, improved, counted", TABLE)
def test_tr_update_table_matches_jax(length, succ, fail, improved, counted):
    jcfg, tcfg = JTRConfig(succ_tol=3, fail_tol=4), TRConfig(succ_tol=3, fail_tol=4)
    js = JT.TRState(jnp.asarray(length), jnp.asarray(succ), jnp.asarray(fail), jnp.asarray(0), jnp.asarray(0))
    ts = TT.TRState(torch.tensor(length, dtype=torch.float64), *(torch.tensor(v) for v in (succ, fail, 0, 0)))
    out_j = JT.tr_update(js, jnp.asarray(improved), jnp.asarray(counted), jcfg, 4)
    out_t = TT.tr_update(ts, torch.tensor(improved), torch.tensor(counted), tcfg, 4)
    for name in TT.TRState._fields:
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)), err_msg=name)


def test_tr_init_and_fail_tol():
    s = TT.tr_init()
    assert float(s.length) == pytest.approx(0.8) and int(s.succ) == int(s.fail) == int(s.restarts) == 0
    for dim, q in ((10, 10), (10, 3), (2, 1), (50, 1)):
        assert TRConfig().resolved_fail_tol(dim, q) == JTRConfig().resolved_fail_tol(dim, q)


D, N_LOC, N, Q, N_CAND = 4, 40, 25, 5, 64


def _objective(x):
    return np.sum((x - 0.3) ** 2, axis=-1) + 0.1 * np.sin(9 * x[:, 0])


def _jax_carry(rng, length, succ, fail):
    config = JGPConfig(kernel="matern52", fit_optimizer="grid")
    x = np.zeros((N_LOC, D))
    x[:N] = rng.rand(N, D)
    y = np.zeros(N_LOC)
    y[:N] = _objective(x[:N])
    best = int(np.argmin(y[:N]))
    return JT.TurboCarry(
        x_buf=jnp.asarray(x), y_buf=jnp.asarray(y), n=jnp.asarray(N),
        raw=JG.default_params(D, config, jnp.float64),
        tr=JT.TRState(jnp.asarray(length), jnp.asarray(succ), jnp.asarray(fail), jnp.asarray(0), jnp.asarray(0)),
        init_stream=JS.latin_hypercube(jax.random.key(1), 10, D, jnp.float64),
        best_x=jnp.asarray(x[best]), best_y=jnp.asarray(y[best]), key=jax.random.key(2),
    ), config


@pytest.mark.parametrize("case", ["expand", "shrink", "restart"])
def test_search_step_matches_jax(case, rng):
    length, succ, fail, offset = {"expand": (0.4, 2, 0, -10.0), "shrink": (0.4, 0, 0, 10.0),
                                  "restart": (1.5 * 0.5**7, 0, 0, 10.0)}[case]
    carry_j, config_j = _jax_carry(rng, length, succ, fail)
    config_t = GPConfig(kernel="matern52", fit_optimizer="grid")
    cfg_j = JT.TurboConfig(n_init=10, max_evals=100, batch_size=Q, n_candidates=N_CAND)
    cfg_t = TT.TurboConfig(n_init=10, max_evals=100, batch_size=Q, n_candidates=N_CAND)
    fail_tol = cfg_t.tr.resolved_fail_tol(D, Q)
    key = jax.random.key(3)

    # the JAX composition, and the draws it makes
    carry1_j, xs_j, in_search = JT.turbo_propose(carry_j, key, cfg_j, config_j)
    assert bool(in_search)
    k_fit, k_cand, k_ts = jax.random.split(key, 3)
    mask = jnp.arange(N_LOC) < N
    state_j = JG.fit_gp(k_fit, carry_j.x_buf, carry_j.y_buf, mask, config_j, warm_start=carry_j.raw)
    center = carry_j.x_buf[jnp.argmin(jnp.where(mask, carry_j.y_buf, jnp.inf))]
    cands = JS.tr_candidates(k_cand, center, carry_j.tr.length,
                             jnp.broadcast_to(state_j.params["lengthscale"], (D,)), N_CAND)
    normals = jax.random.normal(k_ts, (Q, N_CAND), jnp.float64)
    ys = _objective(np.asarray(xs_j)) + offset
    carry2_j = JT.turbo_absorb(carry1_j, xs_j, jnp.asarray(ys), jnp.ones(Q, bool), in_search, cfg_j,
                               config_j, fail_tol, jax.random.key(4))

    # the port, from the same state, with JAX's draws injected
    carry_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
    carry1_t, xs_t, in_search_t = TT.turbo_propose(
        carry_t, cfg_t, config_t, cands=torch.tensor(np.asarray(cands)),
        draws=TA.Draws(normals=torch.tensor(np.asarray(normals))))
    assert in_search_t
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), **F64)
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(carry1_t.raw, name).numpy(), np.asarray(getattr(carry1_j.raw, name)), **F64)
    g = torch.Generator().manual_seed(0)
    carry2_t = TT.turbo_absorb(carry1_t, xs_t, torch.tensor(ys), in_search_t, cfg_t, fail_tol, g)

    assert carry2_t.n == int(carry2_j.n)
    for name in ("x_buf", "y_buf", "best_x", "best_y"):
        np.testing.assert_allclose(getattr(carry2_t, name).numpy(), np.asarray(getattr(carry2_j, name)), **F64)
    for name in TT.TRState._fields:
        np.testing.assert_allclose(getattr(carry2_t.tr, name).numpy(), np.asarray(getattr(carry2_j.tr, name)), **F64)
    if case == "restart":
        assert carry2_t.n == 0 and int(carry2_t.tr.restarts) == 1
        stream = carry2_t.init_stream.numpy()  # a fresh LHS from the port's own generator
        assert stream.shape == (10, D)
        for j in range(D):
            np.testing.assert_array_equal(np.sort(np.floor(stream[:, j] * 10)), np.arange(10))
    else:
        np.testing.assert_array_equal(carry2_t.init_stream.numpy(), np.asarray(carry2_j.init_stream))
        assert float(carry2_t.tr.length) == {"expand": 0.8, "shrink": 0.2}[case]
    back = C.turbo_carry_to_numpy(carry2_t)
    np.testing.assert_array_equal(back.x_buf, carry2_t.x_buf.numpy())


def test_init_phase_slices_the_lhs_stream(rng):
    cfg = TT.TurboConfig(n_init=10, max_evals=100, batch_size=Q, n_candidates=N_CAND)
    g = torch.Generator().manual_seed(0)
    carry = TT.make_turbo_carry(D, N_LOC, cfg, GPConfig(), g, torch.float64)
    carry2, xs, in_search = TT.turbo_propose(carry, cfg, GPConfig(), g)
    assert not in_search and carry2 is carry
    np.testing.assert_array_equal(xs.numpy(), carry.init_stream[:Q].numpy())


def test_optimize_turbo1_cpu_improves_on_initial_design(tmp_path):
    bench = TB.get_benchmark("ackley10")
    cfg = TRG.get_config("turbo1_ackley10")
    res = optimize(bench.fn, bench.lb, bench.ub, 60, method="turbo1", n_init=20, batch_size=10,
                   n_candidates=64, gp_config=cfg.gp, seed=0, device="cpu")
    assert np.all(np.isfinite(res.y_hist)) and np.isfinite(res.best_y)
    assert res.incumbent_trace.shape == (4,)
    assert res.best_y < res.incumbent_trace[1]  # the best of the 20-point initial design
    assert res.best_y == pytest.approx(float(np.min(bench.fn(torch.as_tensor(res.best_x)[None]).numpy())), rel=1e-5)
    # a checkpointed run saves as it goes; resuming its finished checkpoint returns the same run
    path = str(tmp_path / "run.ckpt")
    kw = dict(method="bo", n_init=6, batch_size=2, n_candidates=64, seed=0, device="cpu", checkpoint_path=path,
              checkpoint_every=1)
    ref = optimize(bench.fn, bench.lb, bench.ub, 12, **kw)
    again = optimize(bench.fn, bench.lb, bench.ub, 12, resume=True, **kw)
    np.testing.assert_array_equal(again.incumbent_trace, ref.incumbent_trace)


@pytest.mark.parametrize("options", [dict(ts_sampler="rff"), dict(ts_sampler="pathwise"), dict(ts_dtype="float64")],
                         ids=["rff", "pathwise", "f64"])
def test_search_step_with_sampler_options_matches_jax(options, rng):
    """One search-phase proposal with each sampler option against JAX's
    ``turbo_propose``, its candidates and sampler draws injected."""
    carry_j, config_j = _jax_carry(rng, 0.4, 0, 0)
    config_t = GPConfig(kernel="matern52", fit_optimizer="grid")
    kw = dict(n_init=10, max_evals=100, batch_size=Q, n_candidates=N_CAND, rff_features=32, **options)
    cfg_j, cfg_t = JT.TurboConfig(**kw), TT.TurboConfig(**kw)
    key = jax.random.key(3)
    carry1_j, xs_j, _ = JT.turbo_propose(carry_j, key, cfg_j, config_j)
    k_fit, k_cand, k_ts = jax.random.split(key, 3)
    mask = jnp.arange(N_LOC) < N
    state_j = JG.fit_gp(k_fit, carry_j.x_buf, carry_j.y_buf, mask, config_j, warm_start=carry_j.raw)
    center = carry_j.x_buf[jnp.argmin(jnp.where(mask, carry_j.y_buf, jnp.inf))]
    cands = JS.tr_candidates(k_cand, center, carry_j.tr.length, jnp.broadcast_to(state_j.params["lengthscale"], (D,)),
                             N_CAND)
    if cfg_t.ts_sampler == "exact":
        draws = TA.Draws(normals=torch.tensor(np.asarray(jax.random.normal(k_ts, (Q, N_CAND), jnp.float64))))
    else:
        keys = jax.random.split(k_ts, 2 if cfg_t.ts_sampler == "rff" else 3)
        omega, b = JA.rff_frequencies(keys[0], D, 32, "matern52", jnp.float64)
        draws = TA.Draws(omega=torch.tensor(np.asarray(omega)), b=torch.tensor(np.asarray(b)),
                         weights=torch.tensor(np.asarray(jax.random.normal(keys[1], (Q, 32), jnp.float64))))
        if cfg_t.ts_sampler == "pathwise":
            draws = draws._replace(eps=torch.tensor(np.asarray(jax.random.normal(keys[2], (Q, N_LOC), jnp.float64))))
    carry_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
    carry1_t, xs_t, in_search = TT.turbo_propose(carry_t, cfg_t, config_t, cands=torch.tensor(np.asarray(cands)),
                                                 draws=draws)
    assert in_search
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), **F64)
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(carry1_t.raw, name).numpy(), np.asarray(getattr(carry1_j.raw, name)), **F64)
    g = torch.Generator().manual_seed(0)  # and with the port's own draws, the local pool included
    _, drawn, _ = TT.turbo_propose(carry_t, TT.TurboConfig(**kw, local_frac=0.3), config_t, g)
    assert drawn.shape == (Q, D) and bool(torch.isfinite(drawn).all())


def _quad(x):
    return ((x - 0.4) ** 2).sum(dim=-1)


def test_turbo1_fit_every_cadence_matches_jax():
    """``fit_every=3`` (tests/test_turbo.py::test_turbo1_fit_every_cadence):
    off the cadence the carried hypers are reused and the factor rebuilt
    over the grown history; on it the grid fit moves them. Both states
    against JAX's ``_fit_or_reuse`` in f64; then a port run with the 3-batch
    cadence still optimizes, with the same evaluation accounting."""
    jgp = JGPConfig(fit_optimizer="grid", noise_floor=1e-4)
    tgp = GPConfig(fit_optimizer="grid", noise_floor=1e-4)
    kw = dict(n_init=6, max_evals=40, batch_size=2, n_candidates=32, fit_every=3)
    jcfg, tcfg = JT.TurboConfig(**kw), TT.TurboConfig(**kw)
    key = jax.random.key(0)
    xs = np.asarray(jax.random.uniform(key, (16, 3), dtype=jnp.float64))
    base = JT.make_turbo_carry(key, 3, 16, jcfg, jgp, jnp.float64)
    base = base._replace(x_buf=jnp.asarray(xs), y_buf=jnp.asarray(((xs - 0.4) ** 2).sum(-1)))
    for batches, refit in ((1, False), (3, True)):
        n = jcfg.n_init + batches * jcfg.batch_size
        carry_j = base._replace(n=jnp.asarray(n))
        mask = jnp.arange(16) < n
        state_j = JT._fit_or_reuse(key, carry_j, mask, jcfg, jgp)
        carry_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
        assert TT.refits_now(n, tcfg) is refit
        state_t = TT._fit_or_reuse(carry_t, torch.as_tensor(np.asarray(mask)), tcfg, tgp)
        for name in JG.GPParams._fields:
            got, want = getattr(state_t.raw, name).numpy(), np.asarray(getattr(state_j.raw, name))
            np.testing.assert_allclose(got, want, **F64)
            if not refit:
                np.testing.assert_array_equal(got, np.asarray(getattr(carry_j.raw, name)))
        np.testing.assert_allclose(state_t.chol.numpy(), np.asarray(state_j.chol), **F64)
        np.testing.assert_allclose(state_t.alpha.numpy(), np.asarray(state_j.alpha), **F64)
        moved = any(not np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(state_t.raw, carry_j.raw))
        assert moved is refit
    runs = {}
    for every in (1, 3):
        cfg = TT.TurboConfig(**{**kw, "fit_every": every})
        runs[every], _ = TT.run_turbo1(_quad, (0.0,) * 3, (1.0,) * 3, cfg, tgp, torch.Generator().manual_seed(1))
    assert float(runs[3].best_y) < 0.15 and runs[3].n == runs[1].n


_GCFG = GPConfig(fit_restarts=2, fit_maxiter=15)


def test_stagnation_restart_triggers():
    """``stagnation_tol`` (tests/test_turbo.py:323): on a flat objective the
    length only halves every fail_tol batches and never collapses in 14
    batches, but the stagnation counter restarts the region."""
    def flat(x):
        return torch.zeros(x.shape[0], dtype=x.dtype)

    base = dict(n_init=4, max_evals=60, batch_size=4, n_candidates=32)
    carry_ref, _ = TT.run_turbo1(flat, (0.0,) * 3, (1.0,) * 3, TT.TurboConfig(**base, tr=TRConfig(fail_tol=4)),
                                 _GCFG, torch.Generator().manual_seed(1))
    assert int(carry_ref.tr.restarts) == 0
    carry, _ = TT.run_turbo1(flat, (0.0,) * 3, (1.0,) * 3,
                             TT.TurboConfig(**base, tr=TRConfig(fail_tol=4, stagnation_tol=4)), _GCFG,
                             torch.Generator().manual_seed(1))
    assert int(carry.tr.restarts) >= 2 and int(carry.tr.stag) < 4


def test_stagnation_counts_starved_trs_matches_jax():
    """A region the allocation starves still counts toward ``stag``
    (tests/test_turbo.py:347): JAX's and the port's counters step by step,
    through the starved batches to the restart."""
    kw = dict(n_init=4, max_evals=40, batch_size=4, n_candidates=32)
    jcfg = JT.TurboConfig(**kw, tr=JTRConfig(stagnation_tol=3))
    tcfg = TT.TurboConfig(**kw, tr=TRConfig(stagnation_tol=3))
    jgp = JGPConfig(fit_restarts=2, fit_maxiter=15)
    carry_j = JT.make_turbo_carry(jax.random.key(0), 3, 16, jcfg, jgp)
    carry_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)), dtype=torch.float32)
    xs = np.linspace(0.1, 0.9, 12, dtype=np.float32).reshape(4, 3)
    ys = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    g = torch.Generator().manual_seed(0)
    steps = [(np.ones(4, bool), False)] + [(np.zeros(4, bool), True)] * 3
    for i, (accept, in_search) in enumerate(steps):
        carry_j = JT.turbo_absorb(carry_j, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(accept),
                                  jnp.asarray(in_search), jcfg, jgp, 4, jax.random.key(1 + i))
        carry_t = TT.turbo_absorb(carry_t, torch.as_tensor(xs), torch.as_tensor(ys), in_search, tcfg, 4, g,
                                  accept=accept)
        assert carry_t.n == int(carry_j.n)
        for name in TT.TRState._fields:
            np.testing.assert_array_equal(getattr(carry_t.tr, name).numpy(), np.asarray(getattr(carry_j.tr, name)),
                                          err_msg=f"step {i}: {name}")
    assert int(carry_t.tr.restarts) == 1 and carry_t.n == 0 and int(carry_t.tr.fail) == 0


def test_run_config_with_loop_options_on_cpu():
    """``profile_config5.run_config`` with TuRBO loop options (as
    ``chip_smoke.py`` phase 8 and ``--ts-sampler`` etc. run them), cut to
    four iterations on the CPU: config 4 with the pathwise sampler and the
    local pool; options on a plain-BO configuration are refused."""
    from turbojax_torch.profile_config5 import run_config

    res, bench = run_config("turbo1_ackley10", 0, device="cpu", max_evals=60, ts_sampler="pathwise", local_frac=0.3)
    assert res.incumbent_trace.shape == (4,) and np.all(np.isfinite(res.y_hist)) and res.x_hist.shape[1] == bench.dim
    assert res.best_y == res.incumbent_trace[-1] and res.best_y < res.incumbent_trace[1]
    with pytest.raises(ValueError, match="not a TuRBO configuration"):
        run_config("branin_ei", 0, device="cpu", ts_sampler="rff")
