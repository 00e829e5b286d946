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

from turbojax import gp as JG
from turbojax import sampling as JS
from turbojax import trust_region as JT
from turbojax.config import GPConfig as JGPConfig
from turbojax.config import TRConfig as JTRConfig
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
        carry_t, cfg_t, config_t, cands=torch.tensor(np.asarray(cands)), normals=torch.tensor(np.asarray(normals)))
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


def test_optimize_turbo1_cpu_improves_on_initial_design():
    bench = TB.get_benchmark("ackley10")
    cfg = TRG.get_config("turbo1_ackley10")
    res = optimize(bench.fn, bench.lb, bench.ub, 60, method="turbo1", n_init=20, batch_size=10,
                   n_candidates=64, gp_config=cfg.gp, seed=0, device="cpu")
    assert np.all(np.isfinite(res.y_hist)) and np.isfinite(res.best_y)
    assert res.incumbent_trace.shape == (4,)
    assert res.best_y < res.incumbent_trace[1]  # the best of the 20-point initial design
    assert res.best_y == pytest.approx(float(np.min(bench.fn(torch.as_tensor(res.best_x)[None]).numpy())), rel=1e-5)
    with pytest.raises(NotImplementedError):  # checkpointing is not ported yet
        optimize(bench.fn, bench.lb, bench.ub, 60, method="bo", checkpoint_path="run.ckpt", checkpoint_every=1,
                 device="cpu")
