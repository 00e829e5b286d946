"""The TuRBO-m slice as a whole against ``turbojax.turbo_m``.

``global_allocate`` on the cases of ``tests/test_turbo.py`` (NaN and inf
regions, ``cap``), the ``_split_cap`` table, ``turbo_absorb`` with
``accept`` patterns, rover60, and one ``turbom_propose_batch`` +
``turbom_absorb_batch`` step from a JAX carry batch of m = 3 regions (one in
its init phase or competing, one starved by the allocation, one at its
restart threshold), with every draw JAX made injected (candidates,
Thompson normals, forcing uniforms, restart LHS), compared in float64 at
rtol 1e-9. Then the split capacity against the uniform one, and a short
port-only ``optimize(method="turbom")`` run on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs import registry as JR
from turbojax import benchmarks as JB
from turbojax import gp as JG
from turbojax import sampling as JS
from turbojax import trust_region as JT
from turbojax import turbo_m as JM
from turbojax.config import GPConfig as JGPConfig
from turbojax.config import TRConfig as JTRConfig
from turbojax_torch import benchmarks as TB
from turbojax_torch import convert as C
from turbojax_torch import optimize
from turbojax_torch import registry as TRG
from turbojax_torch import trust_region as TT
from turbojax_torch import turbo_m as TM
from turbojax_torch.config import GPConfig, TRConfig

torch.set_num_threads(1)

F64 = dict(rtol=1e-9, atol=1e-12)


def _allocate_cases():
    key = jax.random.key(0)
    vals = {
        "fixed": (jnp.asarray([[[5.0, 1.0, 9.0], [5.0, 1.0, 9.0]], [[2.0, 8.0, 9.0], [0.5, 8.0, 9.0]]]), None),
        "random": (jax.random.uniform(key, (3, 6, 10)), None),
    }
    dominated = jax.random.uniform(key, (3, 6, 8)) + jnp.array([0.0, 10.0, 10.0])[:, None, None]
    vals["dominated"] = (dominated, None)
    vals["dominated_cap2"] = (dominated, 2)
    row = jax.random.uniform(jax.random.key(7), (8,))
    degenerate = jnp.stack([jnp.tile(row, (6, 1)), jnp.full((6, 8), jnp.nan)])
    vals["nan_region_cap3"] = (degenerate, 3)
    vals["nan_region"] = (degenerate, None)
    with_inf = jax.random.uniform(jax.random.key(3), (3, 4, 5)).at[1].set(jnp.inf).at[2, :, :2].set(-jnp.inf)
    vals["inf_regions_cap2"] = (with_inf, 2)
    vals["all_capped_relaxed"] = (jax.random.uniform(jax.random.key(4), (2, 6, 3)), 3)
    return vals


ALLOCATE = _allocate_cases()


@pytest.mark.parametrize("case", sorted(ALLOCATE))
def test_global_allocate_matches_jax(case):
    vals, cap = ALLOCATE[case]
    tr_j, cand_j = JM.global_allocate(vals, cap)
    tr_t, cand_t = TM.global_allocate(torch.as_tensor(np.asarray(vals)), cap)
    np.testing.assert_array_equal(tr_t.numpy(), np.asarray(tr_j))
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    pairs = list(zip(tr_t.tolist(), cand_t.tolist()))
    assert len(set(pairs)) == len(pairs)  # without replacement
    if cap is not None and case != "all_capped_relaxed":
        assert np.bincount(tr_t.numpy()).max() <= cap


def test_global_allocate_rejects_a_cap_that_cannot_cover_the_batch():
    with pytest.raises(ValueError):
        TM.global_allocate(torch.rand(3, 6, 8), cap=1)


def test_split_cap_table():
    for args, want in [(([5], 4096, 16, 10), None), (([0, 0, 0, 0, 0], 512, 16, 10), None),
                       (([300, 40, 50, 60, 70], 1024, 16, 10), 512), (([1800, 60, 40, 50, 55], 2000, 16, 10), 512),
                       (([1800, 600, 40, 50, 55], 2000, 16, 10), None), (([1800, 600, 40, 50, 55], 4096, 16, 10), 1024),
                       (([1800, 600, 40, 50, 55], 4096, 0, 10), 1024), (([1900, 1000, 5], 2000, 0, 10), None)]:
        assert TM._split_cap(*args) == JM._split_cap(*args) == want, args
    assert TM._rung(1, 512, 2000) == 512 and TM._rung(513, 512, 2000) == 1024
    assert TM._rung(1100, 512, 2000) == 2000 and TM._rung(40, 40, 40) == 40


def test_rover60_matches_jax(rng):
    x = rng.rand(64, 60)
    ref = np.asarray(JB.get_benchmark("rover60").fn(jnp.asarray(x)))
    bench = TB.get_benchmark("rover60")
    np.testing.assert_allclose(bench.fn(torch.as_tensor(x)).numpy(), ref, rtol=1e-12)
    assert (bench.dim, bench.lb, bench.ub, bench.optimum) == (60, (0.0,) * 60, (1.0,) * 60, 2.0)
    np.testing.assert_array_equal(TB._ROVER_OBST_C, JB._ROVER_OBST_C)
    np.testing.assert_array_equal(TB._ROVER_OBST_R, JB._ROVER_OBST_R)


def test_config5_matches_the_jax_registry():
    knob = ("use_pallas", "use_kernel")
    port, ref = TRG.get_config("turbom5_rover60"), JR.get_config("turbom5_rover60")
    assert (port.name, port.benchmark, port.method, port.m) == (ref.name, ref.benchmark, ref.method, ref.m) == (
        "turbom5_rover60", "rover60", "turbom", 5)
    drop = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in knob}  # noqa: E731
    assert drop(port.gp) == drop(ref.gp)
    assert dataclasses.asdict(port.turbo) == dataclasses.asdict(ref.turbo)
    assert port.turbo.n_iters == 196 and port.turbo.ts_chunk == 1000 and port.turbo.n_candidates == 5000


D, N_LOC, Q, N_INIT, N_CAND, CHUNK = 4, 48, 4, 8, 64, 32


def _objective(x):
    return np.sum((x - 0.3) ** 2, axis=-1) + 0.1 * np.sin(9 * x[:, 0])


@pytest.mark.parametrize(
    "accept, n, in_search",
    [([1, 1, 1, 1], 10, True), ([0, 0, 0, 0], 10, True), ([0, 1, 0, 1], 10, True), ([1, 0, 1, 1], 10, False),
     ([1, 1, 1, 1], N_LOC - 2, True), ([0, 1, 1, 0], 10, True)],
)
def test_turbo_absorb_accept_matches_jax(accept, n, in_search, rng):
    accept = np.asarray(accept, dtype=bool)
    jcfg = JT.TurboConfig(n_init=N_INIT, max_evals=100, batch_size=Q, n_candidates=N_CAND, tr=JTRConfig(stagnation_tol=5))
    tcfg = TT.TurboConfig(n_init=N_INIT, max_evals=100, batch_size=Q, n_candidates=N_CAND, tr=TRConfig(stagnation_tol=5))
    x = np.zeros((N_LOC, D))
    x[:n] = rng.rand(n, D)
    y = np.zeros(N_LOC)
    y[:n] = _objective(x[:n])
    carry_j = JT.TurboCarry(
        x_buf=jnp.asarray(x), y_buf=jnp.asarray(y), n=jnp.asarray(n),
        raw=JG.default_params(D, JGPConfig(), jnp.float64),
        tr=JT.TRState(jnp.asarray(0.4), jnp.asarray(1), jnp.asarray(0), jnp.asarray(0), jnp.asarray(2)),
        init_stream=JS.latin_hypercube(jax.random.key(1), 8, D, jnp.float64),
        best_x=jnp.asarray(x[0]), best_y=jnp.asarray(y[:n].min() + 0.5), key=jax.random.key(2),
    )
    x_new = rng.rand(Q, D)
    y_new = _objective(x_new) - np.array([0.0, 1.0, 0.2, 0.5])  # row 1 is the batch's best
    out_j = JT.turbo_absorb(carry_j, jnp.asarray(x_new), jnp.asarray(y_new), jnp.asarray(accept),
                            jnp.asarray(in_search), jcfg, JGPConfig(), 2, jax.random.key(4))
    carry_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carry_j._replace(key=None)))
    out_t = TT.turbo_absorb(carry_t, torch.as_tensor(x_new), torch.as_tensor(y_new), in_search, tcfg, 2,
                            accept=torch.as_tensor(accept))
    assert out_t.n == int(out_j.n)
    for name in ("x_buf", "y_buf", "best_x", "best_y"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)), err_msg=name)
    for name in TT.TRState._fields:
        np.testing.assert_array_equal(getattr(out_t.tr, name).numpy(), np.asarray(getattr(out_j.tr, name)), err_msg=name)


def _jax_carries(case):
    """Three regions (f64). ``init``: region 0 in its init phase (it takes
    every slot), regions 1 and 2 starved, region 2 one starved batch from
    its stagnation restart. ``search``: all three searching; region 1's
    history sits 100 above the others (starved), region 2's 5 below with a
    length just above length_min and one failure to go (it takes the slots,
    fails and collapses)."""
    rng = np.random.RandomState(11)
    ns = {"init": (4, 20, 16), "search": (20, 12, 16)}[case]
    offsets = {"init": (0.0, 100.0, 0.0), "search": (0.0, 100.0, -5.0)}[case]
    x = np.zeros((3, N_LOC, D))
    y = np.zeros((3, N_LOC))
    for i, (n, off) in enumerate(zip(ns, offsets)):
        x[i, :n] = rng.rand(n, D)
        y[i, :n] = _objective(x[i, :n]) + off
    length = np.array([0.8, 0.6, 1.5 * 0.5**7 if case == "search" else 0.5])
    fail = np.array([0, 0, 1 if case == "search" else 0])
    stag = np.array([0, 0, 2])
    best = [int(np.argmin(y[i, :n])) for i, n in enumerate(ns)]
    keys = jax.random.split(jax.random.key(5), 3)
    return JT.TurboCarry(
        x_buf=jnp.asarray(x), y_buf=jnp.asarray(y), n=jnp.asarray(ns),
        raw=jax.vmap(lambda _: JG.default_params(D, JGPConfig(), jnp.float64))(jnp.arange(3)),
        tr=JT.TRState(jnp.asarray(length), jnp.asarray(np.zeros(3, int)), jnp.asarray(fail),
                      jnp.asarray(np.zeros(3, int)), jnp.asarray(stag)),
        init_stream=jax.vmap(lambda k: JS.latin_hypercube(k, 8, D, jnp.float64))(keys),
        best_x=jnp.asarray(np.stack([x[i, b] for i, b in enumerate(best)])),
        best_y=jnp.asarray(np.array([y[i, b] for i, b in enumerate(best)])),
        key=jax.random.split(jax.random.key(6), 3),
    )


@pytest.mark.parametrize("case", ["init", "search"])
def test_turbom_step_matches_jax(case):
    gp_kw = dict(kernel="matern52", fit_optimizer="grid+adam", fit_maxiter_warm=5, fit_lr=0.1)
    jgp, tgp = JGPConfig(**gp_kw), GPConfig(**gp_kw)
    tr_kw = dict(fail_tol=2, stagnation_tol=3)
    cfg_kw = dict(n_init=N_INIT, max_evals=200, batch_size=Q, n_candidates=N_CAND, ts_chunk=CHUNK)
    jcfg = JT.TurboConfig(**cfg_kw, tr=JTRConfig(**tr_kw))
    tcfg = TT.TurboConfig(**cfg_kw, tr=TRConfig(**tr_kw))
    m, fail_tol = 3, 2
    carries_j = _jax_carries(case)

    # the JAX step, and every draw it makes
    c1_j, x_sel_j, tr_idx_j, restart_keys = JM.turbom_propose_batch(carries_j, jcfg, jgp, m)
    k_step = jax.random.fold_in(carries_j.key[0], 0)
    k_prop, _ = jax.random.split(k_step)
    prop_keys = jax.random.split(k_prop, m)
    _, cands_j, values_j = jax.vmap(lambda c, k: JM._tr_proposals_and_values(c, k, jcfg, jgp, N_CAND))(
        carries_j, prop_keys)
    draws = []
    for i in range(m):
        k_ts = jax.random.split(prop_keys[i], 3)[2]
        chunk_keys = jax.random.split(k_ts, N_CAND // CHUNK)
        normals = jnp.concatenate([jax.random.normal(k, (Q, CHUNK), jnp.float64) for k in chunk_keys], axis=1)
        draws.append(TM.Draws(
            cands=torch.as_tensor(np.asarray(cands_j[i])), normals=torch.as_tensor(np.asarray(normals)),
            forcing=torch.as_tensor(np.asarray(jax.random.uniform(k_ts, (Q, 1), jnp.float64))),
        ))
    streams = torch.as_tensor(np.stack([np.asarray(JS.latin_hypercube(k, 8, D, jnp.float64)) for k in restart_keys]))
    y_sel = _objective(np.asarray(x_sel_j)) + 50.0  # no region improves
    c2_j, best_j = JM.turbom_absorb_batch(c1_j, x_sel_j, jnp.asarray(y_sel), tr_idx_j, restart_keys, jcfg, jgp, m, fail_tol)

    # the port from the same carries, with those draws
    carries_t = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carries_j._replace(key=None)))
    assert carries_t.n == tuple(int(v) for v in np.asarray(carries_j.n))
    c1_t, x_sel_t, tr_idx_t, cand_idx_t = TM.turbom_propose_batch(carries_t, tcfg, tgp, draws=draws)
    assert tr_idx_t == np.asarray(tr_idx_j).tolist()
    _, cand_ref = JM.global_allocate(values_j, None)
    assert cand_idx_t == np.asarray(cand_ref).tolist()
    np.testing.assert_allclose(x_sel_t.numpy(), np.asarray(x_sel_j), **F64)
    for name in JG.GPParams._fields:
        np.testing.assert_allclose(getattr(c1_t.raw, name).numpy(), np.asarray(getattr(c1_j.raw, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)
    c2_t, best_t = TM.turbom_absorb_batch(c1_t, x_sel_t, torch.as_tensor(y_sel), tr_idx_t, tcfg, fail_tol,
                                          restart_streams=streams)

    assert c2_t.n == tuple(int(v) for v in np.asarray(c2_j.n))
    for name in ("x_buf", "y_buf", "best_x", "best_y", "init_stream"):
        np.testing.assert_allclose(getattr(c2_t, name).numpy(), np.asarray(getattr(c2_j, name)), **F64, err_msg=name)
    for name in TT.TRState._fields:
        np.testing.assert_allclose(getattr(c2_t.tr, name).numpy(), np.asarray(getattr(c2_j.tr, name)), **F64, err_msg=name)
    np.testing.assert_allclose(float(best_t), float(best_j), **F64)
    counts = np.bincount(tr_idx_t, minlength=3)
    assert counts[1] == 0  # region 1 starved
    assert int(c2_t.tr.restarts[2]) == 1 and c2_t.n[2] == 0  # region 2 restarted
    if case == "init":
        assert counts[0] == Q and c2_t.n[0] == 4 + Q
    back = C.turbo_carry_to_numpy(c2_t)
    np.testing.assert_array_equal(back.n, np.asarray(c2_j.n))


def test_split_capacity_equals_uniform_capacity():
    """The largest region at the full capacity and the others on [:cap_b]
    views (masked padding is inactive) against every region at the full
    capacity: the same selections. The padding is not quite inert: the
    fixed jitter is relative to the mean of the padded diagonal (in the JAX
    package too), so the hypers of the regions fitted on views move at the
    1e-6·jitter-share level (rtol 1e-5), and the candidates their ARD
    weights shape at rtol 1e-7."""
    carries_j = _jax_carries("search")
    carries = C.turbo_carry_from_numpy(jax.tree.map(np.asarray, carries_j._replace(key=None)))
    gp = GPConfig(kernel="matern52", fit_optimizer="grid+adam", fit_maxiter_warm=5)
    cfg = TT.TurboConfig(n_init=N_INIT, max_evals=200, batch_size=Q, n_candidates=N_CAND, ts_chunk=CHUNK)
    outs = []
    for cap_b in (None, 16):
        g = torch.Generator().manual_seed(0)
        outs.append(TM.turbom_propose_batch(carries, cfg, gp, g, cap=N_LOC, cap_b=cap_b))
    (c_full, x_full, tr_full, cand_full), (c_split, x_split, tr_split, cand_split) = outs
    assert tr_full == tr_split and cand_full == cand_split
    np.testing.assert_allclose(x_split.numpy(), x_full.numpy(), rtol=1e-7)
    for a, b in zip(c_full.raw, c_split.raw):
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())  # the largest region: same program
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-12)


def test_optimize_turbom_cpu_improves_on_initial_design():
    bench = TB.get_benchmark("rover60")
    cfg = TRG.get_config("turbom5_rover60")
    res = optimize(bench.fn, bench.lb, bench.ub, 60, method="turbom", m=2, n_init=10, batch_size=10,
                   n_candidates=64, gp_config=cfg.gp, seed=0, device="cpu")
    assert np.all(np.isfinite(res.y_hist)) and np.isfinite(res.best_y)
    assert res.incumbent_trace.shape == (5,) and res.x_hist.shape == (50, 60)
    assert np.all(np.diff(res.incumbent_trace) <= 0)
    assert res.best_y < res.incumbent_trace[1]  # the best of the two 10-point initial designs
    assert res.best_y == pytest.approx(float(bench.fn(torch.as_tensor(res.best_x)[None])[0]), rel=1e-5)
    with pytest.raises(NotImplementedError):  # checkpointing is not ported yet
        optimize(bench.fn, bench.lb, bench.ub, 60, method="bo", checkpoint_path="run.ckpt", checkpoint_every=1,
                 device="cpu")
