"""The port's ``parallel`` (candidate, restart and trust-region sharding)
on meshes of D = 1 and 2 gloo ranks, against ``turbojax.parallel`` on
meshes of the same size, in float64.

D = 1 runs in this process, D = 2 in one spawned group
(``tests/torch_mesh_cases.py``) while the JAX references are computed here
(compiled: ``tests/jax_mesh_refs.py``). JAX's draws are injected: the
per-shard Thompson normals (``fold_in`` by device), the restart inits, the
TuRBO-m regions' candidates, Thompson normals, forcing uniforms and
restart streams (``fold_in`` by region).

Checks: ``sharded_acq_topq`` (EI and LCB) and ``sharded_thompson_select``
give the same points (1e-12); ``sharded_fit_gp`` the same hypers (rtol
1e-8); ``sharded_turbom_step`` over m = 4 regions with the grid fit and
one joint Thompson chunk (one region in its init phase, one starved, one
starved into its stagnation restart, and a failed evaluation imputed
against the global history) the same allocation and carries (rtol 1e-10).
Replicated results must be equal on every rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as TMC
from jax_mesh_refs import jax_compiled
from turbojax import gp as JG
from turbojax import parallel as JPAR
from turbojax import sampling as JS
from turbojax import trust_region as JT
from turbojax import turbo_m as JM
from turbojax.config import GPConfig as JGPConfig
from turbojax.config import TRConfig as JTRConfig
from turbojax_torch import gp as TG
from turbojax_torch import trust_region as TT
from turbojax_torch.config import GPConfig, TRConfig

torch.set_num_threads(1)

WORLDS = (1, 2)
N, DIM, N_CAND, Q = 24, 3, 64, 4
RNG = np.random.RandomState(11)
X = RNG.rand(N, DIM)
Y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * RNG.randn(N)
CANDS = RNG.rand(N_CAND, DIM)
RAW = JG.GPParams(raw_lengthscale=np.array([-0.3, 0.2, 0.4]), raw_outputscale=np.asarray(0.1),
                  raw_noise=np.asarray(-3.0), raw_mean=np.asarray(0.0))
BEST = float(Y.min())
TS_SEED, FIT_SEED, STEP_SEED = 21, 22, 23
FIT_KW = dict(kernel="matern52", fit_optimizer="adam", fit_maxiter=5, fit_restarts=4)

# TuRBO-m: m = 4 regions of capacity 48, d = 4
TM_D, TM_LOC, TM_Q, TM_INIT, TM_CAND, TM_M, FAIL_TOL = 4, 48, 4, 8, 64, 4, 2
TM_GP = dict(kernel="matern52", fit_optimizer="grid")
TM_CFG = dict(n_init=TM_INIT, max_evals=200, batch_size=TM_Q, n_candidates=TM_CAND)  # one joint TS chunk
TM_TR = dict(fail_tol=FAIL_TOL, stagnation_tol=3)



def _objective(x):
    return np.sum((x - 0.3) ** 2, axis=-1) + 0.1 * np.sin(9 * x[:, 0])


@functools.lru_cache(maxsize=1)
def _jax_carries():
    """Four regions: 0 in its init phase (the forced init slots take the
    whole batch), 1 starved (its history 100 above the others), 2 five
    below, starved into its stagnation restart, 3 searching."""
    ns, offsets = (4, 20, 16, 12), (0.0, 100.0, -5.0, 0.0)
    rng = np.random.RandomState(12)
    x = np.zeros((TM_M, TM_LOC, TM_D))
    y = np.zeros((TM_M, TM_LOC))
    for i, (n, off) in enumerate(zip(ns, offsets)):
        x[i, :n] = rng.rand(n, TM_D)
        y[i, :n] = _objective(x[i, :n]) + off
    best = [int(np.argmin(y[i, :n])) for i, n in enumerate(ns)]
    raw = JG.default_params(TM_D, JGPConfig(), jnp.float64)
    return JT.TurboCarry(
        x_buf=jnp.asarray(x), y_buf=jnp.asarray(y), n=jnp.asarray(ns),
        raw=JG.GPParams(*(jnp.asarray(np.repeat(np.asarray(a)[None], TM_M, axis=0)) for a in raw)),
        tr=JT.TRState(jnp.asarray([0.8, 0.6, 1.5 * 0.5**7, 0.4]), jnp.zeros(TM_M, int),
                      jnp.asarray([0, 0, 1, 0]), jnp.zeros(TM_M, int), jnp.asarray([0, 0, 2, 0])),
        init_stream=jnp.asarray(rng.rand(TM_M, TM_INIT, TM_D)),
        best_x=jnp.asarray(np.stack([x[i, b] for i, b in enumerate(best)])),
        best_y=jnp.asarray(np.array([y[i, b] for i, b in enumerate(best)])),
        key=jax.random.split(jax.random.key(6), TM_M),
    )


TM_JCFG = JT.TurboConfig(**TM_CFG, tr=JTRConfig(**TM_TR))
TM_TCFG = TT.TurboConfig(**TM_CFG, tr=TRConfig(**TM_TR))


def _jax_turbom_fn(x):
    return (jnp.sum((x - 0.3) ** 2, axis=-1) + 50.0).at[1].set(jnp.nan)


@jax.jit
def _jax_turbom_draws(carries):
    prop = jnp.stack([jax.random.fold_in(jax.random.key(STEP_SEED), i) for i in range(TM_M)])
    restart = jnp.stack([jax.random.fold_in(jax.random.key(STEP_SEED), TM_M + i) for i in range(TM_M)])
    _, cands, values = jax.vmap(lambda c, k: JM._tr_proposals_and_values(c, k, TM_JCFG, JGPConfig(**TM_GP), TM_CAND))(
        carries, prop)
    k_ts = jax.vmap(lambda k: jax.random.split(k, 3)[2])(prop)
    normals = jax.vmap(lambda k: jax.random.normal(k, (TM_Q, TM_CAND), jnp.float64))(k_ts)
    forcing = jax.vmap(lambda k: jax.random.uniform(k, (TM_Q, 1), jnp.float64))(k_ts)
    streams = jax.vmap(lambda k: JS.latin_hypercube(k, TM_INIT, TM_D, jnp.float64))(restart)
    return cands, normals, forcing, streams, JM.global_allocate(values, None)


@functools.lru_cache(maxsize=1)
def _turbom_draws():
    """Per region, the draws JAX's sharded step makes (its keys folded by
    region id), and the (tr_idx, cand_idx) of its allocation."""
    cands, normals, forcing, streams, alloc = jax.tree.map(np.asarray, _jax_turbom_draws(_jax_carries()))
    draws = [{"cands": cands[i], "normals": normals[i], "forcing": forcing[i]} for i in range(TM_M)]
    return draws, streams, alloc


def _numpy_carries(c):
    """The JAX carries as the port's NamedTuples of numpy leaves."""
    return TT.TurboCarry(
        x_buf=np.asarray(c.x_buf), y_buf=np.asarray(c.y_buf), n=np.asarray(c.n),
        raw=TG.GPParams(*(np.asarray(a) for a in c.raw)), tr=TT.TRState(*(np.asarray(a) for a in c.tr)),
        init_stream=np.asarray(c.init_stream), best_x=np.asarray(c.best_x), best_y=np.asarray(c.best_y))


def _restart_uniforms(key, n, d_eff):
    """The [0, 1) draws behind ``turbojax.gp.sample_restart_params(key, ...)``,
    in the port's column order."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.concatenate([np.asarray(jax.random.uniform(k1, (n, d_eff), jnp.float64)),
                           np.asarray(jax.random.uniform(k2, (n,), jnp.float64))[:, None],
                           np.asarray(jax.random.uniform(k3, (n,), jnp.float64))[:, None]], axis=1)


def _shard_normals(world):
    shard = N_CAND // world
    key = jax.random.key(TS_SEED)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, dev), (Q, shard), jnp.float64))
                     for dev in range(world)])


def _jobs(world):
    cfg = GPConfig(kernel="matern52")
    draws, streams, _ = _turbom_draws()
    return [
        ("acq_ei", "acq_topq", dict(x=X, y=Y, raw=RAW, config=cfg, cands=CANDS, q=Q, acq="ei", best=BEST)),
        ("acq_lcb", "acq_topq", dict(x=X, y=Y, raw=RAW, config=cfg, cands=CANDS, q=Q, acq="lcb", best=BEST)),
        ("thompson", "thompson", dict(x=X, y=Y, raw=RAW, config=cfg, cands=CANDS, q=Q,
                                      normals=_shard_normals(world))),
        ("sharded_fit", "sharded_fit", dict(x=X, y=Y, config=GPConfig(**FIT_KW),
                                            uniforms=_restart_uniforms(jax.random.key(FIT_SEED), 3, DIM))),
        ("turbom_step", "turbom_step", dict(carries=_numpy_carries(_jax_carries()), cfg=TM_TCFG,
                                            config=GPConfig(**TM_GP), draws=draws, restart_streams=streams,
                                            n_cand=TM_CAND, fail_tol=FAIL_TOL)),
    ]


@functools.partial(jax.jit, static_argnames=("mesh",))
def _jax_turbom_step(carries, mesh):
    return JPAR.sharded_turbom_step(carries, jax.random.key(STEP_SEED), _jax_turbom_fn, jnp.zeros(TM_D),
                                    jnp.ones(TM_D), TM_JCFG, JGPConfig(**TM_GP), mesh, TM_CAND, FAIL_TOL)


def _jax_refs(world):
    mesh = JPAR.make_mesh(world, axis="rows")
    a = jnp.asarray
    jcfg = JGPConfig(kernel="matern52")
    mask = jnp.ones(N, bool)
    state = JG.make_gp_state(a(X), a(Y), mask, JG.GPParams(*map(a, RAW)), jcfg)
    ref = {}
    for acq in ("ei", "lcb"):
        pts, scores = JPAR.sharded_acq_topq(state, a(CANDS), a(BEST), Q, mesh, jcfg, acq=acq, kappa=2.0, xi=0.01)
        ref[f"acq_{acq}"] = {"points": pts, "scores": scores}
    pts, vals = JPAR.sharded_thompson_select(jax.random.key(TS_SEED), state, a(CANDS), Q, mesh, jcfg)
    ref["thompson"] = {"points": pts, "values": vals}
    fitted = JPAR.sharded_fit_gp(jax.random.key(FIT_SEED), a(X), a(Y), mask, JGPConfig(**FIT_KW), mesh)
    ref["sharded_fit"] = {f"raw_{i}": v for i, v in enumerate(fitted.raw)}
    carries, best = _jax_turbom_step(_jax_carries(), mesh)
    _, _, (tr_idx, cand_idx) = _turbom_draws()
    ref["turbom_step"] = {"best": best, "tr_idx": tr_idx, "cand_idx": cand_idx, "n": carries.n,
                          **{k: getattr(carries, k) for k in ("x_buf", "y_buf", "best_x", "best_y", "init_stream")},
                          **{f"tr_{f}": getattr(carries.tr, f) for f in JT.TRState._fields},
                          **{f"raw_{f}": getattr(carries.raw, f) for f in JG.GPParams._fields}}
    return {case: {k: np.asarray(v) for k, v in vals.items()} for case, vals in ref.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: (each rank's outputs, JAX's)}; the spawned group runs while
    the world-1 cases and the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("parallel")
    spawned = {w: TMC.Spawned(w, _jobs(w), tmp) for w in WORLDS if w > 1}
    with TMC.world1_group(tmp) as mesh:
        ports = {1: [TMC.run_jobs(_jobs(1), mesh)]}
    with jax_compiled():
        refs = {w: _jax_refs(w) for w in WORLDS}
    for w, group in spawned.items():
        ports[w] = group.wait()
    return {w: (ports[w], refs[w]) for w in WORLDS}


def _case(results, world, case):
    ranks, ref = results[world]
    return TMC.same_on_every_rank(ranks, case), ref.get(case)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_sharded_acq_topq_matches_jax(results, world, acq):
    got, want = _case(results, world, f"acq_{acq}")
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_thompson_select_matches_jax(results, world):
    got, want = _case(results, world, "thompson")
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["values"], want["values"], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_gp_matches_jax(results, world):
    got, want = _case(results, world, "sharded_fit")
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=1e-8, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_turbom_step_matches_jax(results, world):
    got, want = _case(results, world, "turbom_step")
    np.testing.assert_array_equal(got["tr_idx"], want["tr_idx"])
    np.testing.assert_array_equal(got["cand_idx"], want["cand_idx"])
    np.testing.assert_array_equal(got["n"], want["n"])
    for name, v in want.items():
        if name in ("tr_idx", "cand_idx", "n"):
            continue
        np.testing.assert_allclose(got[name], v, rtol=1e-10, atol=1e-12, err_msg=name)
    counts = np.bincount(got["tr_idx"], minlength=TM_M)
    assert counts[1] == 0 and got["n"][2] == 0 and got["tr_restarts"][2] == 1  # starved; restarted
    assert np.isfinite(got["y_buf"]).all() and got["y_buf"].max() > 50.0  # the failure imputed above the history
