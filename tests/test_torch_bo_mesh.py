"""``run_bo_distributed(mesh=)`` and ``optimize(mesh=)`` of the port on
meshes of D = 1 and 2 gloo ranks, against ``turbojax.bo_distributed`` on a
mesh of the same size.

D = 1 runs in this process, D = 2 in one spawned group
(``tests/torch_mesh_cases.py``) while the JAX references are computed here
(compiled: ``tests/jax_mesh_refs.py``). The BO loop replays JAX's initial
design and per-iteration Sobol candidates for two iterations, forced onto
the distributed route (``budget_bytes=1``: fitted by Adam at iteration 0,
refactored at 1): at D = 2 it visits JAX's points (JAX runs that loop in
float32: points to 1e-6, values to rtol 1e-5); at D = 1 the route is dense
whatever the budget, and the port's dense loop is held against JAX in
``tests/test_torch_bo_distributed.py``. With a dense GP at fixed hypers the
sharded candidate axis (``cand_shard_min=0``) visits the points of the
unsharded loop. ``optimize(mesh=)``
runs plain BO (EI and pathwise TS, the distributed route on D = 2) and
TuRBO-m with its regions sharded; a checkpointed run (rank 0 writes) resumes
to the same result. With n_init 7 and q = 3 (the padded layout) the loop,
forced distributed and fitted by Adam, visits the dense route's points.
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
from turbojax import parallel as JPAR
from turbojax import sampling as JS
from turbojax.bo import BOConfig as JBOConfig
from turbojax.bo_distributed import run_bo_distributed as j_run_bo_distributed
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch.bo import BOConfig
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

WORLDS = (1, 2)
DIM, BO_SEED = 3, 24
BO_KW = dict(n_init=8, max_evals=12, batch_size=2, acq="ei", n_candidates=48)
BO_GP = dict(kernel="matern52", fit_optimizer="adam", fit_maxiter=3, fit_restarts=1)
# name: (the BOConfig's other settings, budget_bytes); JAX runs the first
# q = 3 from 7 points, fitted by Adam at iterations 0 and 2: the padded layout's fit
BO_ODD = dict(n_init=7, max_evals=16, batch_size=3, acq="ts", n_candidates=48, fit_every=2)
BO_CASES = {"bo_distributed": ({"fit_every": 2}, 1),
            "bo_cand_sharded": ({"fit_every": 0, "cand_shard_min": 0}, 1 << 40),
            "bo_dense": ({"fit_every": 0}, 1 << 40)}


@jax.jit
def _jax_bo_draws():
    k_init, k_loop = jax.random.split(jax.random.key(BO_SEED))
    x0 = JS.latin_hypercube(k_init, BO_KW["n_init"], DIM)
    sobol = []
    for _ in range(JBOConfig(**BO_KW).n_iters):
        _, k_cand, _, _, k_loop = jax.random.split(k_loop, 5)
        sobol.append(JS.sobol_sample(k_cand, DIM, BO_KW["n_candidates"], jnp.float32))
    return x0, sobol


@functools.lru_cache(maxsize=1)
def _bo_draws():
    """JAX's initial design and per-iteration Sobol candidates of
    ``run_bo_distributed(key(BO_SEED), ...)``."""
    return jax.tree.map(np.asarray, _jax_bo_draws())


def _jobs(tmp_dir):
    x0, sobol = _bo_draws()
    common = dict(config=GPConfig(**BO_GP), x_init=x0, sobol=sobol)
    rng = np.random.RandomState(5)
    odd = dict(config=GPConfig(**BO_GP), x_init=rng.rand(BO_ODD["n_init"], DIM),
               sobol=[rng.rand(BO_ODD["n_candidates"], DIM) for _ in range(3)])
    return [*((name, "bo_loop", dict(bo=BOConfig(**BO_KW, **extra), budget_bytes=budget, **common))
              for name, (extra, budget) in BO_CASES.items()),
            ("optimize", "optimize_runs", dict(tmp_dir=tmp_dir)),
            ("bo_odd_fit", "bo_loop", dict(bo=BOConfig(**BO_ODD), budget_bytes=1, **odd))]


def _jax_refs(world):
    mesh = JPAR.make_mesh(world, axis="rows")
    ref = {}
    for name in ("bo_distributed",):
        extra, budget = BO_CASES[name]
        res = j_run_bo_distributed(jax.random.key(BO_SEED), lambda x: jnp.sum((x - 0.3) ** 2, axis=-1), [0.0] * DIM,
                                   [1.0] * DIM, JBOConfig(**BO_KW, **extra), JGPConfig(**BO_GP), mesh,
                                   budget_bytes=budget)
        ref[name] = {"x_hist": np.asarray(res.x_hist), "y_hist": np.asarray(res.y_hist),
                     "trace": np.asarray(res.incumbent_trace)}
    return ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: (each rank's outputs, JAX's at D = 2)}; the spawned group
    runs while the world-1 cases and the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("bo_mesh")
    for w in WORLDS:
        (tmp / f"ckpt{w}").mkdir()
    spawned = {w: TMC.Spawned(w, _jobs(str(tmp / f"ckpt{w}")), tmp) for w in WORLDS if w > 1}
    with TMC.world1_group(tmp) as mesh:
        ports = {1: [TMC.run_jobs(_jobs(str(tmp / "ckpt1")), mesh)]}
    with jax_compiled():
        refs = {w: _jax_refs(w) for w in WORLDS if w > 1}
    for w, group in spawned.items():
        ports[w] = group.wait()
    return {w: (ports[w], refs.get(w, {})) for w in WORLDS}


def _case(results, world, case):
    ranks, ref = results[world]
    return TMC.same_on_every_rank(ranks, case), ref.get(case)


@pytest.mark.parametrize("world", WORLDS)
def test_run_bo_distributed_on_a_mesh_visits_jax_points(results, world):
    """Two iterations from JAX's draws, forced distributed; on one device
    the dense route (whatever the budget), compared with JAX on two."""
    got, want = _case(results, world, "bo_distributed")
    assert got["distributed"].tolist() == [world > 1] * 2
    assert np.isfinite(got["y_hist"]).all() and got["x_hist"].shape == (BO_KW["max_evals"], DIM)
    if world > 1:
        np.testing.assert_allclose(got["x_hist"], want["x_hist"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["y_hist"], want["y_hist"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["trace"], want["trace"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_candidate_axis_picks_the_dense_points(results, world):
    """The candidate axis sharded (``cand_shard_min=0``) visits the points
    the unsharded dense loop visits (``parallel.sharded_acq_topq`` itself
    is held against JAX in ``tests/test_torch_parallel.py``)."""
    sharded, _ = _case(results, world, "bo_cand_sharded")
    dense, _ = _case(results, world, "bo_dense")
    assert not sharded["distributed"].any() and not dense["distributed"].any()
    np.testing.assert_allclose(sharded["x_hist"], dense["x_hist"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sharded["y_hist"], dense["y_hist"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", ["bo", "turbom", "ts"])
def test_optimize_on_a_mesh(results, world, label):
    got, _ = _case(results, world, "optimize")
    y, trace = got[f"{label}_y_hist"], got[f"{label}_trace"]
    assert np.isfinite(y).all() and np.isfinite(trace).all() and (np.diff(trace) <= 0).all()
    assert float(got[f"{label}_best_y"]) == pytest.approx(float(trace[-1]))
    assert float(got[f"{label}_best_y"]) <= float(y.min()) + 1e-12
    assert got[f"{label}_best_x"].shape == (2,)


@pytest.mark.parametrize("world", WORLDS)
def test_optimize_on_a_mesh_resumes_its_checkpoint(results, world):
    got, _ = _case(results, world, "optimize")
    np.testing.assert_array_equal(got["resumed_trace"], got["ckpt_trace"])
    np.testing.assert_array_equal(got["resumed_y_hist"], got["ckpt_y_hist"])


@pytest.mark.parametrize("world", WORLDS)
def test_padded_fit_visits_the_dense_points(results, world):
    """n_init 7 and q = 3, forced onto the row-sharded GP on D = 2: the
    Adam fits of the padded MLL at iterations 0 and 2 and the pathwise
    draws visit the points of the dense route on one device."""
    got, _ = _case(results, world, "bo_odd_fit")
    dense, _ = _case(results, 1, "bo_odd_fit")
    assert got["distributed"].tolist() == [world > 1] * 3 and not dense["distributed"].any()
    np.testing.assert_allclose(got["x_hist"], dense["x_hist"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["y_hist"], dense["y_hist"], rtol=1e-9)
