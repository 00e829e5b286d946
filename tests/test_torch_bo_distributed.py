"""``turbojax_torch.bo_distributed.run_bo_distributed`` (large-N plain BO,
the dense route on one device) against ``turbojax.bo_distributed`` on the
CPU.

A ``fit_every=0`` EI loop fed JAX's initial design and per-iteration Sobol
candidates visits JAX's points (JAX runs that loop in float32 whatever x64
says, the port here in float64: the points are candidates, so they agree
while the same candidate wins; 1e-8). The cases of
``tests/test_bo_distributed.py`` that run without a mesh, at world size 1
(EI and LCB optimize, failures are imputed, ``fit_every=0`` never fits and
still learns, the rejections, pathwise Thompson sampling, the bilog warp),
and kill and resume (``tests/test_checkpoint.py``'s) bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import sampling as JS
from turbojax.bo import BOConfig as JBOConfig
from turbojax.bo_distributed import run_bo_distributed as j_run_bo_distributed
from turbojax.config import GPConfig as JGPConfig
from turbojax_torch import bo_distributed as BD
from turbojax_torch import checkpoint as CK
from turbojax_torch.bo import BOConfig
from turbojax_torch.config import GPConfig
from turbojax_torch.runlog import RunLog

torch.set_num_threads(1)

D = 3
CFG = dataclasses.replace(GPConfig(kernel="matern52"), fit_optimizer="adam", fit_maxiter=5)


def _quad(x):
    return torch.sum((x - 0.3) ** 2, dim=-1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_fixed_hyper_ei_loop_visits_jax_points():
    """fit_every=0 at the default hypers, EI: JAX's initial design and each
    iteration's Sobol candidates replayed from its key chain."""
    bo_kw = dict(n_init=10, max_evals=18, batch_size=4, acq="ei", n_candidates=48, fit_every=0)
    key = jax.random.key(0)
    res_j = j_run_bo_distributed(key, lambda x: jnp.sum((x - 0.3) ** 2, axis=-1), [0.0] * D, [1.0] * D,
                                 JBOConfig(**bo_kw), JGPConfig(kernel="matern52"))
    k_init, k_loop = jax.random.split(key)
    x0 = np.asarray(JS.latin_hypercube(k_init, bo_kw["n_init"], D))
    sobol = []
    for _ in range(JBOConfig(**bo_kw).n_iters):
        _, k_cand, _, _, k_loop = jax.random.split(k_loop, 5)
        sobol.append(np.asarray(JS.sobol_sample(k_cand, D, bo_kw["n_candidates"], jnp.float32)))
    f64 = torch.float64
    res_t = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, BOConfig(**bo_kw), GPConfig(kernel="matern52"),
                                  generator=_gen(), dtype=f64, x_init=torch.as_tensor(x0, dtype=f64),
                                  draws=lambda it: BD.IterationDraws(sobol=torch.as_tensor(sobol[it], dtype=f64)))
    np.testing.assert_allclose(res_t.x_hist.numpy(), np.asarray(res_j.x_hist), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.y_hist.numpy(), np.asarray(res_j.y_hist), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res_t.incumbent_trace.numpy(), np.asarray(res_j.incumbent_trace), rtol=1e-5)
    assert res_t.y_hist.shape == (18,) and res_t.incumbent_trace.shape == (2,)


@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_loop_optimizes(acq):
    """test_bo_distributed.py:23 and :44 without a mesh: the dense route."""
    bo = BOConfig(n_init=16, max_evals=56 if acq == "ei" else 40, batch_size=8, acq=acq,
                  n_candidates=128 if acq == "ei" else 64, fit_every=2)
    log = RunLog()
    res = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, bo, CFG, generator=_gen(), runlog=log)
    trace = res.incumbent_trace.numpy()
    assert res.y_hist.shape == (bo.max_evals,) and np.isfinite(trace).all()
    assert (np.diff(trace) <= 1e-12).all()
    assert float(res.best_y) < float(res.y_hist[:16].min())
    assert float(res.best_y) < (0.05 if acq == "ei" else 0.1)
    assert [r["iter"] for r in log.records] == list(range(bo.n_iters))
    assert all(r["route"] == "dense" for r in log.records) and log.records[-1]["n"] == bo.max_evals
    assert all(r["iter_s"] >= 0 for r in log.records)
    assert float(_quad(res.best_x[None])[0]) == pytest.approx(float(res.best_y), rel=1e-6)


def test_loop_imputes_failures():
    def spiky(x):
        base = torch.sum((x - 0.4) ** 2, dim=-1)
        return torch.where(x[:, 0] > 0.85, torch.nan, base)

    bo = BOConfig(n_init=8, max_evals=24, batch_size=4, acq="ei", n_candidates=64, fit_every=2)
    res = BD.run_bo_distributed(spiky, [0.0] * D, [1.0] * D, bo, CFG, generator=_gen())
    assert np.isfinite(res.y_hist.numpy()).all()
    assert float(res.best_y) < 1.0


def test_fixed_hypers_still_learn_and_never_fit(monkeypatch):
    """fit_every=0 pins the hypers, never fits (not even at iteration 0), and
    keeps refreshing the factorization over new data."""
    def boom(*a, **k):
        raise AssertionError("fit_gp_auto called despite fit_every=0")

    monkeypatch.setattr(BD, "fit_gp_auto", boom)
    bo = BOConfig(n_init=8, max_evals=32, batch_size=4, acq="ei", n_candidates=128, fit_every=0)
    res = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, bo, CFG, generator=_gen())
    assert np.isfinite(res.incumbent_trace.numpy()).all()
    assert float(res.best_y) < float(res.y_hist[:8].min())


def test_rejects_unsupported_acquisitions(monkeypatch):
    with pytest.raises(ValueError, match="'ei', 'lcb', or 'ts'"):
        BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D,
                              BOConfig(n_init=16, max_evals=32, batch_size=8, acq="ucb"), CFG, generator=_gen())
    with pytest.raises(ValueError, match="rff"):
        BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D,
                              BOConfig(n_init=16, max_evals=32, batch_size=8, acq="ts", ts_sampler="rff"), CFG,
                              generator=_gen())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, BOConfig(n_init=8, max_evals=16, batch_size=4), CFG)


def test_pathwise_ts_optimizes():
    bo = BOConfig(n_init=16, max_evals=64, batch_size=8, acq="ts", n_candidates=128, fit_every=2,
                  rff_features=256)
    res = BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, bo, CFG, generator=_gen())
    trace = res.incumbent_trace.numpy()
    assert np.isfinite(trace).all() and (np.diff(trace) <= 1e-12).all()
    assert float(res.best_y) < float(res.y_hist[:16].min())
    assert float(res.best_y) < 0.05


def test_dense_adapter_draws_the_dense_samplers_paths():
    """The dense route's adapter draws pathwise paths as ``acq.pathwise_paths``
    does on its state, with the same generator state and ``A.Draws``, bit for
    bit: the loop calls ``g.pathwise_paths`` on either route."""
    from turbojax_torch import acq as A
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L

    gen = _gen(3)
    x = torch.rand((20, D), generator=gen, dtype=torch.float64)
    y = _quad(x) + 0.01 * torch.randn(20, generator=gen, dtype=torch.float64)
    mask = L.row_mask(20, 20, x.device)
    state = G.make_gp_state(x, y, mask, G.default_params(D, CFG, torch.float64, x.device), CFG)
    adapter = DL._adapt_dense(state, y, mask, CFG)
    cands = torch.rand((32, D), generator=gen, dtype=torch.float64)
    draws = A.Draws(weights=torch.randn((4, 64), generator=gen, dtype=torch.float64))
    got = adapter.pathwise_paths(cands, 4, 64, _gen(7), draws)
    want = A.pathwise_paths(state, cands, 4, CFG, 64, _gen(7), draws)
    assert got.shape == (4, 32) and torch.equal(got, want)


def test_supports_y_warp():
    bo = BOConfig(n_init=16, max_evals=48, batch_size=8, acq="ei", n_candidates=128)
    res = BD.run_bo_distributed(lambda x: 50.0 * _quad(x) + 1.0, [0.0] * D, [1.0] * D, bo,
                                dataclasses.replace(CFG, y_warp="bilog"), generator=_gen())
    trace = res.incumbent_trace.numpy()
    assert np.isfinite(trace).all() and np.all(np.diff(trace) <= 1e-6)
    assert float(res.best_y) < 50.0 * 0.1 + 1.0


class _Boom(Exception):
    pass


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Killed at iteration 3 with a fit_every=2 cadence (the resumed run's
    first iteration refactorizes at the restored hypers) and local
    candidates: the resumed trace and history equal the uninterrupted run's
    bit for bit, and the RunLog has one record per resumed iteration."""
    cfg = BOConfig(n_init=8, max_evals=32, batch_size=4, acq="ei", n_candidates=64, fit_every=2, local_frac=0.25)
    gcfg = GPConfig(fit_restarts=2, fit_maxiter=3, fit_optimizer="adam")

    def run(**kw):
        return BD.run_bo_distributed(_quad, [0.0] * D, [1.0] * D, cfg, gcfg, generator=_gen(7), **kw)

    def boom(it, best):
        if it == 3:
            raise _Boom

    ref = run()
    path = str(tmp_path / "dbo_ck")
    with pytest.raises(_Boom):
        run(checkpoint_path=path, checkpoint_every=1, on_iteration=boom)
    assert CK.exists(path) and CK.load_meta(path)["it"] == 3
    log = RunLog()
    res = run(checkpoint_path=path, checkpoint_every=1, resume=True, runlog=log)
    assert torch.equal(res.incumbent_trace, ref.incumbent_trace) and torch.equal(res.y_hist, ref.y_hist)
    assert float(res.best_y) == float(ref.best_y)
    assert [r["iter"] for r in log.records] == list(range(3, cfg.n_iters))
    assert all(r["route"] == "dense" for r in log.records) and log.records[-1]["n"] == cfg.max_evals
    # a finished run's checkpoint returns it at once
    again = run(checkpoint_path=path, checkpoint_every=1, resume=True)
    assert torch.equal(again.incumbent_trace, ref.incumbent_trace)


