"""Checkpoint and resume in the port (the kill-and-resume tests of
``tests/test_checkpoint.py:114-200``, on the CPU): save → load round-trips
a carry (tensors and host ints) and a generator's state bit for bit; a run
of ``run_bo``, ``run_turbo1`` and ``run_turbom`` killed from
``on_iteration`` and resumed from its checkpoint gives the incumbent trace
of a run never stopped, bit for bit; ``optimize(resume=True)`` on a
finished run returns it; a restored ask/tell ``Optimizer`` asks what the
saved one would have. Also ``runlog``: the JSONL log, the profiler trace,
and ``start_profiler_server``'s repeated start."""

import json
import os

import numpy as np
import pytest
import torch

from turbojax_torch import Optimizer, optimize
from turbojax_torch import benchmarks as TB
from turbojax_torch import bo as TBO
from turbojax_torch import checkpoint as CK
from turbojax_torch import runlog as RL
from turbojax_torch import trust_region as TT
from turbojax_torch import turbo_m as TM
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

_GCFG = GPConfig(fit_restarts=2, fit_maxiter=3, fit_optimizer="adam")


class _Boom(Exception):
    pass


def _boom_at(k):
    def cb(it, best):
        if it == k:
            raise _Boom()

    return cb


def _quad(x):
    return ((x - 0.4) ** 2).sum(dim=-1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_round_trip_carries_and_generator_state(tmp_path):
    cfg = TT.TurboConfig(n_init=4, max_evals=20, batch_size=2, n_candidates=16)
    g = _gen(3)
    carries = TT.stack_carries([TT.make_turbo_carry(3, 12, cfg, _GCFG, g) for _ in range(2)])
    carries = carries._replace(y_buf=carries.y_buf.index_fill(1, torch.arange(4), 2.5), n=(4, 7))
    state = {"carry": carries, "rng": g.get_state(), "tags": ["a", 1, None, 0.5]}
    path = str(tmp_path / "ck.npz")
    CK.save_state(path, state, meta={"iteration": 7})
    assert CK.exists(path) and CK.load_meta(path) == {"iteration": 7}

    scratch = _gen(99)
    like = {"carry": TT.stack_carries([TT.make_turbo_carry(3, 0, cfg, _GCFG, scratch) for _ in range(2)]),
            "rng": scratch.get_state(), "tags": ["b", 0, None, 0.0]}
    restored = CK.load_state(path, like)
    assert restored["carry"].n == (4, 7) and restored["tags"] == ["a", 1, None, 0.5]
    for a, b in zip(TT.TurboCarry(*carries)._replace(n=None), restored["carry"]._replace(n=None)):
        if a is None:
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    after = _gen(0)
    after.set_state(restored["rng"])
    np.testing.assert_array_equal(torch.rand(5, generator=g).numpy(), torch.rand(5, generator=after).numpy())


def test_load_follows_the_like_state_and_rejects_another_structure(tmp_path):
    path = str(tmp_path / "x")
    CK.save_state(path, {"a": torch.arange(3.0, dtype=torch.float64)})
    got = CK.load_state(path, {"a": torch.zeros(1, dtype=torch.float32)})["a"]
    assert got.dtype == torch.float32 and got.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError):
        CK.load_state(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError):
        CK.load_state(path, {"a": 3})  # a host value where a tensor was saved
    with pytest.raises(TypeError):
        CK.save_state(path, {"a": object()})


def test_run_bo_checkpoint_resume(tmp_path):
    """A checkpointing run_bo killed at iteration 3 and resumed gives the
    uninterrupted trace and best bit for bit; fit_every=2 makes the resumed
    iteration's refit cadence and the restored hypers matter."""
    lb, ub = (0.0, 0.0), (1.0, 1.0)
    cfg = TBO.BOConfig(n_init=4, max_evals=16, batch_size=2, n_candidates=64, fit_every=2)
    ref = TBO.run_bo(_quad, lb, ub, cfg, _GCFG, _gen(3))
    path = str(tmp_path / "bo_ck")
    with pytest.raises(_Boom):
        TBO.run_bo(_quad, lb, ub, cfg, _GCFG, _gen(3), checkpoint_path=path, checkpoint_every=1,
                   on_iteration=_boom_at(3))
    assert CK.exists(path) and CK.load_meta(path) == {"it": 3}
    res = TBO.run_bo(_quad, lb, ub, cfg, _GCFG, _gen(12345), checkpoint_path=path, checkpoint_every=1, resume=True)
    assert torch.equal(res.incumbent_trace, ref.incumbent_trace)
    assert torch.equal(res.best_y, ref.best_y) and torch.equal(res.x_buf, ref.x_buf)


def test_run_turbo1_checkpoint_resume(tmp_path):
    lb, ub = (0.0,) * 3, (1.0,) * 3
    cfg = TT.TurboConfig(n_init=4, max_evals=16, batch_size=2, n_candidates=16)
    _, trace_ref = TT.run_turbo1(_quad, lb, ub, cfg, _GCFG, _gen(5))
    path = str(tmp_path / "t1_ck")
    with pytest.raises(_Boom):
        TT.run_turbo1_host(_quad, lb, ub, cfg, _GCFG, _gen(5), checkpoint_path=path, checkpoint_every=2,
                           on_iteration=_boom_at(3))
    assert CK.exists(path) and CK.load_meta(path) == {"it": 2}  # saved every 2 iterations
    _, trace = TT.run_turbo1(_quad, lb, ub, cfg, _GCFG, _gen(6), checkpoint_path=path, checkpoint_every=2,
                             resume=True)
    assert torch.equal(trace, trace_ref)


def test_run_turbom_checkpoint_resume(tmp_path):
    """TuRBO-m (m = 2) with restarts, per-region refit cadence and the
    rung-sized fit views: killed at iteration 5, resumed, the same trace."""
    lb, ub = (0.0,) * 3, (1.0,) * 3
    cfg = TT.TurboConfig(n_init=4, max_evals=28, batch_size=2, n_candidates=16, fit_every=2)
    _, trace_ref = TM.run_turbom(_quad, lb, ub, cfg, _GCFG, 2, _gen(7))
    path = str(tmp_path / "tm_ck")
    with pytest.raises(_Boom):
        TM.run_turbom(_quad, lb, ub, cfg, _GCFG, 2, _gen(7), checkpoint_path=path, checkpoint_every=2,
                      on_iteration=_boom_at(5))
    assert CK.exists(path)
    _, trace = TM.run_turbom(_quad, lb, ub, cfg, _GCFG, 2, _gen(8), checkpoint_path=path, checkpoint_every=2,
                             resume=True)
    assert torch.equal(trace, trace_ref)


@pytest.mark.parametrize("method", ["bo", "turbo1", "turbom"])
def test_optimize_resume_kwarg(method, tmp_path):
    """``optimize(..., checkpoint_path, resume=True)``: a fresh start writes
    checkpoints; resuming the finished run returns it at once."""
    path = str(tmp_path / "opt_ck")
    kw = dict(max_evals=14, method=method, n_init=4, batch_size=2, seed=1, m=2, gp_config=_GCFG, n_candidates=16,
              checkpoint_path=path, checkpoint_every=2, device="cpu")
    ref = optimize(_quad, (0.0, 0.0), (1.0, 1.0), **kw)
    assert CK.exists(path) and CK.load_meta(path)["it"] == len(ref.incumbent_trace)
    res = optimize(_quad, (0.0, 0.0), (1.0, 1.0), resume=True, **kw)
    np.testing.assert_array_equal(res.incumbent_trace, ref.incumbent_trace)
    np.testing.assert_array_equal(res.x_hist, ref.x_hist)
    assert res.best_y == ref.best_y


@pytest.mark.parametrize("method", ["turbo1", "bo", "turbom"])
def test_optimizer_save_restore_continues_identically(method, tmp_path):
    """Save mid-run, restore into a fresh Optimizer, continue: the next
    asks equal the original's, and so do the histories and traces (for
    "bo" the save falls after the initial design, so the carry is saved)."""
    b = TB.get_benchmark("branin")

    def mk(**kw):
        return Optimizer(b.lb, b.ub, method=method, n_init=4, max_evals=20, batch_size=2, gp_config=_GCFG,
                         n_candidates=16, seed=7, m=2, device="cpu", **kw)

    def f(x):
        return b.fn(torch.as_tensor(x)).numpy()

    path = str(tmp_path / "opt")
    a = mk(checkpoint_path=path, checkpoint_every=3)
    for _ in range(3):
        xs = a.ask()
        a.tell(xs, f(xs))
    assert CK.exists(path) and CK.load_meta(path)["n_tells"] == 3
    c = mk().restore(path)
    for _ in range(2):
        xa, xc = a.ask(), c.ask()
        np.testing.assert_array_equal(xa, xc)
        a.tell(xa, f(xa))
        c.tell(xc, f(xc))
    assert c.best[1] == a.best[1] and c._trace == a._trace and c._n_tells == a._n_tells == 5
    np.testing.assert_array_equal(np.concatenate(c._history_x), np.concatenate(a._history_x))


def test_runlog_jsonl_profile_and_profiler_server(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    with RL.RunLog(path, verbose=True) as log:
        log.log(0, best_y=1.5, tr_length=0.8)
        log.log(1, best_y=np.float32(1.25), n=3)
    recs = [json.loads(line) for line in open(path)]
    assert [r["iter"] for r in recs] == [0, 1] and recs[1]["best_y"] == 1.25 and recs[1]["n"] == 3
    assert log.records[0]["tr_length"] == 0.8
    out = capsys.readouterr().out
    assert "[   0] best = 1.500000  L=0.8000" in out and "[   1] best = 1.250000" in out
    trace_dir = str(tmp_path / "traces")
    with RL.profile(trace_dir):
        with RL.span("fit"):
            torch.ones(8).sum()
    (name,) = os.listdir(trace_dir)
    assert '"fit"' in open(os.path.join(trace_dir, name)).read()
    with RL.profile(None):
        pass
    try:
        assert RL.start_profiler_server(9999, trace_dir=str(tmp_path / "on_demand")) == 9999
        assert RL.start_profiler_server(9999) == 9999  # a repeated start is a no-op
    finally:
        RL._stop_profiler_server()
