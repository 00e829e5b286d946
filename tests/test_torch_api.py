"""The port's user API on the CPU (``device="cpu"``): the cases of
``tests/test_api.py`` and ``tests/test_constructors.py`` for
``turbojax_torch``: ``optimize`` with every method, the ask/tell
``Optimizer`` with a numpy-only objective (TuRBO-1, plain BO with NaN
imputation, TuRBO-m and its tell-follows-ask rule, the capacity guard, the
``optimize`` loop), ``Turbo1`` and ``TurboM``. Without ``device=`` every
entry point asks for the GPU and, with none there, raises naming
``device="cpu"``; what is not ported raises ``NotImplementedError``."""

import numpy as np
import pytest
import torch

from turbojax_torch import Optimizer, Turbo1, TurboM, optimize
from turbojax_torch import benchmarks as B
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

GCFG = GPConfig(fit_restarts=2, fit_maxiter=15)


def _host(b):
    """The benchmark as a numpy-only black box."""
    return lambda xs: b.fn(torch.as_tensor(np.asarray(xs))).numpy()


def test_optimize_bo():
    b = B.get_benchmark("branin")
    res = optimize(b.fn, b.lb, b.ub, max_evals=18, method="bo", n_init=8, batch_size=1, acq="ei", gp_config=GCFG,
                   n_candidates=64, fit_every=2, device="cpu")
    assert res.y_hist.shape == (18,) and res.x_hist.shape == (18, 2) and res.incumbent_trace.shape == (10,)
    assert res.best_y == pytest.approx(res.y_hist.min())
    assert float(b(torch.as_tensor(res.best_x))[0]) == pytest.approx(res.best_y, rel=1e-4)


@pytest.mark.parametrize("acq", ["lcb", "ts"])
def test_optimize_bo_other_acquisitions(acq):
    b = B.get_benchmark("branin")
    res = optimize(b.fn, b.lb, b.ub, max_evals=16, method="bo", n_init=8, batch_size=2, acq=acq, gp_config=GCFG,
                   n_candidates=64, device="cpu")
    assert res.y_hist.shape == (16,) and np.all(np.isfinite(res.y_hist))
    assert np.all(np.diff(res.incumbent_trace) <= 0)


def test_optimize_turbo1():
    b = B.get_benchmark("ackley10")
    res = optimize(b.fn, b.lb, b.ub, max_evals=40, method="turbo1", n_init=10, batch_size=5, gp_config=GCFG,
                   n_candidates=64, device="cpu")
    assert res.best_y < 18.0
    assert np.all(res.best_x >= np.asarray(b.lb)) and np.all(res.best_x <= np.asarray(b.ub))


def test_optimize_turbom():
    b = B.get_benchmark("branin")
    res = optimize(b.fn, b.lb, b.ub, max_evals=30, method="turbom", m=2, n_init=6, batch_size=3, gp_config=GCFG,
                   n_candidates=32, device="cpu")
    assert np.isfinite(res.best_y) and res.incumbent_trace.shape[0] > 0


def test_optimize_rejects_unknown_and_unported():
    b = B.get_benchmark("branin")
    with pytest.raises(ValueError, match="unknown method"):
        optimize(b.fn, b.lb, b.ub, max_evals=10, method="cma", device="cpu")
    with pytest.raises(NotImplementedError):
        optimize(b.fn, b.lb, b.ub, max_evals=10, method="bo", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        optimize(b.fn, b.lb, b.ub, max_evals=10, method="bo", resume=True, checkpoint_path="x", device="cpu")


def test_ask_tell_turbo1_black_box():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="turbo1", n_init=6, max_evals=30, batch_size=3, gp_config=GCFG,
                    n_candidates=32, seed=1, device="cpu")
    f = _host(b)
    lb, ub = np.asarray(b.lb), np.asarray(b.ub)
    for _ in range(8):
        xs = opt.ask()
        assert isinstance(xs, np.ndarray) and xs.shape == (3, 2)
        assert np.all(xs >= lb - 1e-6) and np.all(xs <= ub + 1e-6)
        opt.tell(xs, f(xs))
    _, by = opt.best
    assert by == pytest.approx(min(np.concatenate(opt._history_y)))
    assert by < 25.0


def test_ask_tell_bo_with_nan_imputation():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="bo", n_init=4, max_evals=12, batch_size=2, acq="ei", gp_config=GCFG,
                    n_candidates=32, seed=2, device="cpu")
    f = _host(b)
    for i in range(5):
        xs = opt.ask()
        ys = f(xs).copy()
        if i == 2:
            ys[0] = np.nan  # a failed evaluation
        opt.tell(xs, ys)
        assert (opt._carry is None) == (i < 1)  # the carry is built once n_init points are told
    ys_all = np.concatenate(opt._history_y)
    assert np.all(np.isfinite(ys_all)) and np.isfinite(opt.best[1])
    assert opt._carry.n == 10 and ys_all[4] > np.delete(ys_all, 4).max()  # the penalty ranks worst


def test_ask_tell_bo_all_failed_first_batch_hits_the_floor():
    """An all-failed batch with no history must not produce a penalty that
    ranks as the best: it gets the 1e6 floor."""
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="bo", n_init=4, max_evals=12, batch_size=2, gp_config=GCFG, n_candidates=32,
                    device="cpu")
    xs = opt.ask()
    opt.tell(xs, np.array([np.nan, np.inf]))
    assert np.all(opt._history_y[0] >= 1e6)
    xs = opt.ask()
    opt.tell(xs, _host(b)(xs))
    assert opt.best[1] < 1e3


def test_ask_tell_bo_pads_an_init_design_that_ends_mid_batch():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="bo", n_init=5, max_evals=14, batch_size=3, acq="lcb", gp_config=GCFG,
                    n_candidates=32, device="cpu")
    f = _host(b)
    first = opt.ask()
    opt.tell(first, f(first))
    xs = opt.ask()  # rows 3-4 of the design, padded with one fresh point
    assert xs.shape == (3, 2)
    np.testing.assert_allclose(xs[:2], np.asarray(b.lb) + opt._init_x[3:5].numpy() * (np.asarray(b.ub) - np.asarray(b.lb)),
                               rtol=1e-6)
    opt.tell(xs, f(xs))
    assert opt._carry is not None and opt._carry.n == 6
    xs = opt.ask()
    opt.tell(xs, f(xs))
    assert opt._carry.n == 9


def test_ask_tell_turbom():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="turbom", m=2, n_init=4, max_evals=40, batch_size=4, gp_config=GCFG,
                    n_candidates=32, seed=3, device="cpu")
    f = _host(b)
    lb, ub = np.asarray(b.lb), np.asarray(b.ub)
    for _ in range(9):
        xs = opt.ask()
        assert xs.shape == (4, 2)
        assert np.all(xs >= lb - 1e-5) and np.all(xs <= ub + 1e-5)
        opt.tell(xs, f(xs))
    assert opt.best[1] < 25.0
    assert sum(opt._carry.n) == 9 * 4  # every evaluated point landed in exactly one region


def test_turbom_tell_requires_matching_ask():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="turbom", m=2, n_init=4, max_evals=20, batch_size=2, gp_config=GCFG,
                    n_candidates=16, device="cpu")
    with pytest.raises(ValueError, match="ask"):
        opt.tell(np.zeros((2, 2)), np.zeros(2))  # no ask yet
    xs = opt.ask()
    n_hist_before = len(opt._history_y)
    with pytest.raises(ValueError, match="ask"):
        opt.tell(np.asarray(xs) + 0.5, np.zeros(2))  # other points
    assert len(opt._history_y) == n_hist_before  # a rejected tell leaves no trace


def test_tell_capacity_guard():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="turbo1", n_init=4, max_evals=8, batch_size=4, gp_config=GCFG,
                    n_candidates=16, device="cpu")
    f = _host(b)
    for _ in range(2):
        xs = opt.ask()
        opt.tell(xs, f(xs))
    with pytest.raises(ValueError, match="capacity"):
        opt.tell(opt.ask(), np.zeros(4))
    bo = Optimizer(b.lb, b.ub, method="bo", n_init=4, max_evals=6, batch_size=2, gp_config=GCFG, n_candidates=16,
                   device="cpu")
    for _ in range(3):
        xs = bo.ask()
        bo.tell(xs, f(xs))
    with pytest.raises(ValueError, match="capacity"):
        bo.tell(bo.ask(), np.zeros(2))


def test_optimizer_optimize_loop():
    b = B.get_benchmark("branin")
    opt = Optimizer(b.lb, b.ub, method="turbo1", n_init=6, max_evals=24, batch_size=3, gp_config=GCFG,
                    n_candidates=32, device="cpu")
    res = opt.optimize(_host(b))
    assert res.y_hist.shape[0] >= 24
    assert np.all(np.diff(res.incumbent_trace) <= 1e-9)


def test_optimizer_rejects_unknown_methods_and_unported_checkpoints(tmp_path):
    b = B.get_benchmark("branin")
    with pytest.raises(ValueError, match="ask/tell supports"):
        Optimizer(b.lb, b.ub, method="cma", device="cpu")
    with pytest.raises(NotImplementedError):
        Optimizer(b.lb, b.ub, checkpoint_path=str(tmp_path / "c"), checkpoint_every=1, device="cpu")
    opt = Optimizer(b.lb, b.ub, n_init=4, max_evals=8, batch_size=4, device="cpu")
    assert np.isnan(opt.best[0]).all() and opt.best[1] == float("inf")  # nothing told yet
    with pytest.raises(NotImplementedError):
        opt.save(str(tmp_path / "c"))
    with pytest.raises(NotImplementedError):
        opt.restore(str(tmp_path / "c"))


@pytest.mark.parametrize("entry", ["Optimizer", "Turbo1", "TurboM", "optimize_bo"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without device= every entry point runs on "cuda"; with no card it
    raises and names the device="cpu" override: it never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = B.get_benchmark("branin")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "Optimizer":
            Optimizer(b.lb, b.ub)
        elif entry == "Turbo1":
            Turbo1(_host(b), b.lb, b.ub)
        elif entry == "TurboM":
            TurboM(b.fn, b.lb, b.ub).optimize()
        else:
            optimize(b.fn, b.lb, b.ub, max_evals=10, method="bo")


def test_turbo1_constructor_flow():
    b = B.get_benchmark("branin")
    t = Turbo1(_host(b), b.lb, b.ub, n_init=6, max_evals=24, batch_size=3, seed=0,
               gp_config=GPConfig(fit_restarts=2, fit_maxiter=10), device="cpu")
    out = t.optimize()
    assert out is t
    assert t.X.shape[0] >= 24 and t.fX.shape == (t.X.shape[0],)
    assert t.best_y == np.min(t.fX)
    assert np.isfinite(t.best_x).all()


def test_turbom_constructor_flow():
    b = B.get_benchmark("branin")
    t = TurboM(b.fn, b.lb, b.ub, n_init=6, max_evals=30, batch_size=3, n_trust_regions=2,
               gp_config=GPConfig(fit_restarts=2, fit_maxiter=10), device="cpu").optimize()
    assert t.fX.shape[0] > 0
    assert np.isfinite(t.best_y) and t.best_y == pytest.approx(float(t.result.incumbent_trace[-1]))
