"""The port's tooling on the CPU: ``turbojax_torch.debug`` (the cases of
``tests/test_debug_runlog.py:14-39``, and ``debug_nans`` naming the op that
made a NaN or an inf while NaNs and infs that come in pass through), the
``SIGUSR2`` profiler toggle of ``runlog.start_profiler_server`` (a repeated
start is a no-op; two signals write a trace) and the plots."""

import os
import signal

import numpy as np
import pytest
import torch

from turbojax_torch import debug as D
from turbojax_torch import linalg as L
from turbojax_torch import plotting as P
from turbojax_torch import runlog as RL

torch.set_num_threads(1)


def test_checked_passes_clean():
    f = D.checked(lambda x: torch.sqrt(x) + 1.0)
    np.testing.assert_allclose(f(torch.tensor([1.0, 4.0])).numpy(), [2.0, 3.0])


def test_checked_raises_on_nan():
    f = D.checked(lambda x: torch.log(x))  # log(-1) -> nan
    with pytest.raises(FloatingPointError) as e:
        f(torch.tensor([-1.0]))
    assert "nan" in str(e.value).lower()


def test_assert_finite_state():
    good = {"a": torch.ones(3), "n": torch.tensor(4), "h": np.zeros(2), "k": 3}
    D.assert_finite_state(good)
    bad = {"a": torch.tensor([1.0, torch.inf])}
    with pytest.raises(FloatingPointError, match=r"carry\.a "):
        D.assert_finite_state(bad, "carry")
    carry = "label", [torch.zeros(2), (torch.ones(1), torch.tensor([np.nan]))]
    with pytest.raises(FloatingPointError, match=r"state\.1/1/1 "):
        D.assert_finite_state(carry)


def test_debug_nans_scope():
    x = torch.tensor([-1.0, 0.0])
    with pytest.raises(FloatingPointError):
        with D.debug_nans(True):
            torch.log(x)
    assert torch.isnan(torch.log(x)[0])  # outside the block nothing is checked
    with D.debug_nans(False):
        torch.log(x)


def test_debug_nans_names_the_op_that_made_it():
    with pytest.raises(FloatingPointError, match="aten::div"):
        with D.debug_nans():
            a = torch.ones(3)
            b = a * 2.0
            b / torch.zeros(3)  # 2 / 0 = inf, made here
    with pytest.raises(FloatingPointError, match="aten::exp"):
        with D.debug_nans():
            torch.exp(torch.tensor([1000.0]))


def test_debug_nans_lets_non_finite_inputs_pass():
    """The port's own -inf fills and a failed factorization's NaN factor come
    in from a constant or another op's input, so they are not raised on."""
    with D.debug_nans():
        y = torch.tensor([3.0, 1.0, 2.0])
        mask = torch.tensor([True, False, True])
        assert float(torch.where(mask, y, torch.inf).min()) == 2.0
        factor, info = L.cholesky_nan(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))  # indefinite: NaN factor
        assert int(info) != 0 and bool(torch.isnan(factor[1, 1]))
        torch.empty(4)  # uninitialized memory is not made by the op


def test_profiler_toggle_writes_a_trace(tmp_path):
    trace_dir = str(tmp_path / "traces")
    try:
        assert RL.start_profiler_server(9917, trace_dir=trace_dir) == 9917
        assert RL.start_profiler_server(9917, trace_dir=str(tmp_path / "other")) == 9917  # a no-op
        os.kill(os.getpid(), signal.SIGUSR2)  # opens a window
        with RL.span("fit"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        os.kill(os.getpid(), signal.SIGUSR2)  # closes it and writes the trace
        (name,) = os.listdir(trace_dir)
        assert name.endswith(".json") and '"fit"' in open(os.path.join(trace_dir, name)).read()
        assert not os.path.exists(str(tmp_path / "other"))
    finally:
        RL._stop_profiler_server()


def test_stop_profiler_server_closes_an_open_window(tmp_path):
    trace_dir = str(tmp_path / "traces")
    previous = signal.getsignal(signal.SIGUSR2)
    RL.start_profiler_server(trace_dir=trace_dir)
    os.kill(os.getpid(), signal.SIGUSR2)
    torch.ones(4).sum()
    RL._stop_profiler_server()
    assert len(os.listdir(trace_dir)) == 1
    assert signal.getsignal(signal.SIGUSR2) == previous
    RL._stop_profiler_server()  # a second stop is a no-op


def test_plots_write_pngs(tmp_path):
    trace = torch.tensor([3.0, 2.0, 2.0, 0.5])
    path = P.plot_regret([trace, np.array([4.0, 1.0, 0.25, 0.1])], labels=["a", "b"], optimum=0.0,
                         path=str(tmp_path / "regret.png"))
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    single = P.plot_regret(trace, path=str(tmp_path / "one.png"))
    assert os.path.getsize(single) > 0
    with RL.RunLog() as log:
        for i, v in enumerate([3.0, 2.0, 1.0]):
            log.log(i, best_y=v, tr_length=0.8 / (i + 1))
    for records, name in ((log.records, "run_tr.png"), ([{"iter": 0, "best_y": 1.0}], "run.png")):
        out = P.plot_run_log(records, path=str(tmp_path / name))
        assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
