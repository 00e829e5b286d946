"""Every example of the port (``turbojax_torch/examples``) run with
``--device cpu`` at the budgets of ``tests/test_examples.py:33-50``, in this
process through its ``main(argv)``: each prints its ``best y`` line.
``run_distributed_bo`` runs at its small default size (26 evaluations, 13
of them the initial design) and accepts only ``--devices 1``."""

import importlib

import pytest
import torch

torch.set_num_threads(1)


def _run(capsys, name, *args):
    importlib.import_module(f"turbojax_torch.examples.{name}").main([*args, "--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("name,args", [
    ("run_branin_ei", ()),
    ("run_ask_tell", ("--evals", "30")),
    ("run_hartmann6", ("--evals", "24")),
    ("run_turbo1_ackley", ("--evals", "60")),
    ("run_turbom_rover", ("--evals", "60", "--m", "2")),
    ("run_distributed_bo", ("--devices", "1", "--force-distributed")),
])
def test_example_prints_best_y(capsys, name, args):
    assert "best y = " in _run(capsys, name, *args)


def test_examples_refuse_a_multi_device_mesh(capsys):
    for name, flag in (("run_distributed_bo", "--devices"), ("run_turbom_rover", "--mesh")):
        with pytest.raises(SystemExit):
            _run(capsys, name, flag, "4")


def test_examples_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from turbojax_torch.examples import run_branin_ei

    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_branin_ei.main([])
