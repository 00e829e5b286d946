"""Every example of the port (``turbojax_torch/examples``) run with
``--device cpu`` at the budgets of ``tests/test_examples.py:33-50``, in this
process through its ``main(argv)``: each prints its ``best y`` line.
``run_distributed_bo`` runs at its small default size (26 evaluations, 13
of them the initial design). The two mesh flags (``run_distributed_bo
--devices``, ``run_turbom_rover --mesh``) run on a process group, made for
one process when there is none; a mesh larger than the group is
refused."""

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


def test_examples_refuse_a_multi_device_mesh(capsys, tmp_path):
    """On a group of one process, a mesh of four devices is refused."""
    from torch_mesh_cases import world1_group

    with world1_group(tmp_path):
        for name, flag in (("run_distributed_bo", "--devices"), ("run_turbom_rover", "--mesh")):
            with pytest.raises(ValueError, match="needs as many ranks"):
                _run(capsys, name, flag, "4")


def test_examples_run_on_a_mesh(capsys, tmp_path):
    """Both mesh flags on a group of one process (the one the test made),
    which the examples leave initialised."""
    import torch.distributed as dist
    from torch_mesh_cases import world1_group

    with world1_group(tmp_path):
        out = _run(capsys, "run_distributed_bo", "--devices", "1", "--force-distributed", "--evals", "14")
        assert "best y = " in out and "mesh = 1 devices" in out
        out = _run(capsys, "run_turbom_rover", "--mesh", "1", "--evals", "40", "--m", "2")
        assert "best y = " in out and "mesh = 1 devices" in out
        assert dist.is_initialized()


def test_examples_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from turbojax_torch.examples import run_branin_ei

    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_branin_ei.main([])
