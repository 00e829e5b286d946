"""The import guard compares top-level module names as whole words, and a
run that loads a forbidden module after its window prints no result."""

import os
import subprocess
import sys

from portbench import guard, manifest


def test_top_level_names_are_compared_whole():
    names = ["turbojax_torch", "turbojax_torch.gp", "jaxtyping", "oracle_like", "numpy", "torch.jax"]
    assert guard.forbidden_loaded(names) == []
    assert guard.forbidden_loaded(names + ["turbojax.gp", "jax.numpy", "oracle", "flax", "jaxlib"]) == \
        ["flax", "jax", "jaxlib", "oracle", "turbojax"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import portbench.run, portbench.harness, portbench.control, portbench.trace, "
            "turbojax_torch.bo, turbojax_torch.bo_distributed; from portbench import guard, manifest; "
            "[manifest.find(k, n) for k, n in (('entries', 'loop'), ('entries', 'suggest'), "
            "('objectives', 'ackley'), ('reference/kernels', 'matern52'))]; guard.check('test')")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr


def test_check_exits_when_a_forbidden_module_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "oracle", object())
    try:
        guard.check("test")
    except SystemExit as e:
        assert e.code == 3
    else:
        raise AssertionError("guard.check did not exit")


LATE_LOAD = """
import sys, types
from portbench import run
from portbench.tests import tiny

root = tiny.make_root(sys.argv[1])
run_cell = run.run_cell


def late(*args, **kwargs):
    result = run_cell(*args, **kwargs)
    sys.modules["flax"] = types.ModuleType("flax")  # loaded after the window, as a metric or the judge might
    return result


run.run_cell = late
sys.exit(run.main(["--workload", "tiny_ts_q10_16k.exact", "--seed", "5", "--seconds", "0.3"], "cpu", root))
"""


def test_a_module_loaded_after_the_window_stops_the_result(tmp_path):
    out = subprocess.run([sys.executable, "-c", LATE_LOAD, str(tmp_path)], cwd=manifest.ROOT, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=manifest.ROOT), timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "before the result" in out.stderr and "flax" in out.stderr
    assert "{" not in out.stdout
