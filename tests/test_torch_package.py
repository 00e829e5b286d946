"""The port's package boundary: it imports no JAX and nothing of the JAX
package's tree, its configs equal the JAX package's (all six registered
configurations field for field), and its transforms equal
``turbojax.transforms`` on the cases of ``tests/test_transforms.py``
(f64, rtol 1e-12)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs import registry as JR
from turbojax import config as JC
from turbojax import transforms as JT
from turbojax import trust_region as JTR
from turbojax_torch import config as TC
from turbojax_torch import registry as TR
from turbojax_torch import transforms as TT
from turbojax_torch import trust_region as TTR

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys, importlib\n"
        "mods = ['turbojax_torch', 'chip_smoke'] + ['turbojax_torch.' + m for m in ("
        "'acq', 'api', 'benchmarks', 'bo', 'config', 'convert', 'cuda_kernels', 'gp', 'kernel_bench', 'kernels', "
        "'linalg', 'registry', 'sampling', 'transforms', 'trust_region', 'turbo_m', 'profile_config5')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'turbojax', 'optax', 'configs', 'benchmarks', 'oracle', 'bench')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _fields(cfg, drop=()):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in drop}


def test_configs_match_the_jax_package():
    knob = ("use_pallas", "use_kernel")
    assert _fields(TC.GPConfig(), knob) == _fields(JC.GPConfig(), knob)
    assert _fields(TC.TRConfig()) == _fields(JC.TRConfig())
    assert _fields(TTR.TurboConfig()) == _fields(JTR.TurboConfig())
    port, ref = TR.get_config("turbo1_ackley10"), JR.get_config("turbo1_ackley10")
    assert (port.name, port.benchmark, port.method) == (ref.name, ref.benchmark, ref.method)
    assert _fields(port.gp, knob) == _fields(ref.gp, knob)
    assert _fields(port.turbo) == _fields(ref.turbo)
    assert port.turbo.n_init + port.turbo.n_iters * port.turbo.batch_size == 1000  # N_max
    assert TC.GPConfig().use_kernel is None


def test_transforms_match_jax(rng):
    lb, ub = np.array([-5.0, 0.0, 2.0]), np.array([10.0, 15.0, 3.0])
    x = rng.uniform(-5, 3, size=(20, 3))
    u = TT.to_unit_cube(torch.as_tensor(x), torch.as_tensor(lb), torch.as_tensor(ub))
    np.testing.assert_allclose(u.numpy(), np.asarray(JT.to_unit_cube(jnp.asarray(x), lb, ub)), rtol=1e-12)
    np.testing.assert_allclose(TT.from_unit_cube(u, torch.as_tensor(lb), torch.as_tensor(ub)).numpy(), x, rtol=1e-12)

    y = rng.randn(16) * 3.0 + 7.0
    mask = np.arange(16) < 11
    got = TT.standardize(torch.as_tensor(y), torch.as_tensor(mask))
    ref = JT.standardize(jnp.asarray(y), jnp.asarray(mask))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
    assert np.all(got[0].numpy()[11:] == 0.0)
    const = TT.standardize(torch.full((8,), 3.0, dtype=torch.float64), torch.ones(8, dtype=torch.bool))
    assert bool(torch.isfinite(const[0]).all())
    np.testing.assert_allclose(TT.unstandardize(got[0], got[1], got[2]).numpy()[:11], y[:11], rtol=1e-12)
    np.testing.assert_allclose(TT.unstandardize_var(torch.tensor(2.0, dtype=torch.float64), got[2]).numpy(),
                               np.asarray(JT.unstandardize_var(2.0, ref[2])), rtol=1e-12)

    vals = np.array([0.01, 0.5, 1.0, 19.0, -100.0, 100.0])
    np.testing.assert_allclose(TT.unconstrain(torch.as_tensor(vals), 0.005, 20.0).numpy(),
                               np.asarray(JT.unconstrain(jnp.asarray(vals), 0.005, 20.0)), rtol=1e-12)
    np.testing.assert_allclose(TT.constrain(torch.as_tensor(vals), 0.005, 20.0).numpy(),
                               np.asarray(JT.constrain(jnp.asarray(vals), 0.005, 20.0)), rtol=1e-12)
    sp = np.array([0.1, 1.0, 10.0, 50.0])
    np.testing.assert_allclose(TT.inv_softplus(torch.as_tensor(sp)).numpy(),
                               np.asarray(JT.inv_softplus(jnp.asarray(sp))), rtol=1e-12)
    np.testing.assert_allclose(TT.softplus(torch.as_tensor(sp)).numpy(),
                               np.asarray(JT.softplus(jnp.asarray(sp))), rtol=1e-12)

    w = np.sort(rng.randn(64) * 50.0)
    np.testing.assert_allclose(TT.warp_y(torch.as_tensor(w), "bilog").numpy(),
                               np.asarray(JT.warp_y(jnp.asarray(w), "bilog")), rtol=1e-12)
    with pytest.raises(ValueError):
        TT.warp_y(torch.as_tensor(w), "sqrt")


@pytest.mark.parametrize("case", ["mixed", "all_nan_empty_history", "inf_only"])
def test_impute_failures_matches_jax(case, rng):
    y_buf = rng.randn(12)
    mask = np.arange(12) < 7
    y_new = rng.randn(5)
    if case == "mixed":
        y_new[[1, 3]] = [np.nan, np.inf]
    elif case == "all_nan_empty_history":
        y_new[:] = np.nan
        mask[:] = False
    else:
        y_new[:] = -np.inf
    got = TT.impute_failures(torch.as_tensor(y_new), torch.as_tensor(y_buf), torch.as_tensor(mask)).numpy()
    ref = np.asarray(JT.impute_failures(jnp.asarray(y_new), jnp.asarray(y_buf), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("name", sorted(JR.CONFIGS))
def test_registry_configs_match_the_jax_package(name):
    knob = ("use_pallas", "use_kernel")
    port, ref = TR.get_config(name), JR.get_config(name)
    assert (port.name, port.benchmark, port.method, port.m) == (ref.name, ref.benchmark, ref.method, ref.m)
    assert _fields(port.gp, knob) == _fields(ref.gp, knob)
    assert (port.bo is None) == (ref.bo is None) and (port.turbo is None) == (ref.turbo is None)
    if ref.bo is not None:
        assert _fields(port.bo) == _fields(ref.bo)
    if ref.turbo is not None:
        assert _fields(port.turbo) == _fields(ref.turbo)
    small_p, small_r = TR.reduced(port, max_evals=24), JR.reduced(ref, max_evals=24)
    assert _fields(small_p.gp, knob) == _fields(small_r.gp, knob)
    for a, b in ((small_p.bo, small_r.bo), (small_p.turbo, small_r.turbo)):
        assert (a is None) == (b is None) and (a is None or _fields(a) == _fields(b))


def test_registry_lists_all_six_configs():
    assert sorted(TR.CONFIGS) == sorted(JR.CONFIGS) and len(TR.CONFIGS) == 6
    with pytest.raises(ValueError, match="available"):
        TR.get_config("config7")
