"""Every benchmark objective of the port against ``turbojax.benchmarks`` in
float64 on seeded inputs inside the box (rtol 1e-12), with its bounds,
dimension and optimum, and the value at the known minimizer where there is
one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbojax import benchmarks as JB
from turbojax_torch import benchmarks as TB

torch.set_num_threads(1)

NAMES = sorted(JB.BENCHMARKS)
MINIMIZERS = {
    "branin": [np.pi, 2.275], "hartmann6": [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573],
    "ackley10": [0.0] * 10, "ackley20": [0.0] * 20, "levy10": [1.0] * 10, "rastrigin10": [0.0] * 10,
    "rosenbrock10": [1.0] * 10, "griewank10": [0.0] * 10,
}


def test_the_port_lists_every_benchmark():
    assert sorted(TB.BENCHMARKS) == NAMES and len(NAMES) == 11
    with pytest.raises(ValueError, match="available"):
        TB.get_benchmark("sphere")


@pytest.mark.parametrize("name", NAMES)
def test_benchmark_matches_jax(name):
    ref, port = JB.get_benchmark(name), TB.get_benchmark(name)
    assert (port.name, port.dim, port.lb, port.ub, port.optimum) == (ref.name, ref.dim, ref.lb, ref.ub, ref.optimum)
    rng = np.random.RandomState(len(name))
    lb, ub = np.asarray(ref.lb), np.asarray(ref.ub)
    x = lb + (ub - lb) * rng.rand(33, ref.dim)
    want = np.asarray(ref.fn(jnp.asarray(x)))
    got = port.fn(torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.shape == (33,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port(torch.as_tensor(x[0])).numpy(), want[:1], rtol=1e-12, atol=1e-12)  # one point
    got32 = port.fn(torch.as_tensor(x, dtype=torch.float32))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", sorted(MINIMIZERS))
def test_benchmark_optimum_at_the_known_minimizer(name):
    port = TB.get_benchmark(name)
    value = float(port(torch.tensor(MINIMIZERS[name], dtype=torch.float64))[0])
    assert value == pytest.approx(port.optimum, abs=2e-5)
