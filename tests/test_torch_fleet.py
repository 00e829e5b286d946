"""``parallel.fleet_run`` of the port against ``turbojax.parallel.fleet_run``:
each process runs ``seeds[i::count]`` with no communication. The JAX
package hands ``run_fn`` a key, the port the integer seed; the slices must
be the same. The index and count default to the rank and world size of the
initialised process group (a gloo group of this process alone here), and
to 0 and 1 without one. ``make_mesh`` needs a group and never makes one."""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_cases as TMC
from turbojax import parallel as JPAR
from turbojax_torch import benchmarks as B
from turbojax_torch import optimize
from turbojax_torch import parallel as PAR
from turbojax_torch.config import GPConfig

torch.set_num_threads(1)

SEEDS = list(range(10, 21))


@pytest.mark.parametrize("index, count", [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3), (4, 5)])
def test_fleet_run_takes_jax_slices(index, count):
    mine, results = PAR.fleet_run(lambda s: 2 * s, SEEDS, index, count)
    mine_j, results_j = JPAR.fleet_run(lambda k: int(jax.random.key_data(k)[-1]), SEEDS, index, count)
    assert mine == list(mine_j) == SEEDS[index::count]
    assert results == [2 * s for s in mine] and results_j == mine


def test_fleet_run_defaults_to_the_process_group(tmp_path):
    assert PAR.fleet_run(lambda s: s, SEEDS)[0] == SEEDS  # no group: index 0 of 1
    with TMC.world1_group(tmp_path) as mesh:
        assert (mesh.rank, mesh.size) == (0, 1)
        mine, results = PAR.fleet_run(lambda s: s + 1, SEEDS)
    assert mine == SEEDS and results == [s + 1 for s in SEEDS]


def test_fleet_run_seeds_the_runs():
    """``run_fn`` gets the integer seed and makes its own generator: a run
    in the fleet is the run ``optimize(seed=s)`` makes."""
    b = B.get_benchmark("branin")
    cfg = GPConfig(fit_restarts=1, fit_maxiter=5)

    def run(seed):
        return optimize(b.fn, b.lb, b.ub, 12, method="bo", n_init=8, batch_size=2, n_candidates=32, gp_config=cfg,
                        seed=seed, device="cpu").y_hist

    mine, results = PAR.fleet_run(run, [3, 4, 5], 1, 2)
    assert mine == [4]
    np.testing.assert_array_equal(results[0], run(4))


def test_make_mesh_needs_a_process_group(tmp_path):
    """Without an initialised group ``make_mesh`` raises, naming the two ways
    to make one; on a group of one gloo process it is a CPU mesh of one."""
    with pytest.raises(RuntimeError, match="init_process_group.*torchrun"):
        PAR.make_mesh()
    with TMC.world1_group(tmp_path) as mesh:
        assert (mesh.size, mesh.rank, mesh.device.type, mesh.axis) == (1, 0, "cpu", "rows")
        with pytest.raises(ValueError, match="needs as many ranks"):
            PAR.make_mesh(2)
