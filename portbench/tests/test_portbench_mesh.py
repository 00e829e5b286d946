"""The mesh cell (``bo_ackley10_64k.mesh4``: ``entries/mesh.py``, the
blocked reference ``reference/gp64_blocked.py``, ``yardstick/mesh_work.py``)
on the CPU: its tiny twin on 2 and 4 gloo ranks, one process per rank as
the command runs it, is correct with every rank at the same batch; each
planted fault (the factor not refreshed with the batches, half the
observations left out) is not. Marked ``cuda``: the faults at the cell's
own sizes on four cards."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from portbench import manifest
from portbench.reference import gp64 as R
from portbench.reference import gp64_blocked as RB
from portbench.tests import tiny
from portbench.yardstick import mesh_work as MW

SEED = 2**31 + 29
CELL = "bo_ackley10_64k.mesh4"

PLANTED_ENTRY = '''"""``mesh`` with the traffic's ``plant`` planted on every rank: the
row-sharded GP conditions on a prefix of the history (``stale``: X0 alone,
the factor never refreshed with the batches; ``half``: the first half),
its pathwise noise draw cut to the prefix."""

from portbench import manifest

Mesh = manifest.find("entries", "mesh").Entry


class Entry(Mesh):
    def warm_up(self):
        from turbojax_torch import bo_distributed as BD
        from turbojax_torch import distributed_linalg as DL

        orig, n0, plant = BD.refactor_gp_auto, self.n_init, self.traffic["plant"]

        def refactor(x, y, raw, config, **kw):
            keep = n0 if plant == "stale" else x.shape[0] // 2
            g = orig(x[:keep], y[:keep], raw, config, **kw)
            if isinstance(g, DL.DistributedGP):
                paths = g.pathwise_paths
                g.pathwise_paths = lambda xs, q, m, gen, d: paths(xs, q, m, gen, d._replace(eps=d.eps[:, :keep]))
            return g

        BD.refactor_gp_auto = refactor
        super().warm_up()
'''

RANK0 = """
import sys
from portbench import run

sys.exit(run.main(["--workload", sys.argv[2], "--seed", sys.argv[3], "--seconds", sys.argv[4],
                   "--trace", sys.argv[5]], sys.argv[6], sys.argv[1]))
"""

PLANTS = ("stale", "half")


def _add_cells(root: str, config: str, chips: int, traffic_over=None) -> None:
    """Cells ``<config>.mesh<chips>`` and ``<config>.planted_<plant>`` (on
    ``chips`` ranks) beside the cell's twin in ``root``."""
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "traffic", "mesh4.json")) as f:
        traffic = dict(json.load(f), **(traffic_over or {}))
    with open(os.path.join(pkg, "limits", f"{CELL}.json")) as f:
        limits = f.read()
    with open(os.path.join(pkg, "entries", "planted_mesh.py"), "w") as f:
        f.write(PLANTED_ENTRY)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    cells = {f"mesh{chips}": dict(traffic)} | {f"planted_{p}": dict(traffic, entry="planted_mesh", plant=p)
                                               for p in PLANTS}
    for name, tr in cells.items():
        with open(os.path.join(pkg, "traffic", f"{name}.json"), "w") as f:
            json.dump(tr, f)
        with open(os.path.join(pkg, "limits", f"{config}.{name}.json"), "w") as f:
            f.write(limits)
        if not any(w["name"] == f"{config}.{name}" for w in b["workloads"]):
            b["workloads"].append({"name": f"{config}.{name}", "config": config, "traffic": name, "chips": chips,
                                   "why": "the mesh cell on other ranks or with a fault"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root, its mesh twin at n_init 47 and q = 3 (no history
    size a multiple of the mesh), on 2 and 4 ranks, and its planted cells
    on 2."""
    root = tiny.make_root(str(tmp_path_factory.mktemp("mesh")))
    path = os.path.join(root, "portbench", "configs", "tiny_bo_ackley10_64k.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, n_init=47, batch_size=3), f)
    _add_cells(root, "tiny_bo_ackley10_64k", 2)
    return root


def _run(root, cell, device="cpu", seconds=0.6, trace=0, seed=SEED, timeout=300):
    out = subprocess.run([sys.executable, "-c", RANK0, root, cell, str(seed), str(seconds), str(trace), device],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    assert out.returncode == 0 and result is not None, out.stderr[-4000:]
    return result


@pytest.mark.parametrize("cell,world,trace", [("tiny_bo_ackley10_64k.mesh2", 2, 1),
                                              (f"tiny_{CELL}", 4, 0)])
def test_the_tiny_mesh_cell_is_correct_on_every_rank(root, cell, world, trace):
    res = _run(root, cell, seconds=1.0 * world, trace=trace)
    dev = res["device"]
    assert dev["count"] == world and [r["batches"] for r in dev["ranks"]] == [res["attempted"]] * world
    assert res["attempted"] >= 2 and res["checks"]["batch_spread"] == {"value": 0, "limit": 0}
    if not trace:
        assert set(res["metrics"]) == {"points_per_s", "peak_mem_gib", "setup_s"}
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("plant", PLANTS)
def test_a_planted_fault_is_not_correct(root, plant):
    res = _run(root, f"tiny_bo_ackley10_64k.planted_{plant}")
    assert res["checks"]["batch_spread"]["value"] == 0
    assert not res["correct"], res["checks"]


CARD_SEEDS = (3000000001, 3000000019)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("plant", PLANTS)
def test_a_planted_fault_is_not_correct_at_the_cells_size(tmp_path, plant, seed):
    """Each fault at the cell's own sizes on four cards, over a window of
    eight seconds (two batches or more: a factor left stale differs from
    the program's from the second batch of a segment on); the numbers
    compared are printed (``pytest -s``) for the limit's upper reading."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    root = str(tmp_path / "root")
    os.makedirs(root)
    import shutil

    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    _add_cells(root, "bo_ackley10_64k", 4)
    res = _run(root, f"bo_ackley10_64k.planted_{plant}", "cuda", seconds=8.0, seed=seed, timeout=900)
    readings = {k: v["value"] for k, v in res["checks"].items()}
    print(f"\nportbench fault {CELL} {plant} seed {seed} batches {res['attempted']} {json.dumps(readings)}")
    assert not res["correct"], res["checks"]


def test_the_blocked_reference_is_gp64s():
    """Tiles of 16 over N = 203 (a last tile of 11), candidates in chunks
    of 17: the factor, α and the pathwise values of ``gp64`` to 1e-10."""
    gp = {"kernel": "matern52", "noise_floor": 1e-4, "jitter": 1e-6, "lengthscale_bounds": [0.005, 2.0],
          "outputscale_bounds": [0.05, 20.0], "noise_bounds": [1e-4, 0.2], "fit_lr": 0.1}
    g = torch.Generator().manual_seed(0)
    n, d, q, m, feats = 203, 4, 3, 50, 32
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.rand((n, d), **f64)
    y = torch.sin(5 * x).sum(dim=1)
    raw = R.raw_from_values(0.3, 1.0, 1e-3, d, gp)
    cands = torch.rand((m, d), **f64)
    omega = R.kernel_module(gp).spectral(feats, d, g, "cpu").double()
    b = 2 * math.pi * torch.rand((feats,), **f64)
    w, eps = torch.randn((q, feats), **f64), torch.randn((q, n), **f64)
    want_post = R.posterior(x, y, raw, gp)
    want = R.pathwise_values(want_post, cands, omega, b, w, eps)
    chunk = RB.CAND_CHUNK
    RB.CAND_CHUNK = 17
    try:
        post = RB.posterior(x, y, raw, gp, block=16)
        got = RB.pathwise_values(post, cands, omega, b, w, eps)
    finally:
        RB.CAND_CHUNK = chunk
    assert torch.allclose(post.l_buf.tril(), want_post.l_mat, rtol=0, atol=1e-10)
    assert torch.allclose(post.alpha, want_post.alpha, rtol=1e-10, atol=1e-10)
    assert float(((got - want).abs() / want.std(dim=1, keepdim=True)).max()) < 1e-10


def test_a_failing_factor_is_nan():
    """Every rung fails on an indefinite K (a negative outputscale's
    diagonal): the buffer comes back NaN, as ``gp64.factor``'s factor."""
    gp = {"kernel": "matern52", "jitter": 1e-6}
    h = R.Hypers(torch.tensor([0.3, 0.3], dtype=torch.float64), torch.tensor(-1.0, dtype=torch.float64),
                 torch.tensor(1e-3, dtype=torch.float64))
    x = torch.rand((40, 2), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert bool(torch.isnan(RB.factor(x, h, gp, block=16)).all())


def test_mesh_work_counts_by_hand():
    n, q = 65536, 10
    w1, w4 = MW.mesh_batch(n, q, 1), MW.mesh_batch(n, q, 4)
    assert w1["dfactor_flops"] == pytest.approx(n**3 / 3) and w4["dfactor_flops"] == pytest.approx(n**3 / 12)
    assert w1["flops"] == pytest.approx(n**3 / 3 + 2 * n * n * q) and w4["flops"] == pytest.approx(w1["flops"] / 4)
    # 9.38e13 operations a factorization at N = 65536: a rank's quarter takes 0.350 s at 67 TFLOP/s
    assert w4["dfactor_flops"] / 67e12 == pytest.approx(0.35009, rel=1e-4)
