"""A cell on two ranks, one process each (gloo on the CPU, NCCL on two
cards): the loop over a mesh of both, forced onto the row-sharded GP.
Rank 0 runs as a subprocess of the test, as the command runs it; each run
has its own time limit, and no rank may be left running after it."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import manifest, run
from portbench.tests import tiny

GIB = 2**30
SEED = 2**31 + 13
SECONDS = 0.6

MESH_ENTRY = '''"""The loop over a mesh of every rank, on the distributed route at any
size; the traffic's ``plant`` plants a fault on rank 1, in its window or,
after its reading has gone to rank 0, in its release."""

import sys
import time
import types

from portbench import harness as H
from portbench import inputs as I
from portbench import manifest, run

Loop = manifest.find("entries", "loop").Entry


class Entry(Loop):
    def __init__(self, config, traffic, inputs, device):
        from turbojax_torch.parallel import make_mesh

        super().__init__(config, traffic, inputs, device)
        self.mesh = make_mesh()
        self.plant = traffic.get("plant")
        if self.plant == "peaks" and self.device.type == "cpu":
            # the CPU has no peak to read: rank r reads (r + 1) GiB
            run.memory_reading = lambda cuda, r=self.mesh.rank: (r + 1) * 2**30

    def _segment(self, tag, seg, bo, on_iteration):
        from turbojax_torch.bo_distributed import run_bo_distributed

        inputs = self.inputs
        run_bo_distributed(
            self._fn, [inputs.lb] * inputs.dim, [inputs.ub] * inputs.dim, bo, self.gp, mesh=self.mesh,
            budget_bytes=0, on_iteration=on_iteration, fixed_params=self.fixed,
            generator=I.generator(self.device, inputs.seed, tag, "segment", seg),
            x_init=inputs.x0, draws=lambda it: self._draws(tag, seg, it),
        )

    def _planted(self, n_batches):
        if self.mesh.rank != 1 or n_batches != 2:
            return
        if self.plant == "raise":
            raise RuntimeError("planted: rank 1 fails in its window")
        if self.plant == "hang":
            time.sleep(3600)
        if self.plant == "guard":
            sys.modules["flax"] = types.ModuleType("flax")

    def window(self, seconds):
        batches = []
        t_start = time.perf_counter()
        marks = {"prev": t_start}
        seg = 0

        def on_iteration(it, best):
            t = time.perf_counter()
            batches.append({"segment": seg, "it": it, "n": self.n_init + it * self.q, "fit": self.fits(it),
                            "t": t - t_start, "latency_s": t - marks["prev"], "points": H.host(self._last),
                            "values": H.host(self._tap.take())})
            marks["prev"] = t
            self._planted(len(batches))
            if H.window_over(t - t_start, seconds):
                raise H.Stop

        with H.ValueTap() as tap:
            self._tap = tap
            while True:
                try:
                    self._segment("window", seg, self.bo, on_iteration)
                except H.Stop:
                    break
                seg += 1
        return batches

    def release(self):
        planted = self.plant if self.mesh is not None and self.mesh.rank == 1 else None
        super().release()
        self.mesh = None
        if planted == "release_raise":
            raise RuntimeError("planted: rank 1 fails in its release")
        if planted == "release_guard":
            sys.modules["flax"] = types.ModuleType("flax")
'''

RANK0 = """
import sys
from portbench import ranks, run

ranks.WINDOW_MARGIN_S = float(sys.argv[5])
sys.exit(run.main(["--workload", sys.argv[2], "--seed", sys.argv[3], "--seconds", sys.argv[4],
                   "--trace", sys.argv[6]], sys.argv[7], sys.argv[1]))
"""

PLANTS = ("peaks", "raise", "hang", "guard", "release_raise", "release_guard")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root with a two-rank cell ``tiny_mesh.mesh_<plant>`` for
    each plant: q = 2 and n_init = 48 = 2 · 24, the panel of each rank's 24
    rows; the hypers pinned."""
    root = tiny.make_root(str(tmp_path_factory.mktemp("ranks")))
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "entries", "mesh_loop.py"), "w") as f:
        f.write(MESH_ENTRY)
    with open(os.path.join(pkg, "configs", "tiny_bo_ackley10_16k.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(pkg, "configs", "tiny_mesh.json"), "w") as f:
        json.dump(dict(cfg, name="tiny_mesh", batch_size=2), f)
    with open(os.path.join(pkg, "traffic", "pinned.json")) as f:
        pinned = json.load(f)
    with open(os.path.join(pkg, "limits", "bo_ackley10_16k.pinned.json")) as f:
        limits = f.read()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="tiny_mesh", file="portbench/configs/tiny_mesh.json"))
    for plant in PLANTS:
        with open(os.path.join(pkg, "traffic", f"mesh_{plant}.json"), "w") as f:
            json.dump(dict(pinned, entry="mesh_loop", plant=plant), f)
        with open(os.path.join(pkg, "limits", f"tiny_mesh.mesh_{plant}.json"), "w") as f:
            f.write(limits)
        b["workloads"].append({"name": f"tiny_mesh.mesh_{plant}", "config": "tiny_mesh",
                               "traffic": f"mesh_{plant}", "chips": 2, "why": "two ranks"})
    for m in b["per_layer"]:
        if m["name"] in ("syncs_per_batch", "device_idle"):
            m["workloads"] = m["workloads"] + [f"tiny_mesh.mesh_{p}" for p in PLANTS]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The CPU (gloo), or two cards (NCCL) or a skip: decided here."""
    if request.param == "cuda" and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return request.param


def _left(root):
    """Processes still running whose command line names ``root``."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if root.encode() in f.read():
                    left.append(int(pid))
        except OSError:
            pass
    return left


def _run(root, plant, device, trace=0, margin=150.0, timeout=240):
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RANK0, root, f"tiny_mesh.mesh_{plant}", str(SEED), str(SECONDS),
                          str(margin), str(trace), device],
                         cwd=manifest.ROOT, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    elapsed = time.monotonic() - t
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return out, result, elapsed


@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_end_together_and_are_correct(root, device, trace):
    out, res, _ = _run(root, "peaks", device, trace)
    assert out.returncode == 0 and res is not None, out.stderr[-3000:]
    dev = res["device"]
    assert dev["count"] == 2 and [r["rank"] for r in dev["ranks"]] == [0, 1]
    assert dev["ranks"][0]["batches"] == dev["ranks"][1]["batches"] == res["attempted"] >= 2
    assert res["checks"]["batch_spread"] == {"value": 0, "limit": 0}
    assert res["checks"]["ranks_failed"] == {"value": 0, "limit": 0}
    assert dev["memory_peak_bytes"] == max(r["memory_peak_bytes"] for r in dev["ranks"])
    if device == "cpu":  # the planted readings: rank 1's is the larger
        assert [r["window_peak_bytes"] for r in dev["ranks"]] == [GIB, 2 * GIB]
        assert dev["memory_peak_bytes"] == 2 * GIB
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and all("busy_share" in r for r in dev["ranks"])
        assert res["metrics"]["syncs_per_batch"]["value"] >= 1  # the incumbent; the ladder decides on a collective
    else:
        peak = max(r["window_peak_bytes"] for r in dev["ranks"]) / GIB
        assert res["metrics"]["peak_mem_gib"]["value"] == peak
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and _left(root) == []


@pytest.mark.parametrize("plant,where", [("raise", "window"), ("release_raise", "release")])
def test_a_rank_that_raises_ends_the_run(root, device, plant, where):
    """In its window, or in its release after its reading reached rank 0,
    where its exit code alone ends the run."""
    out, res, elapsed = _run(root, plant, device, timeout=200)
    assert out.returncode == 0 and res is not None, out.stderr[-3000:]
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["device"]["count"] == 2 and res["checks"]["ranks_failed"]["value"] >= 1
    assert f"planted: rank 1 fails in its {where}" in out.stderr and "rank 1 exit code 1" in out.stderr
    assert elapsed < 150 and _left(root) == []


def test_a_hung_rank_is_ended_by_the_margin(root, device):
    margin = 10.0
    out, res, elapsed = _run(root, "hang", device, margin=margin, timeout=200)
    assert out.returncode == 0 and res is not None, out.stderr[-3000:]
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert "ranks still running: [1]" in out.stderr
    assert elapsed < 120 + margin and _left(root) == []


@pytest.mark.parametrize("plant,stage", [("guard", "after the window"), ("release_guard", "before the result")])
def test_a_rank_that_loads_jax_stops_the_run(root, plant, stage):
    """In its window, or in its release after its reading reached rank 0:
    no result, exit 3."""
    out, res, _ = _run(root, plant, "cpu", timeout=200)
    assert out.returncode == 3 and res is None, out.stderr[-3000:]
    assert stage in out.stderr and "flax" in out.stderr
    assert "rank 1 exit code 3" in out.stderr and _left(root) == []


@pytest.mark.parametrize("name,trace", [(f"tiny_{w['name']}", 0) for w in manifest.load_manifest()["workloads"]]
                         + [("tiny_bo_ackley10_16k.pinned", 1)])
def test_one_chip_result_lines_keep_their_keys(root, capsys, name, trace):
    """A one-chip cell starts no rank and its line has the same keys as
    before ranks existed."""
    assert run.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.3", "--trace", str(trace)],
                    "cpu", root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) \
        + ["checks"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert res["device"]["count"] == 1 and set(res["checks"]) == {"checked", "value_gap", "pick_mismatch"}
    assert res["correct"], res["checks"]
