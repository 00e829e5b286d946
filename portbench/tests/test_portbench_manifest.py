"""BENCHMARK.json keeps to its contract, and every cell's files are found
by name, a cell added as new files too."""

import json
import os
import re

import pytest

from portbench import manifest, run
from portbench.reference import gp64 as R
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_its_contract():
    b = manifest.load_manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                               for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names and _line(w["why"])
        assert w["chips"] in (1, 4)
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(manifest.ROOT, "portbench", "metrics", f"{m['name']}.py"))
    assert len(json.dumps(b).encode()) <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load_manifest()["workloads"]])
def test_every_cell_is_found_by_name(name):
    cell = manifest.load_cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert callable(manifest.find("entries", cell.traffic["entry"]).Entry) and cell.limits
    assert callable(manifest.find("objectives", cell.config["objective"]).evaluate)
    assert callable(R.kernel_module(cell.config["gp"]).value_and_slope)
    for m in cell.per_layer:
        assert m["moves"] in reported and callable(manifest.metric_reader(m["name"]))
    for key in ("dim", "n_init", "n_candidates", "batch_size", "gp", "default_hypers"):
        assert key in cell.config


def test_unknown_names_are_refused():
    with pytest.raises(LookupError):
        manifest.find("entries", "no_such_entry")
    with pytest.raises(LookupError):
        manifest.find("objectives", "../run")
    with pytest.raises(ValueError, match="no kernel"):
        R.kernel_module({"kernel": "no_such_kernel"})


SPHERE = """import torch


def evaluate(x):
    return ((x.to(torch.float64) - 1.0) ** 2).sum(dim=-1)
"""

ENTRY = """from portbench import manifest

Entry = manifest.find("entries", "suggest").Entry
"""


def test_a_cell_added_as_new_files_is_found_and_runs(tmp_path):
    """A configuration with another objective, a traffic mix naming another
    entry, its limits and a per-layer metric, all added as new files under
    a copy of the package, make a cell that runs correct on the CPU."""
    root = tiny.make_root(str(tmp_path))
    pkg = os.path.join(root, "portbench")

    def write(rel, text):
        with open(os.path.join(pkg, rel), "w") as f:
            f.write(text)

    write("objectives/sphere.py", SPHERE)
    write("entries/suggest_again.py", ENTRY)
    write("metrics/batches_seen.py", "def read(run):\n    return float(len(run.batches))\n")
    with open(os.path.join(pkg, "configs", "tiny_ts_q10_16k.json")) as f:
        cfg = json.load(f)
    write("configs/tiny_sphere.json", json.dumps(dict(cfg, name="tiny_sphere", objective="sphere")))
    with open(os.path.join(pkg, "traffic", "exact.json")) as f:
        write("traffic/again.json", json.dumps(dict(json.load(f), entry="suggest_again")))
    with open(os.path.join(pkg, "limits", "ts_q10_16k.exact.json")) as f:
        write("limits/tiny_sphere.again.json", f.read())
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][1], name="tiny_sphere", file="portbench/configs/tiny_sphere.json"))
    b["workloads"].append({"name": "tiny_sphere.again", "config": "tiny_sphere", "traffic": "again", "chips": 1,
                           "why": "a cell added as files"})
    b["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher", "source": "host_clock",
                           "layer": "loop", "moves": "points_per_s", "workloads": ["tiny_sphere.again"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny_sphere.again")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = manifest.load_cell("tiny_sphere.again", root)
    assert cell.config["n_init"] == tiny.TINY["n_init"] and cell.config["objective"] == "sphere"
    assert "batches_seen" in {m["name"] for m in cell.per_layer}
    assert manifest.metric_reader("batches_seen", root)(type("R", (), {"batches": [1, 2]})) == 2.0
    res = run.run_cell(cell, 2**33 + 1, 0.3, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"points_per_s", "batch_p95_ms", "peak_mem_gib", "setup_s"}
