"""A root of tiny cells beside the real ones, for running the harness on
the CPU: each real configuration cut to a few dozen points, written as new
files under a temporary directory with the package's own files copied in."""

from __future__ import annotations

import json
import os
import shutil

from portbench import manifest

TINY = {"n_init": 48, "n_candidates": 64, "batch_size": 4, "rff_features": 32, "ts_chunk": 16, "dim": 3}


def make_root(tmp: str, traffic_overrides=None) -> str:
    """Copy the package's data and metric files under ``tmp`` and add a
    tiny twin ``tiny_<config>.<traffic>`` of every real cell."""
    root = os.path.join(tmp, "root")
    src = os.path.join(manifest.ROOT, manifest.PACKAGE)
    dst = os.path.join(root, manifest.PACKAGE)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load_manifest()
    for c in bench["configs"]:
        with open(os.path.join(dst, "configs", f"{c['name']}.json")) as f:
            cfg = json.load(f)
        cfg.update({k: v for k, v in TINY.items() if k in cfg or k == "dim"})
        with open(os.path.join(dst, "configs", f"tiny_{c['name']}.json"), "w") as f:
            json.dump(cfg, f)
    for t, over in (traffic_overrides or {}).items():
        with open(os.path.join(dst, "traffic", f"{t}.json")) as f:
            tr = json.load(f)
        tr.update(over)
        with open(os.path.join(dst, "traffic", f"{t}.json"), "w") as f:
            json.dump(tr, f)
    cells = []
    for w in bench["workloads"]:
        name = f"tiny_{w['name']}"
        cells.append(dict(w, name=name, config=f"tiny_{w['config']}"))
        shutil.copy(os.path.join(dst, "limits", f"{w['name']}.json"), os.path.join(dst, "limits", f"{name}.json"))
    bench["workloads"] = bench["workloads"] + cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [f"tiny_{w}" for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
