"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``. The code that a
name selects is a module of its own, found the same way:

* ``entries/<entry>.py`` (the traffic's ``entry``): its ``Entry`` class
  drives the program through the window, counts each batch's work and
  judges the answers against the reference;
* ``objectives/<objective>.py`` (the configuration's ``objective``): its
  ``evaluate(x)`` is the black box;
* ``metrics/<metric>.py`` (a per-layer metric): its ``read(run)``;
* ``reference/kernels/<kernel>.py`` (the configuration's ``gp.kernel``),
  read by the reference.

Every path is taken under the root that holds ``BENCHMARK.json``, so a
cell that a later change adds as new files is found without an edit to
any file that is already here."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple, Optional

PACKAGE = "portbench"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    root: str  # the directory that holds BENCHMARK.json and the files above


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, PACKAGE, *parts)) as f:
        return json.load(f)


def applies(metric: dict, cell: str, moves_reported: Optional[set] = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: where it lists
    ``workloads``, in those; an end-to-end metric without the list in every
    cell, a per-layer one in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_reported is None or metric.get("moves") in moves_reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {[w['name'] for w in manifest['workloads']]}")
    e2e = [m for m in manifest["end_to_end"] if applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if applies(m, name, reported)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root, "configs", f"{entry['config']}.json"),
        traffic=_json(root, "traffic", f"{entry['traffic']}.json"),
        limits=_json(root, "limits", f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, root=root,
    )


_MODULES: Dict[str, ModuleType] = {}


def find(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """The module ``<kind>/<name>.py`` of the package under ``root``,
    loaded by its path once per process."""
    if not NAME.match(name) or "." in name:
        raise LookupError(f"{name!r} is not a module name of {kind}/")
    path = os.path.join(root, PACKAGE, *kind.split("/"), f"{name}.py")
    if path not in _MODULES:
        if not os.path.exists(path):
            raise LookupError(f"no {kind} {name!r}: {path} does not exist")
        spec = importlib.util.spec_from_file_location(f"{PACKAGE}.{kind.replace('/', '.')}.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    return find("metrics", name, root).read
