"""Checkpoint / resume (port of ``turbojax.checkpoint``).

Every optimizer state of the port is a tree of NamedTuples, tuples, lists
and dicts whose leaves are tensors and host values (the active counts ``n``
are host ints). ``save_state`` writes the tensors to ``.npz`` and the
structure, the host leaves and the caller's metadata to ``.meta.json``: no
pickle. ``load_state`` rebuilds the tree along an example state (``like``),
each tensor on the device and in the dtype of its counterpart there.

The RNG is part of the saved unit: ``RunCheckpointer`` saves
``generator.get_state()`` (a CPU byte tensor, for CPU and CUDA generators
alike) beside the loop's carry and restores it with ``set_state``, so
``save → load → continue`` reproduces the uninterrupted run bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_SUFFIX_META = ".meta.json"
_HOST = (bool, int, float, str, type(None))


def _base(path: str) -> str:
    return path[: -len(".npz")] if path.endswith(".npz") else path


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append the leaves of ``tree`` in order; return its structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "T"
    if isinstance(tree, _HOST):
        leaves.append(tree)
        return "H"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ",".join(f"{f}={_flatten(getattr(tree, f), leaves)}" for f in tree._fields)
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(like: Any, leaves) -> Any:
    """``like`` with its leaves replaced by the next ones of ``leaves``."""
    if isinstance(like, torch.Tensor):
        arr = next(leaves)
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, _HOST):
        return next(leaves)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def save_state(path: str, state: Any, meta: Optional[dict] = None) -> None:
    """Serialize a tree of tensors and host values to ``path`` (.npz) and its
    structure file (.meta.json)."""
    leaves: List[Any] = []
    structure = _flatten(state, leaves)
    arrays, host = {}, {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        else:
            host[str(i)] = leaf
    np.savez(_base(path) + ".npz", **arrays)
    with open(_base(path) + _SUFFIX_META, "w") as f:
        json.dump({"structure": structure, "n_leaves": len(leaves), "host_leaves": host, "meta": meta or {}}, f)


def load_state(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_state``. ``like`` gives the structure
    (an example state of the same kind, e.g. a fresh carry; its shapes and
    host values do not matter) and, for each tensor, the device and dtype."""
    with open(_base(path) + _SUFFIX_META) as f:
        info = json.load(f)
    like_leaves: List[Any] = []
    structure = _flatten(like, like_leaves)
    if len(like_leaves) != info["n_leaves"] or structure != info["structure"]:
        raise ValueError(
            f"checkpoint has {info['n_leaves']} leaves in {info['structure']}, "
            f"expected {len(like_leaves)} in {structure}"
        )
    with np.load(_base(path) + ".npz") as data:
        leaves = [data[f"leaf_{i}"] if isinstance(ref, torch.Tensor) else info["host_leaves"][str(i)]
                  for i, ref in enumerate(like_leaves)]
    return _unflatten(like, iter(leaves))


def load_meta(path: str) -> dict:
    with open(_base(path) + _SUFFIX_META) as f:
        return json.load(f).get("meta", {})


def exists(path: str) -> bool:
    return os.path.exists(_base(path) + ".npz") and os.path.exists(_base(path) + _SUFFIX_META)


class RunCheckpointer:
    """Periodic save and restore for the host loops. The saved unit is
    ``{"carry": <loop carry>, "rng": generator.get_state(), "trace": (it,)}``,
    so a restored loop continues the uninterrupted run bit for bit. Saves
    are atomic (written to a temporary name, then renamed), so a crash
    mid-save leaves the last good checkpoint. With a ``mesh`` (a
    ``parallel.Mesh`` whose ranks hold the same carry), rank 0 alone writes
    and every rank waits at a barrier after each save, so that none races
    past a half-written file; every rank reads on resume."""

    def __init__(self, path: Optional[str], every: int, generator: torch.Generator, mesh=None):
        self.path = path
        self.every = every
        self.generator = generator
        self.mesh = mesh
        self._last_saved = 0

    def start(self, resume: bool, like: Callable[[], Any], trace_like: torch.Tensor,
              fresh: Callable[[], Any]) -> Tuple[Any, List[torch.Tensor]]:
        """(carry, trace so far as 0-dim tensors): restored from the
        checkpoint, with the generator's state, when ``resume`` and one
        exists; else (``fresh()``, []). ``like()`` builds an example carry
        (``load_state``'s structure, devices and dtypes) and ``trace_like``
        gives the trace's device and dtype."""
        if not (resume and self.path and exists(self.path)):
            return fresh(), []
        unit = load_state(self.path, {"carry": like(), "rng": self.generator.get_state(), "trace": trace_like})
        self.generator.set_state(unit["rng"])
        trace = list(unit["trace"].unbind(0))
        self._last_saved = len(trace)
        return unit["carry"], trace

    def maybe_save(self, it_done: int, carry: Any, trace: List[torch.Tensor], last: bool = False) -> None:
        """Save when ≥ ``every`` iterations completed since the last save
        (or the start), at k, 2k, ..., and after the ``last`` iteration, so
        that resuming a finished run returns it at once. ``it_done``:
        iterations completed so far; ``trace``: their bests."""
        if not self.path or not self.every:
            return
        if it_done - self._last_saved < self.every and not last:
            return
        if self.mesh is None or self.mesh.rank == 0:
            tmp = _base(self.path) + ".tmp"
            unit = {"carry": carry, "rng": self.generator.get_state(), "trace": torch.stack(list(trace))}
            save_state(tmp, unit, meta={"it": it_done})
            os.replace(tmp + ".npz", _base(self.path) + ".npz")
            os.replace(tmp + _SUFFIX_META, _base(self.path) + _SUFFIX_META)
        if self.mesh is not None:
            from turbojax_torch.parallel import barrier

            barrier(self.mesh)
        self._last_saved = it_done
