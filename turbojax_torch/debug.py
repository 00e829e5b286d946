"""Numerical-safety tooling (port of ``turbojax.debug``).

* ``debug_nans()``: a context manager under which every PyTorch op's
  floating outputs are checked, and the op that made a NaN or an inf
  raises ``FloatingPointError`` naming it. It is a ``TorchDispatchMode`` in
  place of JAX's ``jax_debug_nans``, and costs a host sync per op: for
  debugging only, never on a default path.
* ``checked(fn)``: ``fn`` run under ``debug_nans()``, in place of JAX's
  ``checkify`` wrapper; PyTorch checks indices natively (an out-of-range
  index raises).
* ``assert_finite_state``: a host check that every float leaf of a state
  (NamedTuples, dicts, lists and tuples of tensors, arrays and numbers) is
  finite, naming the leaf that is not.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode


def _floats(tree) -> Iterator[Any]:
    for leaf in _pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if (leaf.is_floating_point() or leaf.is_complex()) and leaf.numel() and leaf.device.type != "meta":
                yield leaf
        elif isinstance(leaf, float):
            yield leaf


def _all_finite(tree) -> bool:
    return all(bool(torch.isfinite(v).all()) if isinstance(v, torch.Tensor) else math.isfinite(v)
               for v in _floats(tree))


def _uninitialized(func) -> bool:
    """Ops whose outputs hold whatever memory they were given (``empty``
    and its kin): their NaNs are not made by them."""
    base = func.name().split("::")[-1].split(".")[0]
    return base.startswith(("empty", "new_empty")) or base in ("resize_", "resize_as_")


class _NanCheck(TorchDispatchMode):
    """Raises at the op whose floating outputs hold a NaN or an inf although
    none of its floating inputs (tensors and Python numbers, read before the
    op runs) does: the op that made it. NaNs and infs that come in, such as
    the ``-inf`` fills of a masked min or a failed factorization's NaN
    factor, pass through."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        clean_in = _uninitialized(func) or _all_finite((args, kwargs))
        out = func(*args, **kwargs)
        if clean_in and not _uninitialized(func) and not _all_finite(out):
            raise FloatingPointError(f"{func.name()} produced a NaN or an inf from finite inputs")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the block, the op that makes a NaN or an inf raises
    ``FloatingPointError`` naming it (``enable=False``: a no-op)."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def checked(fn: Callable) -> Callable:
    """``fn`` run under ``debug_nans()``: it raises ``FloatingPointError``
    at the first op that makes a NaN or an inf."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with debug_nans():
            return fn(*args, **kwargs)

    return wrapper


def _leaves_with_path(tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _leaves_with_path(getattr(tree, field), path + (field,))
    elif isinstance(tree, dict):
        for key in tree:
            yield from _leaves_with_path(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def assert_finite_state(state: Any, name: str = "state") -> None:
    """Host-side: every float leaf of ``state`` is finite (buffers must never
    hold NaN/inf, even in inactive rows); raises ``FloatingPointError``
    naming the first leaf that is not."""
    for path, leaf in _leaves_with_path(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(f"{name}.{'/'.join(path)} contains non-finite values")
