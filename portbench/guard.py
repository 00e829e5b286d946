"""The import guard: nothing the benchmark runs may load JAX or the JAX
package it was ported from. Module names are compared by their top-level
part (before the first dot) as a whole word, so ``turbojax_torch`` passes
and ``turbojax`` or ``turbojax.gp`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "turbojax", "oracle")


def forbidden_loaded(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``names``, sorted."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def check(stage: str) -> None:
    """Exit with code 3, naming what was found on standard error, when a
    forbidden module is in ``sys.modules``."""
    found = forbidden_loaded(list(sys.modules))
    if found:
        print(f"portbench: {stage}: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
