"""Benchmark objectives (port of ``turbojax.benchmarks``, config 4's part).

Minimization; inputs in the original box ``[lb, ub]``; every function is
batched over a leading axis, (n, dim) -> (n,). Ported: ``Benchmark`` and
``ackley10``; the other objectives are later work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Benchmark:
    name: str
    dim: int
    fn: Callable[[Tensor], Tensor]  # (n, dim) -> (n,)
    lb: tuple
    ub: tuple
    optimum: float  # known minimum value

    def __call__(self, x: Tensor) -> Tensor:
        return self.fn(torch.atleast_2d(x))


def _ackley(x: Tensor) -> Tensor:
    s1 = torch.sqrt((x**2).mean(dim=-1))
    s2 = torch.cos(2 * math.pi * x).mean(dim=-1)
    return -20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e


def _make(name, dim, fn, lb, ub, optimum) -> Benchmark:
    return Benchmark(name, dim, fn, (float(lb),) * dim, (float(ub),) * dim, optimum)


BENCHMARKS: Dict[str, Benchmark] = {
    "ackley10": _make("ackley10", 10, _ackley, -5.0, 10.0, 0.0),
}


def get_benchmark(name: str) -> Benchmark:
    try:
        return BENCHMARKS[name]
    except KeyError:
        raise ValueError(f"unknown benchmark {name!r}; available: {sorted(BENCHMARKS)}") from None
