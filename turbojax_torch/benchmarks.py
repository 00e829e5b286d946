"""Benchmark objectives (port of ``turbojax.benchmarks``, the parts of
configs 4 and 5).

Minimization; inputs in the original box ``[lb, ub]``; every function is
batched over a leading axis, (n, dim) -> (n,). Ported: ``Benchmark``,
``ackley10`` and ``rover60``; the other objectives are later work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
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


# Rover-style 60-D trajectory problem: 30 waypoints in [0,1]² through 12
# circular obstacles. The constants come from the same seeded numpy stream
# as the JAX package's, drawn once at import.
_ROVER_WAYPOINTS = 30
_ROVER_N_OBST = 12
_rng = np.random.RandomState(2026)
_ROVER_OBST_C = _rng.uniform(0.1, 0.9, size=(_ROVER_N_OBST, 2))  # centers
_ROVER_OBST_R = _rng.uniform(0.04, 0.12, size=(_ROVER_N_OBST,))  # radii
_ROVER_START = np.array([0.05, 0.05])
_ROVER_GOAL = np.array([0.95, 0.95])


def _rover60(x: Tensor) -> Tensor:
    """Cost of a 30-waypoint path through the obstacle field:
    10·(‖p₀−start‖ + ‖p₂₉−goal‖) + path length + 20·Σ hinge²-penetration,
    with each segment sampled at 4 interior points and the hinge
    ``max(0, r²−d²)²/r⁴`` exactly zero outside an obstacle."""
    n = x.shape[0]
    pts = x.reshape(n, _ROVER_WAYPOINTS, 2)

    def const(a):
        return torch.as_tensor(a, dtype=x.dtype, device=x.device)

    centers, radii = const(_ROVER_OBST_C), const(_ROVER_OBST_R)
    seg = pts[:, 1:] - pts[:, :-1]
    length = torch.sqrt((seg**2).sum(dim=-1) + 1e-12).sum(dim=-1)
    ts = const([0.125, 0.375, 0.625, 0.875])
    samples = pts[:, :-1, None, :] + ts[None, None, :, None] * seg[:, :, None, :]
    d2 = ((samples[:, :, :, None, :] - centers[None, None, None]) ** 2).sum(dim=-1)
    r2 = radii[None, None, None] ** 2
    pen = ((torch.clamp_min(r2 - d2, 0.0) / r2) ** 2).sum(dim=(1, 2, 3))
    ends = torch.sqrt(((pts[:, 0] - const(_ROVER_START)) ** 2).sum(dim=-1) + 1e-12)
    ends = ends + torch.sqrt(((pts[:, -1] - const(_ROVER_GOAL)) ** 2).sum(dim=-1) + 1e-12)
    return 10.0 * ends + length + 20.0 * pen


def _make(name, dim, fn, lb, ub, optimum) -> Benchmark:
    return Benchmark(name, dim, fn, (float(lb),) * dim, (float(ub),) * dim, optimum)


BENCHMARKS: Dict[str, Benchmark] = {
    "ackley10": _make("ackley10", 10, _ackley, -5.0, 10.0, 0.0),
    "rover60": _make("rover60", 60, _rover60, 0.0, 1.0, 2.0),  # best known ≈ 2.02
}


def get_benchmark(name: str) -> Benchmark:
    try:
        return BENCHMARKS[name]
    except KeyError:
        raise ValueError(f"unknown benchmark {name!r}; available: {sorted(BENCHMARKS)}") from None
