"""Benchmark objectives (port of ``turbojax.benchmarks``): Branin-2D,
Hartmann-6, Ackley, Levy, Rastrigin, Rosenbrock, Griewank, Michalewicz, and
two self-contained 60-D problems, a rover-style trajectory and a
lunar-style powered descent.

Minimization; inputs in the original box ``[lb, ub]``; every function is
batched over a leading axis, (n, dim) -> (n,), and keeps the dtype and
device of its input.
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


def _const(a, x: Tensor) -> Tensor:
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def _branin(x: Tensor) -> Tensor:
    x1, x2 = x[:, 0], x[:, 1]
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * torch.cos(x1) + s


_HARTMANN6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_HARTMANN6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)
_HARTMANN6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])


def _hartmann6(x: Tensor) -> Tensor:
    a, p, alpha = _const(_HARTMANN6_A, x), _const(_HARTMANN6_P, x), _const(_HARTMANN6_ALPHA, x)
    inner = (a[None] * (x[:, None, :] - p[None]) ** 2).sum(dim=-1)  # (n, 4)
    return -(alpha[None] * torch.exp(-inner)).sum(dim=-1)


def _ackley(x: Tensor) -> Tensor:
    s1 = torch.sqrt((x**2).mean(dim=-1))
    s2 = torch.cos(2 * math.pi * x).mean(dim=-1)
    return -20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e


def _levy(x: Tensor) -> Tensor:
    w = 1.0 + (x - 1.0) / 4.0
    head = torch.sin(math.pi * w[:, 0]) ** 2
    tail = (w[:, -1] - 1) ** 2 * (1 + torch.sin(2 * math.pi * w[:, -1]) ** 2)
    mid = ((w[:, :-1] - 1) ** 2 * (1 + 10 * torch.sin(math.pi * w[:, :-1] + 1) ** 2)).sum(dim=-1)
    return head + mid + tail


def _rastrigin(x: Tensor) -> Tensor:
    return 10.0 * x.shape[-1] + (x**2 - 10.0 * torch.cos(2 * math.pi * x)).sum(dim=-1)


def _rosenbrock(x: Tensor) -> Tensor:
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2).sum(dim=-1)


def _griewank(x: Tensor) -> Tensor:
    i = torch.sqrt(torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device))
    return 1.0 + (x**2).sum(dim=-1) / 4000.0 - torch.cos(x / i).prod(dim=-1)


def _michalewicz(x: Tensor) -> Tensor:
    i = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
    return -(torch.sin(x) * torch.sin(i * x**2 / math.pi) ** 20).sum(dim=-1)


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
        return _const(a, x)

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


# Lunar-style 60-D descent-control problem: a thrust schedule fed through
# integrated dynamics, so early coordinates couple to every later state,
# where rover60's waypoints couple only locally.
_LUNAR_STEPS = 30  # 30 × 2 thrust components
_LUNAR_DT = 0.05
_LUNAR_G = 1.0
_LUNAR_AMAX = 3.0  # max thrust acceleration
_LUNAR_START_P = np.array([0.0, 1.0])
_LUNAR_START_V = np.array([0.5, 0.0])
_LUNAR_PAD_X = 1.0
# Gaussian ridges between start and pad that the descent must clear
_LUNAR_RIDGE_C = np.array([0.25, 0.5, 0.75])  # centers along x
_LUNAR_RIDGE_H = np.array([0.65, 0.9, 0.55])  # heights
_LUNAR_RIDGE_W = np.array([0.05, 0.06, 0.05])  # widths


def _lunar_terrain(px: Tensor) -> Tensor:
    c, h, w = _const(_LUNAR_RIDGE_C, px), _const(_LUNAR_RIDGE_H, px), _const(_LUNAR_RIDGE_W, px)
    return (h[None, :] * torch.exp(-((px[:, None] - c[None, :]) ** 2) / w[None, :] ** 2)).sum(dim=-1)


def _lunar60(x: Tensor) -> Tensor:
    """Cost of a 30-step powered-descent thrust schedule over ridged terrain.
    Controls u_k ∈ [−1, 1]² are scaled to thrust a_max·u_k; the craft
    integrates ṗ = v, v̇ = a_max·u − (0, g) from p = (0, 1), v = (0.5, 0)
    and must reach the pad at x = 1 on height 0 with low speed:
    0.35·fuel (Σ‖u‖·dt) + 4·|x_T − pad| + 4·|z_T| + 1.2·‖v_T‖
    + 25·Σ hinge(terrain(x_k) − z_k)²."""
    n = x.shape[0]
    u = x.reshape(n, _LUNAR_STEPS, 2)
    g = _const([0.0, _LUNAR_G], x)
    p = _const(_LUNAR_START_P, x).expand(n, 2)
    v = _const(_LUNAR_START_V, x).expand(n, 2)
    viol = torch.zeros(n, dtype=x.dtype, device=x.device)
    for k in range(_LUNAR_STEPS):
        v = v + _LUNAR_DT * (_LUNAR_AMAX * u[:, k] - g[None, :])
        p = p + _LUNAR_DT * v
        viol = viol + torch.clamp_min(_lunar_terrain(p[:, 0]) - p[:, 1], 0.0) ** 2
    fuel = torch.sqrt((u**2).sum(dim=-1) + 1e-12).sum(dim=-1) * _LUNAR_DT
    land = torch.abs(p[:, 0] - _LUNAR_PAD_X) + torch.abs(p[:, 1])
    speed = torch.sqrt((v**2).sum(dim=-1) + 1e-12)
    return 0.35 * fuel + 4.0 * land + 1.2 * speed + 25.0 * viol


def _make(name, dim, fn, lb, ub, optimum) -> Benchmark:
    return Benchmark(name, dim, fn, tuple(float(v) for v in np.broadcast_to(lb, (dim,))),
                     tuple(float(v) for v in np.broadcast_to(ub, (dim,))), optimum)


BENCHMARKS: Dict[str, Benchmark] = {
    "branin": _make("branin", 2, _branin, [-5.0, 0.0], [10.0, 15.0], 0.397887),
    "hartmann6": _make("hartmann6", 6, _hartmann6, 0.0, 1.0, -3.32237),
    "ackley10": _make("ackley10", 10, _ackley, -5.0, 10.0, 0.0),
    "ackley20": _make("ackley20", 20, _ackley, -5.0, 10.0, 0.0),
    "levy10": _make("levy10", 10, _levy, -10.0, 10.0, 0.0),
    "rastrigin10": _make("rastrigin10", 10, _rastrigin, -5.12, 5.12, 0.0),
    "rosenbrock10": _make("rosenbrock10", 10, _rosenbrock, -5.0, 10.0, 0.0),
    "griewank10": _make("griewank10", 10, _griewank, -600.0, 600.0, 0.0),
    "michalewicz10": _make("michalewicz10", 10, _michalewicz, 0.0, float(np.pi), -9.66),
    "rover60": _make("rover60", 60, _rover60, 0.0, 1.0, 2.0),  # best known ≈ 2.02
    "lunar60": _make("lunar60", 60, _lunar60, -1.0, 1.0, 0.63),  # best known ≈ 0.634
}


def get_benchmark(name: str) -> Benchmark:
    try:
        return BENCHMARKS[name]
    except KeyError:
        raise ValueError(f"unknown benchmark {name!r}; available: {sorted(BENCHMARKS)}") from None
