"""Every input of a run, made on the device from ``--seed``: the initial
design X₀, the objective's values, the candidate sets and the samplers'
draws. Each draw comes from a generator seeded from the run's seed and the
draw's own tags (segment, iteration, request), so the reference makes the
same draws again after the window, and a faster program meets the same
inputs in the same order. The objective is the module
``objectives/<objective>.py`` and the spectral frequencies come from the
kernel's module (``reference/kernels/<gp.kernel>.py``), both found by the
configuration's names."""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch

from portbench import manifest
from portbench.reference import gp64 as R

Tensor = torch.Tensor


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and ``tags`` (any whole numbers
    and strings): seeds of any size, no two tag paths alike."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


class PathwiseDraws(NamedTuple):
    omega: Tensor  # (M, d) spectral frequencies at unit lengthscale
    b: Tensor  # (M,) phases in [0, 2π)
    weights: Tensor  # (q, M) prior weights
    eps: Tensor  # (q, n) standard normals of the noise draw


class Inputs:
    """The inputs of one run of a configuration on ``device``."""

    def __init__(self, config: dict, seed: int, device, root: str = manifest.ROOT):
        self.config, self.seed, self.device = config, int(seed), torch.device(device)
        self.dim = int(config["dim"])
        self.lb, self.ub = float(config["lb"]), float(config["ub"])
        self.objective_fn = manifest.find("objectives", config["objective"], root).evaluate
        g = generator(self.device, self.seed, "x0")
        self.x0 = torch.rand((int(config["n_init"]), self.dim), generator=g, device=self.device)
        engine = torch.quasirandom.SobolEngine(self.dim, scramble=False)
        self.sobol_base = engine.draw(int(config["n_candidates"])).to(torch.float32).to(self.device)

    def to_box(self, x_unit: Tensor) -> Tensor:
        return x_unit * (self.ub - self.lb) + self.lb

    def to_unit(self, x_box: Tensor) -> Tensor:
        return (x_box.to(torch.float64) - self.lb) / (self.ub - self.lb)

    def objective(self, x_box: Tensor) -> Tensor:
        """The black box: float64 values of the float32 points it is
        given, rounded to float32, as the program receives them."""
        return self.objective_fn(x_box).to(torch.float32)

    def candidates(self, *tags) -> Tensor:
        """Sobol points with a random shift modulo 1, (n_candidates, d)."""
        g = generator(self.device, self.seed, "cands", *tags)
        shift = torch.rand((1, self.dim), generator=g, device=self.device)
        return torch.remainder(self.sobol_base + shift, 1.0)

    def pathwise(self, n: int, *tags) -> PathwiseDraws:
        """The pathwise sampler's draws over ``n`` training rows: Ω from the
        kernel's spectral density at unit lengthscale."""
        q, m = int(self.config["batch_size"]), int(self.config["rff_features"])
        g = generator(self.device, self.seed, "pathwise", *tags)
        kw = dict(generator=g, device=self.device)
        omega = R.kernel_module(self.config["gp"]).spectral(m, self.dim, g, self.device)
        b = 2.0 * math.pi * torch.rand((m,), **kw)
        return PathwiseDraws(omega, b, torch.randn((q, m), **kw), torch.randn((q, n), **kw))

    def ts_normals(self, *tags) -> Tensor:
        """The exact sampler's standard normals, (q, n_candidates)."""
        g = generator(self.device, self.seed, "normals", *tags)
        shape = (int(self.config["batch_size"]), int(self.config["n_candidates"]))
        return torch.randn(shape, generator=g, device=self.device)

