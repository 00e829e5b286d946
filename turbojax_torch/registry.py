"""The benchmark configurations, as data (port of ``configs/registry.py``):

| # | name              | spec                                                      |
|---|-------------------|-----------------------------------------------------------|
| 1 | branin_ei         | Branin-2D, fixed-hyper RBF GP + EI, 50 iterations         |
| 2 | hartmann6_lbfgs   | Hartmann-6, Matérn-5/2, L-BFGS MLL fit per iteration      |
| 3 | ts_q10            | batched TS (q = 10) over a 5000-point candidate set       |
| 4 | turbo1_ackley10   | TuRBO-1, Ackley-10D, 1000 evaluations, grid fit           |
| 5 | turbom5_rover60   | TuRBO-m (m = 5), 60-D rover-style, 2000 evaluations       |
| 5b| turbom5_lunar60   | TuRBO-m (m = 5), 60-D lunar-style descent dynamics        |
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from turbojax_torch.bo import BOConfig
from turbojax_torch.config import GPConfig, TRConfig
from turbojax_torch.trust_region import TurboConfig


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    benchmark: str  # key into turbojax_torch.benchmarks.BENCHMARKS
    method: str  # "bo" | "turbo1" | "turbom" | "acq_only"
    gp: GPConfig
    bo: Optional[BOConfig] = None
    turbo: Optional[TurboConfig] = None
    m: int = 1
    note: str = ""


CONFIGS = {
    "branin_ei": BenchConfig(
        name="branin_ei",
        benchmark="branin",
        method="bo",
        gp=GPConfig(kernel="rbf", use_ard=True),
        bo=BOConfig(
            n_init=10, max_evals=60, batch_size=1, acq="ei",
            n_candidates=2000, fit_every=0,  # fixed hypers: the pure incremental-Cholesky path
            chol_mode="incremental", local_frac=0.0,
        ),
        note="incremental Cholesky append per observation",
    ),
    "hartmann6_lbfgs": BenchConfig(
        name="hartmann6_lbfgs",
        benchmark="hartmann6",
        method="bo",
        gp=GPConfig(
            kernel="matern52", use_ard=True, fit_optimizer="lbfgs",
            fit_maxiter=50, fit_restarts=4,
        ),
        bo=BOConfig(
            n_init=12, max_evals=112, batch_size=1, acq="ei",
            n_candidates=2000, fit_every=1,
        ),
        note="multi-restart L-BFGS MLL fit per iteration, the restarts one batch",
    ),
    "ts_q10": BenchConfig(
        name="ts_q10",
        benchmark="ackley10",
        method="acq_only",
        gp=GPConfig(kernel="matern52"),
        bo=BOConfig(n_init=0, max_evals=0, batch_size=10, acq="ts", n_candidates=5000, ts_chunk=1000),
        note="acquisition-latency config: posterior + joint TS over 5000 points",
    ),
    "turbo1_ackley10": BenchConfig(
        name="turbo1_ackley10",
        benchmark="ackley10",
        method="turbo1",
        gp=GPConfig(
            kernel="matern52", fit_restarts=2, fit_optimizer="grid",
            fit_maxiter=50, fit_maxiter_warm=25, fit_lr=0.1,
        ),
        turbo=TurboConfig(
            n_init=20, max_evals=1000, batch_size=10,
            n_candidates=1000, ts_chunk=None, tr=TRConfig(),
        ),
        note="single trust region, TS batches of 10, grid MLL fit",
    ),
    "turbom5_rover60": BenchConfig(
        name="turbom5_rover60",
        benchmark="rover60",
        method="turbom",
        m=5,
        gp=GPConfig(
            kernel="matern52", fit_restarts=2, fit_optimizer="grid+adam",
            fit_maxiter=50, fit_maxiter_warm=40, fit_lr=0.1,
        ),
        turbo=TurboConfig(
            n_init=40, max_evals=2000, batch_size=10,
            n_candidates=5000, ts_chunk=1000, tr=TRConfig(),
        ),
        note="m=5 surrogates, global TS allocation, independent restarts",
    ),
    # the second 60-D problem: config 5's shape with the isotropic grid trainer
    "turbom5_lunar60": BenchConfig(
        name="turbom5_lunar60",
        benchmark="lunar60",
        method="turbom",
        m=5,
        gp=GPConfig(
            kernel="matern52", fit_restarts=2, fit_optimizer="grid",
            fit_maxiter=50, fit_maxiter_warm=25, fit_lr=0.1,
        ),
        turbo=TurboConfig(
            n_init=40, max_evals=2000, batch_size=10,
            n_candidates=5000, ts_chunk=1000, tr=TRConfig(),
        ),
        note="lunar-style 60-D descent control",
    ),
}


def get_config(name: str) -> BenchConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown config {name!r}; available: {sorted(CONFIGS)}") from None


def reduced(cfg: BenchConfig, max_evals: int, n_init: Optional[int] = None, n_candidates: int = 64) -> BenchConfig:
    """A small version of a config for tests."""
    changes = {}
    if cfg.bo is not None:
        changes["bo"] = dataclasses.replace(
            cfg.bo, max_evals=max_evals, n_init=n_init or min(cfg.bo.n_init, max_evals // 2) or 1,
            n_candidates=n_candidates, ts_chunk=None,
        )
    if cfg.turbo is not None:
        changes["turbo"] = dataclasses.replace(
            cfg.turbo, max_evals=max_evals, n_init=n_init or min(cfg.turbo.n_init, max_evals // 3) or 2,
            n_candidates=n_candidates, ts_chunk=None,
        )
    gp = dataclasses.replace(cfg.gp, fit_restarts=2, fit_maxiter=15)
    return dataclasses.replace(cfg, gp=gp, **changes)
