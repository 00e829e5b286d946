"""The benchmark configurations the port runs, as data (port of
``configs/registry.py``). Two are ported:

* config 4, ``turbo1_ackley10``: TuRBO-1 on Ackley-10D, 1000 evaluations,
  Matérn-5/2 GP with the grid trainer refit every batch, 1000 trust-region
  Sobol candidates per batch, exact joint Thompson sampling with q = 10;
* config 5, ``turbom5_rover60``: TuRBO-m with m = 5 on the 60-D rover
  problem, 2000 evaluations, the grid trainer with a 40-step ARD Adam
  polish, 5000 candidates per region, Thompson chunks of 1000, q = 10."""

from __future__ import annotations

import dataclasses

from turbojax_torch.config import GPConfig, TRConfig
from turbojax_torch.trust_region import TurboConfig


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    benchmark: str  # key into turbojax_torch.benchmarks.BENCHMARKS
    method: str
    gp: GPConfig
    turbo: TurboConfig
    m: int = 1
    note: str = ""


CONFIGS = {
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
}


def get_config(name: str) -> BenchConfig:
    try:
        return CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown config {name!r}; available: {sorted(CONFIGS)}") from None
