"""Config 5: TuRBO-m (m = 5) on the 60-D rover-style problem: a surrogate per
trust region and a global Thompson allocation (port of
``examples/run_turbom_rover.py``). Pass --evals/--m to reduce. ``--mesh``
(sharding the trust regions over devices) waits for the multi-device port
and accepts only 1.

    python -m turbojax_torch.examples.run_turbom_rover [--evals N] [--m M] [--seed S] [--device cpu]
"""

import argparse
import dataclasses
from typing import List, Optional

from turbojax_torch import benchmarks as B
from turbojax_torch import registry as R
from turbojax_torch.examples import add_device_flag, generator
from turbojax_torch.turbo_m import run_turbom


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=None, choices=[1],
                    help="devices to shard the trust-region axis over (only 1 until the multi-device port)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = R.get_config("turbom5_rover60")
    turbo = cfg.turbo
    if args.evals:
        turbo = dataclasses.replace(turbo, max_evals=args.evals)
    b = B.get_benchmark(cfg.benchmark)
    m = args.m or cfg.m
    carries, trace = run_turbom(b.fn, b.lb, b.ub, turbo, cfg.gp, m, generator(args.device, args.seed))
    print(f"best y = {float(carries.best_y.min()):.4f}  per-TR n = {list(carries.n)}")


if __name__ == "__main__":
    main()
