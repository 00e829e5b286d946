"""Config 4: TuRBO-1 on Ackley-10D, 1000 evaluations: the trust-region state
machine with Thompson-sampling batches (port of
``examples/run_turbo1_ackley.py``). Pass --evals to reduce.

    python -m turbojax_torch.examples.run_turbo1_ackley [--evals N] [--seed S] [--device cpu]
"""

import argparse
import dataclasses
from typing import List, Optional

from turbojax_torch import benchmarks as B
from turbojax_torch import registry as R
from turbojax_torch.examples import add_device_flag, generator
from turbojax_torch.trust_region import run_turbo1


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = R.get_config("turbo1_ackley10")
    turbo = cfg.turbo
    if args.evals:
        turbo = dataclasses.replace(turbo, max_evals=args.evals)
    b = B.get_benchmark(cfg.benchmark)
    carry, trace = run_turbo1(b.fn, b.lb, b.ub, turbo, cfg.gp, generator(args.device, args.seed))
    print(f"best y = {float(carry.best_y):.4f}  n = {carry.n}  "
          f"TR length = {float(carry.tr.length):.4f}  restarts = {int(carry.tr.restarts)}")


if __name__ == "__main__":
    main()
