"""Config 2: Hartmann-6 with a Matérn-5/2 GP and a multi-restart L-BFGS MLL
fit every iteration, the restarts one batch of lanes (port of
``examples/run_hartmann6.py``). Pass --evals to reduce.

    python -m turbojax_torch.examples.run_hartmann6 [--evals N] [--seed S] [--device cpu]
"""

import argparse
import dataclasses
from typing import List, Optional

from turbojax_torch import benchmarks as B
from turbojax_torch import registry as R
from turbojax_torch.bo import run_bo
from turbojax_torch.examples import add_device_flag, generator


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = R.get_config("hartmann6_lbfgs")
    bo = cfg.bo
    if args.evals:
        bo = dataclasses.replace(bo, max_evals=args.evals)
    b = B.get_benchmark(cfg.benchmark)
    res = run_bo(b.fn, b.lb, b.ub, bo, cfg.gp, generator(args.device, args.seed))
    print(f"best y = {float(res.best_y):.5f}  (optimum {b.optimum})  n = {res.n}  at x = {res.best_x.cpu().numpy()}")


if __name__ == "__main__":
    main()
