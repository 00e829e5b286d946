"""Config 1: Branin-2D, fixed-hyperparameter RBF GP + EI, 50 iterations, the
incremental Cholesky (port of ``examples/run_branin_ei.py``).

    python -m turbojax_torch.examples.run_branin_ei [--device cpu]
"""

import argparse
from typing import List, Optional

from turbojax_torch import benchmarks as B
from turbojax_torch import gp as G
from turbojax_torch import registry as R
from turbojax_torch.bo import run_bo
from turbojax_torch.examples import add_device_flag, generator
from turbojax_torch.runlog import RunLog


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = R.get_config("branin_ei")
    b = B.get_benchmark(cfg.benchmark)
    gen = generator(args.device)
    res = run_bo(b.fn, b.lb, b.ub, cfg.bo, cfg.gp, gen,
                 fixed_params=G.default_params(b.dim, cfg.gp, device=gen.device))
    with RunLog(verbose=True) as log:
        for i, v in enumerate(res.incumbent_trace.tolist()):
            log.log(i, best_y=v)
    print(f"best y = {float(res.best_y):.6f}  (optimum {b.optimum})  at x = {res.best_x.cpu().numpy()}")


if __name__ == "__main__":
    main()
