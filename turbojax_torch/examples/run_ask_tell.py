"""Ask/tell with a true black-box objective (a host-side numpy function): the
reference-style constructor API (port of ``examples/run_ask_tell.py``).

    python -m turbojax_torch.examples.run_ask_tell [--evals N] [--device cpu]
"""

import argparse
from typing import List, Optional

import numpy as np

from turbojax_torch.api import Optimizer
from turbojax_torch.examples import add_device_flag


def expensive_simulator(xs: np.ndarray) -> np.ndarray:
    """Stands in for any objective outside PyTorch (a lab experiment, an
    external simulator)."""
    return np.sum((xs - 0.7) ** 2, axis=-1) + 0.01 * np.random.randn(len(xs))


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=100)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    d = 6
    opt = Optimizer(lb=[0.0] * d, ub=[1.0] * d, method="turbo1", n_init=10, max_evals=args.evals, batch_size=5,
                    device=args.device)
    res = opt.optimize(expensive_simulator)
    print(f"best y = {res.best_y:.5f} at x = {np.round(res.best_x, 3)}")


if __name__ == "__main__":
    main()
