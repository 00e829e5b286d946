"""Plain BO at large N through ``run_bo_distributed`` on one device (port of
``examples/run_distributed_bo.py``). The surrogate auto-routes between the
dense GP and the row-sharded distributed GP; on one device the route is
always dense, so ``--devices`` accepts only 1 until the multi-device port,
and ``--force-distributed`` (``budget_bytes=1``) leaves the route dense, as
it does in the JAX package on one device.

    python -m turbojax_torch.examples.run_distributed_bo [--evals N] [--n-init N] [--dim D] [--device cpu]
"""

import argparse
import dataclasses
from typing import List, Optional

import torch

from turbojax_torch.bo import BOConfig
from turbojax_torch.bo_distributed import run_bo_distributed
from turbojax_torch.config import GPConfig
from turbojax_torch.distributed_linalg import DENSE_BUDGET_BYTES
from turbojax_torch.examples import add_device_flag, generator


def objective(x: torch.Tensor) -> torch.Tensor:
    """A smooth multimodal toy standing in for a big dataset's objective."""
    return torch.sum((x - 0.3) ** 2, dim=-1) + 0.3 * torch.sin(6.0 * x[:, 0])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None, choices=[1],
                    help="devices of the mesh (only 1 until the multi-device port)")
    ap.add_argument("--n-init", type=int, default=None)
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--dim", type=int, default=6)
    ap.add_argument("--force-distributed", action="store_true",
                    help="budget_bytes=1: route through the distributed GP regardless of size (on one device the "
                         "route stays dense)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    n_dev = args.devices or 1
    d = args.dim
    max_evals = args.evals or 26 * n_dev
    n_init = args.n_init or max(n_dev, (max_evals // 2) // n_dev * n_dev)
    bo = BOConfig(n_init=n_init, max_evals=max_evals, batch_size=n_dev, acq="ei", n_candidates=1024, fit_every=2)
    config = dataclasses.replace(GPConfig(kernel="matern52"), fit_optimizer="adam", fit_maxiter=15)
    res = run_bo_distributed(
        objective, [0.0] * d, [1.0] * d, bo, config,
        budget_bytes=1 if args.force_distributed else DENSE_BUDGET_BYTES,
        on_iteration=lambda it, best: print(f"[{it:3d}] best = {best:.5f}"),
        generator=generator(args.device),
    )
    print(f"best y = {float(res.best_y):.5f}  n = {res.y_hist.shape[0]}  mesh = {n_dev} devices")


if __name__ == "__main__":
    main()
