"""Plain BO at large N through ``run_bo_distributed`` (port of
``examples/run_distributed_bo.py``). The surrogate auto-routes between the
dense GP and the row-sharded ``DistributedGP`` (in-shard kernel builds,
blocked Cholesky, an Adam fit of the distributed MLL) once the history
crosses the per-device memory threshold; ``--force-distributed``
(``budget_bytes=1``) routes through it at any size on a mesh of more than
one device (a mesh of one device always takes the dense route, as in the
JAX package).

    python -m turbojax_torch.examples.run_distributed_bo [--evals N] [--n-init N] [--dim D] [--device cpu]
    torchrun --nproc-per-node N -m turbojax_torch.examples.run_distributed_bo --devices N --force-distributed

Without ``--devices`` the loop runs on one device and no mesh; with it,
one process per device (``torchrun``), the objective on rank 0.
"""

import argparse
import contextlib
import dataclasses
from typing import List, Optional

import torch

from turbojax_torch.bo import BOConfig
from turbojax_torch.bo_distributed import run_bo_distributed
from turbojax_torch.config import GPConfig
from turbojax_torch.distributed_linalg import DENSE_BUDGET_BYTES
from turbojax_torch.examples import add_device_flag, generator, example_mesh


def objective(x: torch.Tensor) -> torch.Tensor:
    """A smooth multimodal toy standing in for a big dataset's objective."""
    return torch.sum((x - 0.3) ** 2, dim=-1) + 0.3 * torch.sin(6.0 * x[:, 0])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="devices of the mesh, one process each (torchrun --nproc-per-node N)")
    ap.add_argument("--n-init", type=int, default=None)
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--dim", type=int, default=6)
    ap.add_argument("--force-distributed", action="store_true",
                    help="budget_bytes=1: route through the distributed GP regardless of size (on a mesh of more "
                         "than one device)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    with (example_mesh(args.devices, args.device, "rows") if args.devices else contextlib.nullcontext()) as mesh:
        n_dev = mesh.size if mesh is not None else 1
        d = args.dim
        max_evals = args.evals or 26 * n_dev
        n_init = args.n_init or max(n_dev, (max_evals // 2) // n_dev * n_dev)
        bo = BOConfig(n_init=n_init, max_evals=max_evals, batch_size=n_dev, acq="ei", n_candidates=1024,
                      fit_every=2)
        config = dataclasses.replace(GPConfig(kernel="matern52"), fit_optimizer="adam", fit_maxiter=15)
        rank0 = mesh is None or mesh.rank == 0
        res = run_bo_distributed(
            objective, [0.0] * d, [1.0] * d, bo, config, mesh,
            budget_bytes=1 if args.force_distributed else DENSE_BUDGET_BYTES,
            on_iteration=(lambda it, best: print(f"[{it:3d}] best = {best:.5f}")) if rank0 else None,
            generator=generator(mesh.device if mesh is not None else args.device),
        )
        if rank0:
            print(f"best y = {float(res.best_y):.5f}  n = {res.y_hist.shape[0]}  mesh = {n_dev} devices")


if __name__ == "__main__":
    main()
