"""Config 5: TuRBO-m (m = 5) on the 60-D rover-style problem: a surrogate per
trust region and a global Thompson allocation (port of
``examples/run_turbom_rover.py``). Pass --evals/--m to reduce; ``--mesh N``
shards the trust regions over N devices, one process each (m a multiple of
N), the objective on rank 0.

    python -m turbojax_torch.examples.run_turbom_rover [--evals N] [--m M] [--seed S] [--device cpu]
    torchrun --nproc-per-node N -m turbojax_torch.examples.run_turbom_rover --mesh N --regions M
"""

import argparse
import dataclasses
from typing import List, Optional

from turbojax_torch import benchmarks as B
from turbojax_torch import parallel as PAR
from turbojax_torch import registry as R
from turbojax_torch.examples import add_device_flag, generator, example_mesh
from turbojax_torch.turbo_m import run_turbom


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--evals", type=int, default=None)
    ap.add_argument("--m", "--regions", type=int, default=None, dest="m",
                    help="trust regions; under torchrun spell it --regions (torchrun reads --m as one of its own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=None,
                    help="devices to shard the trust-region axis over, one process each (torchrun)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = R.get_config("turbom5_rover60")
    turbo = cfg.turbo
    if args.evals:
        turbo = dataclasses.replace(turbo, max_evals=args.evals)
    b = B.get_benchmark(cfg.benchmark)
    m = args.m or cfg.m
    if not args.mesh:
        carries, _ = run_turbom(b.fn, b.lb, b.ub, turbo, cfg.gp, m, generator(args.device, args.seed))
        print(f"best y = {float(carries.best_y.min()):.4f}  per-TR n = {list(carries.n)}")
        return
    with example_mesh(args.mesh, args.device, "tr") as mesh:
        carries, _ = PAR.run_turbom_sharded(b.fn, b.lb, b.ub, turbo, cfg.gp, mesh, m=m,
                                            generator=generator(mesh.device, args.seed))
        carries = PAR.gather_carries(carries, mesh)
        if mesh.rank == 0:
            print(f"best y = {float(carries.best_y.min()):.4f}  per-TR n = {list(carries.n)}  "
                  f"mesh = {mesh.size} devices")


if __name__ == "__main__":
    main()
