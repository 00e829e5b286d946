"""Example scripts of the PyTorch/CUDA port, one per configuration the JAX
package's ``examples/`` runs, with the same flags and the same printed
``best y`` line. Each runs on the GPU unless given ``--device cpu``::

    python -m turbojax_torch.examples.run_branin_ei
    python -m turbojax_torch.examples.run_turbo1_ackley --evals 100 --device cpu

The two with a mesh flag (``run_distributed_bo --devices N``,
``run_turbom_rover --mesh N``) run one process per device under
``torchrun --nproc-per-node N`` (NCCL on GPUs, gloo with ``--device cpu``);
started without ``torchrun`` they make a group of one process.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Iterator

import torch
import torch.distributed as dist


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a GPU) or cpu")


def generator(device, seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (default: the GPU,
    which must be there)."""
    from turbojax_torch.parallel import resolve_device

    return torch.Generator(device=resolve_device(device, "the example")).manual_seed(seed)


@contextlib.contextmanager
def example_mesh(n_devices: int, device, axis: str) -> Iterator:
    """A ``parallel.Mesh`` over ``n_devices`` ranks. Without a process group
    this initialises one, NCCL on the GPU (the default) or gloo with
    ``device="cpu"``, from ``torchrun``'s environment or, without it, as
    one process, and destroys it on the way out; an initialised group is
    used as it is."""
    from turbojax_torch import parallel as PAR

    own = not dist.is_initialized()
    if own:
        cpu = device is not None and torch.device(device).type == "cpu"
        kw = {}
        if not cpu:
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        backend = "gloo" if cpu else "nccl"
        if "RANK" in os.environ:
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    try:
        yield PAR.make_mesh(n_devices, axis=axis)
    finally:
        if own:
            dist.destroy_process_group()
