"""Example scripts of the PyTorch/CUDA port, one per configuration the JAX
package's ``examples/`` runs, with the same flags and the same printed
``best y`` line. Each runs on the GPU unless given ``--device cpu``::

    python -m turbojax_torch.examples.run_branin_ei
    python -m turbojax_torch.examples.run_turbo1_ackley --evals 100 --device cpu
"""

from __future__ import annotations

import argparse

import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a GPU) or cpu")


def generator(device, seed: int = 0) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (default: the GPU,
    which must be there)."""
    from turbojax_torch.api import _resolve_device

    return torch.Generator(device=_resolve_device(device, "the example")).manual_seed(seed)
