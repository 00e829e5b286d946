"""Tests of the benchmark itself, run on the CPU with
``python -m pytest portbench/tests -q`` (the repository's ``tests/`` run
does not collect them); those marked ``cuda`` run on the card with
``python -m pytest portbench/tests -m cuda``."""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
