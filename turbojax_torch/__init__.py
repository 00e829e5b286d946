"""turbojax_torch: the PyTorch/CUDA port of turbojax (GP Bayesian
optimization), for NVIDIA Hopper GPUs.

The JAX package ``turbojax`` is the reference this port is held against;
this package imports ``torch`` and never ``jax``. On CUDA tensors every
kernel-matrix build goes through the hand-written CUDA kernel in
``csrc/kernel_matrix.cu`` and every Thompson-chunk covariance through
``csrc/ts_cov.cu`` (``cuda_kernels``).

Precision rule (docs/DESIGN.md §2b): every contraction that feeds a
cancellation (the distance expansion, σ² = k** − Σv², cov = K** − vᵀv)
runs in full fp32, so TF32 is switched off here for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from turbojax_torch import checkpoint, debug, distributed_linalg, parallel  # noqa: E402
from turbojax_torch.api import Optimizer, Result, Turbo1, TurboM, optimize  # noqa: E402
from turbojax_torch.bo import BOConfig, run_bo  # noqa: E402
from turbojax_torch.bo_distributed import run_bo_distributed  # noqa: E402
from turbojax_torch.config import GPConfig, TRConfig  # noqa: E402
from turbojax_torch.distributed_linalg import (  # noqa: E402
    DistributedGP, fit_distributed_gp, fit_gp_auto, refactor_gp_auto,
)
from turbojax_torch.runlog import RunLog  # noqa: E402

__all__ = ["BOConfig", "DistributedGP", "GPConfig", "Optimizer", "Result", "RunLog", "TRConfig", "Turbo1", "TurboM",
           "checkpoint", "debug", "distributed_linalg", "fit_distributed_gp", "fit_gp_auto", "optimize", "parallel",
           "refactor_gp_auto", "run_bo", "run_bo_distributed"]
