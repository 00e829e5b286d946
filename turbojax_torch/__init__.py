"""turbojax_torch: the PyTorch/CUDA port of turbojax (GP Bayesian
optimization), for NVIDIA Hopper GPUs.

The JAX package ``turbojax`` is the reference this port is held against;
this package imports ``torch`` and never ``jax``. Every kernel-matrix build
goes through the hand-written CUDA kernel in ``csrc/kernel_matrix.cu`` on
CUDA tensors (``cuda_kernels``).

Precision rule (docs/DESIGN.md §2b): every contraction that feeds a
cancellation (the distance expansion, σ² = k** − Σv², cov = K** − vᵀv)
runs in full fp32, so TF32 is switched off here for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from turbojax_torch.api import Result, optimize  # noqa: E402
from turbojax_torch.config import GPConfig, TRConfig  # noqa: E402

__all__ = ["GPConfig", "Result", "TRConfig", "optimize"]
