"""Frozen dataclass configs for the GP surrogate and the trust region.

Copies of ``turbojax.config``'s ``GPConfig`` and ``TRConfig`` (importing them
would pull in all of JAX), with one change: ``use_pallas`` becomes
``use_kernel``, which routes kernel-matrix builds through the hand-written
CUDA kernel (``turbojax_torch.cuda_kernels``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Configuration of the GP surrogate.

    Attributes:
      kernel: one of "rbf", "matern12", "matern32", "matern52".
      use_ard: one lengthscale per input dimension if True, shared otherwise.
      use_kernel: None routes every kernel-matrix build through the CUDA
        kernel on CUDA tensors and through its plain PyTorch version on CPU
        tensors; False takes the plain version everywhere (the timing
        comparison in ``chip_smoke.py``).
      noise_floor: lower bound on the observation-noise variance.
      jitter: relative diagonal jitter added before every Cholesky
        (multiplied by the mean of the kernel diagonal).
      lengthscale_bounds / outputscale_bounds / noise_bounds: box constraints
        applied through a sigmoid reparameterization.
      fit_optimizer: "lbfgs" or "adam" (``fit_restarts`` restarts as one
        batch of lanes), "grid", or "grid+adam" (the grid argmax polished by
        Adam steps); see ``gp.fit_gp``.
      The remaining fields mirror ``turbojax.config.GPConfig`` so that a
      configuration reads the same in both packages.
    """

    kernel: str = "matern52"
    use_ard: bool = True
    use_kernel: Optional[bool] = None
    noise_floor: float = 1e-4
    jitter: float = 1e-6
    lengthscale_bounds: Tuple[float, float] = (0.005, 2.0)
    outputscale_bounds: Tuple[float, float] = (0.05, 20.0)
    noise_bounds: Tuple[float, float] = (1e-4, 0.2)
    fit_optimizer: str = "lbfgs"
    fit_maxiter: int = 50
    fit_maxiter_warm: Optional[int] = None
    fit_linesearch_steps: int = 12
    fit_lr: float = 0.1
    fit_restarts: int = 4
    fit_ftol: float = 0.0
    grid_polish_both: bool = False
    grid_warm_start: bool = True
    learn_mean: bool = False
    fit_prior: str = "none"
    y_warp: str = "none"


@dataclasses.dataclass(frozen=True)
class TRConfig:
    """TuRBO trust-region hyperparameters: initial side length 0.8, expand to
    at most 1.6 after ``succ_tol`` successes, halve after ``fail_tol``
    failures, restart when the length drops below ``0.5**7``. ``fail_tol``
    defaults to ``ceil(max(4, d) / batch_size)`` when None."""

    length_init: float = 0.8
    length_max: float = 1.6
    length_min: float = 0.5**7
    succ_tol: int = 3
    fail_tol: Optional[int] = None
    success_eps: float = 1e-3
    stagnation_tol: Optional[int] = None

    def resolved_fail_tol(self, dim: int, batch_size: int) -> int:
        if self.fail_tol is not None:
            return self.fail_tol
        return max(1, math.ceil(max(4.0, float(dim)) / batch_size))
