"""The hand-written CUDA kernel-matrix build and its plain PyTorch version
(port of ``turbojax.pallas_kernels``).

``kernel_matrix(z1, z2, outputscale, noise, kernel_name, add_noise)`` is the
wrapper every kernel-matrix build of the GP goes through:

* on CUDA tensors it launches ``csrc/kernel_matrix.cu`` (built for sm_90a
  with ``nvcc`` on first use, bound with ``ctypes``) or raises;
* on CPU tensors it computes the plain version ``kernel_matrix_reference``,
  the twin of ``turbojax.pallas_kernels._jnp_reference_kernel``.

There is no fallback from one to the other. Gradients go through
``torch.autograd.Function``: the forward is the kernel, the backward
recomputes the plain version under autograd, as the JAX package's
``custom_jvp`` does (a backward kernel is later work).

``LAUNCHES`` counts the kernel's launches, so that a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

from turbojax_torch import kernels as K

Tensor = torch.Tensor

#: Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

KERNEL_IDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "kernel_matrix.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "turbojax_torch"
)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y (row tiles) and gridDim.z (batch)
_TILE = 32  # output tile of csrc/kernel_matrix.cu

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    return None


def available() -> bool:
    """True when the kernel can be built and run: a CUDA device and nvcc."""
    return torch.cuda.is_available() and _find_nvcc() is not None


def library_path() -> str:
    """Where the shared library for the current sources lives: the name
    carries a hash of the source and the flags, so a changed source rebuilds."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libkernel_matrix_{digest}.so")


def _load() -> ctypes.CDLL:
    build()
    return _lib


def build() -> str:
    """Compile ``csrc/kernel_matrix.cu`` into ``build/turbojax_torch/`` if it
    is not there yet, load it, and return its path. Raises on any failure."""
    global _lib
    with _lib_lock:
        path = library_path()
        if _lib is not None and getattr(_lib, "_path", None) == path:
            return path
        if not os.path.exists(path):
            nvcc = _find_nvcc()
            if nvcc is None:
                raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernel")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, _SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.kernel_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.kernel_matrix_launch.restype = ctypes.c_int
        lib.kernel_matrix_error_string.argtypes = [ctypes.c_int]
        lib.kernel_matrix_error_string.restype = ctypes.c_char_p
        lib._path = path
        _lib = lib
        return path


def kernel_matrix_reference(
    z1: Tensor, z2: Tensor, outputscale: Tensor, noise: Tensor,
    kernel_name: str = "matern52", add_noise: bool = False,
) -> Tensor:
    """The plain PyTorch version of the kernel on pre-scaled inputs
    (lengthscale already divided out): ``k(z1, z2)`` (+ noise on the global
    diagonal). Inputs are (n, d)/(m, d) or batched (B, n, d)/(B, m, d);
    ``outputscale`` and ``noise`` are scalars or (B,)."""
    if z1.dim() == 3:
        outputscale = torch.as_tensor(outputscale, dtype=z1.dtype, device=z1.device)
        noise = torch.as_tensor(noise, dtype=z1.dtype, device=z1.device)
        outputscale = outputscale.reshape(-1, 1, 1)
        noise = noise.reshape(-1, 1, 1)
    k = K.from_sqdist(kernel_name, K.pairwise_sqdist(z1, z2), outputscale)
    if add_noise:
        eye = torch.eye(z1.shape[-2], z2.shape[-2], dtype=k.dtype, device=k.device)
        k = k + noise * eye
    return k


def _check(z1: Tensor, z2: Tensor, kernel_name: str):
    if kernel_name not in KERNEL_IDS:
        raise ValueError(f"unknown kernel {kernel_name!r}; available: {sorted(KERNEL_IDS)}")
    if z1.dim() not in (2, 3) or z2.dim() != z1.dim():
        raise ValueError(f"expected (n, d)/(m, d) or (B, n, d)/(B, m, d); got {tuple(z1.shape)}, {tuple(z2.shape)}")
    if z1.shape[-1] != z2.shape[-1] or z1.shape[:-2] != z2.shape[:-2]:
        raise ValueError(f"batch or feature sizes differ: {tuple(z1.shape)} vs {tuple(z2.shape)}")
    if z1.dtype != z2.dtype or z1.device != z2.device:
        raise ValueError(f"z1 and z2 differ in dtype or device: {z1.dtype}/{z1.device} vs {z2.dtype}/{z2.device}")


def _launch(z1: Tensor, z2: Tensor, outputscale: Tensor, noise: Tensor,
            kernel_name: str, add_noise: bool) -> Tensor:
    """Launch the CUDA kernel on (B, n, d) x (B, m, d) CUDA tensors."""
    global LAUNCHES
    if z1.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {z1.dtype}")
    if not (z1.is_contiguous() and z2.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous inputs")
    batch, n, d = z1.shape
    m = z2.shape[1]
    if batch > _MAX_GRID_YZ or (n + _TILE - 1) // _TILE > _MAX_GRID_YZ or max(n, m, d) >= 2**31:
        raise ValueError(f"shape too large for the CUDA kernel: batch {batch}, n {n}, m {m}, d {d}")
    out = torch.empty((batch, n, m), dtype=z1.dtype, device=z1.device)
    if out.numel() == 0:
        return out
    scal = torch.stack([
        torch.as_tensor(outputscale, dtype=z1.dtype, device=z1.device).expand(batch),
        torch.as_tensor(noise, dtype=z1.dtype, device=z1.device).expand(batch),
    ], dim=-1).contiguous()
    lib = _lib if _lib is not None else _load()
    with torch.cuda.device(z1.device):
        stream = torch.cuda.current_stream(z1.device).cuda_stream
        err = lib.kernel_matrix_launch(
            z1.data_ptr(), z2.data_ptr(), scal.data_ptr(), out.data_ptr(),
            batch, n, m, d, KERNEL_IDS[kernel_name], int(add_noise),
            int(z1.dtype == torch.float64), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"kernel_matrix launch failed: {lib.kernel_matrix_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    return out


def _forward(z1, z2, outputscale, noise, kernel_name, add_noise):
    if z1.device.type == "cpu":
        return kernel_matrix_reference(z1, z2, outputscale, noise, kernel_name, add_noise)
    if z1.device.type != "cuda":
        raise ValueError(f"kernel_matrix runs on CUDA or CPU tensors, not {z1.device}")
    if z1.dim() == 2:
        return _launch(z1[None], z2[None], outputscale, noise, kernel_name, add_noise)[0]
    return _launch(z1, z2, outputscale, noise, kernel_name, add_noise)


class KernelMatrix(torch.autograd.Function):
    """Forward: the CUDA kernel (the plain version on CPU tensors).
    Backward: the plain version recomputed under autograd."""

    @staticmethod
    def forward(ctx, z1, z2, outputscale, noise, kernel_name, add_noise):
        ctx.kernel_name, ctx.add_noise, ctx.same = kernel_name, add_noise, z2 is z1
        ctx.save_for_backward(z1, z2, outputscale, noise)
        return _forward(z1, z2, outputscale, noise, kernel_name, add_noise)

    @staticmethod
    def backward(ctx, grad_out):
        z1, z2, outputscale, noise = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in (z1, z2, outputscale, noise)]
            if ctx.same:
                leaves[1] = leaves[0]  # K(Z, Z): one input, one gradient
            k = kernel_matrix_reference(*leaves, ctx.kernel_name, ctx.add_noise)
            wanted = [i for i, t in enumerate(leaves) if t.requires_grad and not (ctx.same and i == 1)]
            grads = torch.autograd.grad(k, [leaves[i] for i in wanted], grad_out, allow_unused=True)
        out = [None, None, None, None]
        for i, g in zip(wanted, grads):
            out[i] = g
        return (*out, None, None)


def kernel_matrix(
    z1: Tensor, z2: Tensor, outputscale, noise,
    kernel_name: str = "matern52", add_noise: bool = False,
) -> Tensor:
    """K = k(z1, z2) (+ noise on the diagonal i == j) for pre-scaled,
    centered inputs, (n, d)/(m, d) -> (n, m) or batched (B, n, d)/(B, m, d)
    -> (B, n, m) with ``outputscale``/``noise`` scalars or (B,) tensors.

    CUDA tensors go through the hand-written kernel (or raise); CPU tensors
    through ``kernel_matrix_reference``. Pass the same tensor as ``z1`` and
    ``z2`` for K(Z, Z)."""
    _check(z1, z2, kernel_name)
    outputscale = torch.as_tensor(outputscale, dtype=z1.dtype, device=z1.device)
    noise = torch.as_tensor(noise, dtype=z1.dtype, device=z1.device)
    return KernelMatrix.apply(z1, z2, outputscale, noise, kernel_name, add_noise)
