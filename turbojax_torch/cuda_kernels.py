"""The hand-written CUDA kernels and their plain PyTorch versions (port of
``turbojax.pallas_kernels``).

Two kernels, each in its own source under ``csrc/`` and its own shared
library, built for sm_90a with ``nvcc`` on first use (all sources at once,
one ``nvcc`` each, started together) and bound with ``ctypes``:

* ``kernel_matrix(z1, z2, outputscale, noise, kernel_name, add_noise)``,
  ``csrc/kernel_matrix.cu``: every kernel-matrix build of the GP goes
  through it; its plain version is ``kernel_matrix_reference``, the twin of
  ``turbojax.pallas_kernels._jnp_reference_kernel``;
* ``ts_cov(zs, v, outputscale, jitter, kernel_name)``, ``csrc/ts_cov.cu``:
  the Thompson-chunk covariance k(zs, zs) − vᵀv + jitter·I of
  ``turbojax.pallas_kernels.fused_ts_cov``; its plain version is
  ``ts_cov_reference``.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
computes the plain version. There is no fallback from one to the other.
Gradients of the kernel matrix go through ``torch.autograd.Function``: the
forward is the kernel, the backward recomputes the plain version under
autograd, as the JAX package's ``custom_jvp`` does. ``ts_cov`` takes no
gradient (nothing on the path differentiates a Thompson draw).

``LAUNCHES`` and ``TS_COV_LAUNCHES`` count each kernel's launches, so that
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

import torch

from turbojax_torch import kernels as K

Tensor = torch.Tensor

#: Launches of the kernel-matrix kernel since import (or since a caller reset it).
LAUNCHES = 0
#: Launches of the TS-covariance kernel since import (or since a caller reset it).
TS_COV_LAUNCHES = 0

KERNEL_IDS = {"rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3}

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCES = ("kernel_matrix", "ts_cov")  # csrc/<name>.cu -> lib<name>_<digest>.so
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "turbojax_torch"
)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y (row tiles) and gridDim.z (batch)
_TILE = 32  # output tile of csrc/kernel_matrix.cu
_TS_TILE = 64  # output tile of csrc/ts_cov.cu

_libs: Dict[str, ctypes.CDLL] = {}
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


def _digest() -> str:
    """Hash of every file under ``csrc/`` (sources and headers) and the
    flags: a change to any of them rebuilds every library."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where the shared library of ``csrc/<name>.cu`` lives for the current
    sources."""
    return os.path.join(_BUILD_DIR, f"lib{name}_{_digest()}.so")


def _bind(lib: ctypes.CDLL, name: str) -> None:
    launch = getattr(lib, f"{name}_launch")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "kernel_matrix":
        launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
    else:
        launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    launch.restype = i32
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p


def build() -> Dict[str, str]:
    """Compile every ``csrc/<name>.cu`` whose library is not there yet into
    ``build/turbojax_torch/`` (one ``nvcc`` per source, all started
    together), load them all, and return {name: path}. Raises on any
    failure."""
    with _lib_lock:
        paths = {name: library_path(name) for name in _SOURCES}
        if all(getattr(_libs.get(n), "_path", None) == p for n, p in paths.items()):
            return paths
        missing = {n: p for n, p in paths.items() if not os.path.exists(p)}
        if missing:
            nvcc = _find_nvcc()
            if nvcc is None:
                raise RuntimeError("nvcc not found (PATH, CUDA_HOME): cannot build the CUDA kernels")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            procs = {}
            for name in missing:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                src = os.path.join(_CSRC, f"{name}.cu")
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                ))
            failures = []
            for name, (tmp, proc) in procs.items():
                out, err = proc.communicate()
                if proc.returncode != 0:
                    os.unlink(tmp)
                    failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}\n{err}")
                else:
                    os.replace(tmp, missing[name])
            if failures:
                raise RuntimeError("\n".join(failures))
        for name, path in paths.items():
            lib = ctypes.CDLL(path)
            _bind(lib, name)
            lib._path = path
            _libs[name] = lib
        return paths


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
    return lib


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
    lib = _load("kernel_matrix")
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


def ts_cov_reference(
    zs: Tensor, v: Tensor, outputscale, jitter, kernel_name: str = "matern52",
) -> Tensor:
    """The plain PyTorch version of the TS-chunk covariance on pre-scaled,
    centered candidates: ``k(zs, zs) − vᵀv + jitter·I``. Inputs are
    (m, d)/(n, m) or batched (B, m, d)/(B, n, m); ``outputscale`` and
    ``jitter`` are scalars or (B,)."""
    jitter = torch.as_tensor(jitter, dtype=zs.dtype, device=zs.device)
    if zs.dim() == 3:
        jitter = jitter.reshape(-1, 1, 1)
    k = kernel_matrix_reference(zs, zs, outputscale, 0.0, kernel_name, False)
    eye = torch.eye(zs.shape[-2], dtype=zs.dtype, device=zs.device)
    return k - v.mT @ v + jitter * eye


def _check_ts(zs: Tensor, v: Tensor, kernel_name: str):
    if kernel_name not in KERNEL_IDS:
        raise ValueError(f"unknown kernel {kernel_name!r}; available: {sorted(KERNEL_IDS)}")
    if zs.dim() not in (2, 3) or v.dim() != zs.dim():
        raise ValueError(f"expected (m, d)/(n, m) or (B, m, d)/(B, n, m); got {tuple(zs.shape)}, {tuple(v.shape)}")
    if v.shape[-1] != zs.shape[-2] or v.shape[:-2] != zs.shape[:-2]:
        raise ValueError(f"batch or candidate sizes differ: {tuple(zs.shape)} vs {tuple(v.shape)}")
    if zs.dtype != v.dtype or zs.device != v.device:
        raise ValueError(f"zs and v differ in dtype or device: {zs.dtype}/{zs.device} vs {v.dtype}/{v.device}")


def _launch_ts_cov(zs: Tensor, v: Tensor, outputscale: Tensor, jitter: Tensor, kernel_name: str) -> Tensor:
    """Launch the CUDA kernel on (B, m, d) x (B, n, m) CUDA tensors."""
    global TS_COV_LAUNCHES
    if zs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {zs.dtype}")
    zs, v = zs.contiguous(), v.contiguous()
    batch, m, d = zs.shape
    n = v.shape[1]
    if batch > _MAX_GRID_YZ or (m + _TS_TILE - 1) // _TS_TILE > _MAX_GRID_YZ or max(n, m, d) >= 2**31:
        raise ValueError(f"shape too large for the CUDA kernel: batch {batch}, m {m}, n {n}, d {d}")
    out = torch.empty((batch, m, m), dtype=zs.dtype, device=zs.device)
    if out.numel() == 0:
        return out
    scal = torch.stack([outputscale.expand(batch), jitter.expand(batch)], dim=-1).contiguous()
    lib = _load("ts_cov")
    with torch.cuda.device(zs.device):
        stream = torch.cuda.current_stream(zs.device).cuda_stream
        err = lib.ts_cov_launch(
            zs.data_ptr(), v.data_ptr(), scal.data_ptr(), out.data_ptr(),
            batch, m, n, d, KERNEL_IDS[kernel_name], int(zs.dtype == torch.float64), stream,
        )
    if err != 0:
        raise RuntimeError(f"ts_cov launch failed: {lib.ts_cov_error_string(err).decode()} ({err})")
    TS_COV_LAUNCHES += 1
    return out


def ts_cov(zs: Tensor, v: Tensor, outputscale, jitter, kernel_name: str = "matern52") -> Tensor:
    """Cov = k(zs, zs) − vᵀv + jitter·I for pre-scaled, centered candidates
    zs and the forward solve v = L⁻¹K(X, zs): (m, d)/(n, m) -> (m, m) or
    batched (B, m, d)/(B, n, m) -> (B, m, m), with ``outputscale``/``jitter``
    scalars or (B,) tensors.

    CUDA tensors go through ``csrc/ts_cov.cu`` (or raise); CPU tensors
    through ``ts_cov_reference``."""
    _check_ts(zs, v, kernel_name)
    outputscale = torch.as_tensor(outputscale, dtype=zs.dtype, device=zs.device)
    jitter = torch.as_tensor(jitter, dtype=zs.dtype, device=zs.device)
    if zs.device.type == "cpu":
        return ts_cov_reference(zs, v, outputscale, jitter, kernel_name)
    if zs.device.type != "cuda":
        raise ValueError(f"ts_cov runs on CUDA or CPU tensors, not {zs.device}")
    if zs.dim() == 2:
        return _launch_ts_cov(zs[None], v[None], outputscale, jitter, kernel_name)[0]
    return _launch_ts_cov(zs, v, outputscale, jitter, kernel_name)
