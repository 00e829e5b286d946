"""The hand-written CUDA kernels and their plain PyTorch versions (port of
``turbojax.pallas_kernels``).

Two kernels, each in its own source under ``csrc/`` and its own shared
library, built for sm_90a with ``nvcc`` on first use (all sources at once,
one ``nvcc`` each, started together) and bound with ``ctypes``. Both share
the register-tiled fp32 mainloop of ``csrc/tile_mainloop.cuh``:

* ``kernel_matrix(z1, z2, outputscale, noise, kernel_name, add_noise,
  diag_offset)``, ``csrc/kernel_matrix.cu``: every kernel-matrix build of
  the GP goes through it, the row blocks of the distributed GP too; its
  plain version is ``kernel_matrix_reference``, the twin of
  ``turbojax.pallas_kernels._jnp_reference_kernel``;
* ``ts_cov(zs, v, outputscale, jitter, kernel_name)``, ``csrc/ts_cov.cu``:
  the Thompson-chunk covariance k(zs, zs) − vᵀv + jitter·I of
  ``turbojax.pallas_kernels.fused_ts_cov``; its plain version is
  ``ts_cov_reference``.

``kernel_matrix_plan`` and ``ts_cov_plan`` decide what each launch covers
(the tile size, the symmetric schedule, the split of ts_cov's n axis and
its workspace) from the shapes; each wrapper makes one call into its
library per call, with the per-batch scalars passed as pointers and batch
strides.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
computes the plain version. There is no fallback from one to the other.
Gradients of the kernel matrix go through ``torch.autograd.Function``: the
forward is the kernel, the backward recomputes the plain version under
autograd, as the JAX package's ``custom_jvp`` does. ``ts_cov`` takes no
gradient (nothing on the path differentiates a Thompson draw).

``LAUNCHES`` and ``TS_COV_LAUNCHES`` count each kernel's launches, so that
a run can show that its main path went through the kernels;
``LAUNCHES_F64`` and ``TS_COV_LAUNCHES_F64`` count those of the float64
instantiations among them (the f64 Thompson lane's).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import torch

from turbojax_torch import kernels as K

Tensor = torch.Tensor

#: Launches of the kernel-matrix kernel since import (or since a caller reset it).
LAUNCHES = 0
#: Launches of the TS-covariance kernel since import (or since a caller reset it).
TS_COV_LAUNCHES = 0
#: Of those, the launches of each kernel's float64 instantiation.
LAUNCHES_F64 = 0
TS_COV_LAUNCHES_F64 = 0

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
_MAX_GRID_X = 2**31 - 1  # CUDA's limit on gridDim.x: the tiles of one matrix
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y (ts_cov's splits) and gridDim.z (batch)
_TILE = 64  # output tile of csrc/kernel_matrix.cu
_TS_TILE = 128  # tile of csrc/ts_cov.cu's first pass
_TS_RESIDENT = 2  # first-pass blocks an SM holds at once
_TS_LEAD = 160  # rows' worth of work in the kernel term's epilogue, besides its 2d
_TS_MIN_CHUNK, _TS_MAX_CHUNK = 64, 384  # rows of one split: no shorter when filling the card, never longer
_H100_SMS = 132

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
_sm_counts: Dict[int, int] = {}


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
        # z1, z2, scale, stride, noise, stride, out, batch, n, m, d, symmetric, kernel, add_noise, double,
        # diag_offset, exact, stream
        launch.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr, *[i32] * 10, ptr]
    else:
        # zs, v, scale, stride, jitter, stride, out, workspace, batch, m, n, d, splits, chunk, lead, kernel, double,
        # stream
        launch.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr, ptr, *[i32] * 9, ptr]
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


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one launch covers, per batch entry: the ``tile`` × ``tile``
    output tiles of a matrix of ``row_tiles`` × ``col_tiles`` tiles, only
    the upper ones (ti ≤ tj) when ``symmetric``; and, for ts_cov, ``splits``
    slices of the training axis, ``chunk`` rows each shifted back by
    ``lead`` (see ``ts_cov_plan``), and a workspace of ``workspace``
    elements."""

    tile: int
    row_tiles: int
    col_tiles: int
    symmetric: bool
    splits: int = 1
    chunk: int = 0
    lead: int = 0
    workspace: int = 0

    @property
    def blocks(self) -> int:
        """Tiles launched per batch entry (gridDim.x)."""
        r = self.row_tiles
        return r * (r + 1) // 2 if self.symmetric else r * self.col_tiles

    def tiles(self) -> List[Tuple[int, int]]:
        """(ti, tj) of each launched tile in blockIdx.x order: the upper tiles
        column by column (blockIdx.x = tj (tj + 1) / 2 + ti, as
        ``tile::upper_tile`` decodes it) when symmetric, else row-major."""
        if self.symmetric:
            return [(ti, tj) for tj in range(self.row_tiles) for ti in range(tj + 1)]
        return [(ti, tj) for ti in range(self.row_tiles) for tj in range(self.col_tiles)]


def _check_grid(plan: LaunchPlan, batch: int, *sizes: int) -> None:
    if plan.blocks > _MAX_GRID_X or batch > _MAX_GRID_YZ or plan.splits >= _MAX_GRID_YZ or max(sizes) >= 2**31:
        raise ValueError(f"shape too large for the CUDA kernel: batch {batch}, sizes {sizes}")


@functools.lru_cache(maxsize=1024)
def kernel_matrix_plan(batch: int, n: int, m: int, d: int, symmetric: bool) -> LaunchPlan:
    """The launch of ``csrc/kernel_matrix.cu`` for (B, n, d) × (B, m, d): its
    64-tiles, only the upper ones for K(Z, Z)."""
    if symmetric and n != m:
        raise ValueError(f"a symmetric launch needs n == m, got {n} and {m}")
    plan = LaunchPlan(_TILE, _cdiv(n, _TILE), _cdiv(m, _TILE), symmetric)
    _check_grid(plan, batch, n, m, d)
    return plan


@functools.lru_cache(maxsize=1024)
def ts_cov_plan(batch: int, m: int, n: int, d: int = 0, sms: int = _H100_SMS) -> LaunchPlan:
    """The launch of ``csrc/ts_cov.cu`` for m candidates and n training rows.
    Its first pass runs one block per upper 128-tile of the (m, m) output
    and split of the n axis. Split s sums vᵀv over the rows [s·chunk − lead,
    (s+1)·chunk − lead) ∩ [0, n); the first split also computes the kernel
    term, which costs about ``lead`` = 2d + ``_TS_LEAD`` rows, so the blocks
    carry equal work. As many splits as fill ``_TS_RESIDENT`` blocks on
    every SM while each keeps ``_TS_MIN_CHUNK`` rows, and at least as many
    as keep every chunk within ``_TS_MAX_CHUNK`` rows (a short partial sum
    keeps the f32 error low). Each split and the kernel term take a
    workspace slot per tile: (splits + 1) × batch × tiles × 128² elements.
    The second pass finishes each tile from its slots."""
    side = _cdiv(m, _TS_TILE)
    plan = LaunchPlan(_TS_TILE, side, side, True)
    lead = 2 * d + _TS_LEAD
    work = n + lead
    fill = max(1, _TS_RESIDENT * sms // (batch * plan.blocks))
    splits = max(1, _cdiv(work, _TS_MAX_CHUNK), min(fill, work // _TS_MIN_CHUNK))
    chunk = _cdiv(work, splits)
    splits = _cdiv(work, chunk)
    plan = dataclasses.replace(plan, splits=splits, chunk=chunk, lead=lead,
                               workspace=(splits + 1) * batch * plan.blocks * _TS_TILE**2)
    _check_grid(plan, batch, n, m, d, 4 * plan.blocks)  # the second pass: a block per quarter tile
    return plan


def _param(value, like: Tensor) -> Tensor:
    """A scalar or per-batch parameter as a tensor of like's dtype and device.
    A Python number becomes a device tensor by a fill, not by a copy from
    the host, which would wait for the device."""
    if isinstance(value, (int, float)):
        return torch.full((), float(value), dtype=like.dtype, device=like.device)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _per_batch(value: Tensor, batch: int, what: str) -> Tuple[Tensor, int]:
    """A scalar or per-batch parameter as the kernels read it: the tensor and
    its batch stride in elements (0 when one value serves every entry)."""
    if value.numel() == 1:
        return value, 0
    if value.dim() != 1 or value.shape[0] != batch:
        raise ValueError(f"{what} must be a scalar or ({batch},), got {tuple(value.shape)}")
    return value, value.stride(0)


def kernel_matrix_reference(
    z1: Tensor, z2: Tensor, outputscale: Tensor, noise: Tensor,
    kernel_name: str = "matern52", add_noise: bool = False, diag_offset: Optional[int] = None,
) -> Tensor:
    """The plain PyTorch version of the kernel on pre-scaled inputs
    (lengthscale already divided out): ``k(z1, z2)`` (+ noise on the global
    diagonal). Inputs are (n, d)/(m, d) or batched (B, n, d)/(B, m, d);
    ``outputscale`` and ``noise`` are scalars or (B,). ``diag_offset``: z1
    is a row block whose row i is row i + diag_offset of the whole; the
    global diagonal j == i + diag_offset takes the exact self-value
    outputscale (+ noise) there."""
    if z1.dim() == 3:
        outputscale = torch.as_tensor(outputscale, dtype=z1.dtype, device=z1.device)
        noise = torch.as_tensor(noise, dtype=z1.dtype, device=z1.device)
        outputscale = outputscale.reshape(-1, 1, 1)
        noise = noise.reshape(-1, 1, 1)
    k = K.from_sqdist(kernel_name, K.pairwise_sqdist(z1, z2), outputscale)
    n, m = z1.shape[-2], z2.shape[-2]
    if diag_offset is None:
        if add_noise:
            k = k + noise * torch.eye(n, m, dtype=k.dtype, device=k.device)
        return k
    on = torch.arange(n, device=k.device)[:, None] + diag_offset == torch.arange(m, device=k.device)[None, :]
    k = torch.where(on, outputscale, k)
    return k + noise * on.to(k.dtype) if add_noise else k


def _check(z1: Tensor, z2: Tensor, kernel_name: str):
    if kernel_name not in KERNEL_IDS:
        raise ValueError(f"unknown kernel {kernel_name!r}; available: {sorted(KERNEL_IDS)}")
    if z1.dim() not in (2, 3) or z2.dim() != z1.dim():
        raise ValueError(f"expected (n, d)/(m, d) or (B, n, d)/(B, m, d); got {tuple(z1.shape)}, {tuple(z2.shape)}")
    if z1.shape[-1] != z2.shape[-1] or z1.shape[:-2] != z2.shape[:-2]:
        raise ValueError(f"batch or feature sizes differ: {tuple(z1.shape)} vs {tuple(z2.shape)}")
    if z1.dtype != z2.dtype or z1.device != z2.device:
        raise ValueError(f"z1 and z2 differ in dtype or device: {z1.dtype}/{z1.device} vs {z2.dtype}/{z2.device}")


def _kernel_matrix_args(z1: Tensor, z2: Tensor, outputscale: Tensor, noise: Tensor, same: bool):
    """What ``csrc/kernel_matrix.cu`` is launched with: (B, n, d)/(B, m, d)
    inputs (a 2-D pair as a batch of one), outputscale and noise each with
    its batch stride, and the plan, symmetric when the caller passed one
    tensor as both inputs (``same``, decided before the batch axis is
    added: ``z1[None]`` and ``z2[None]`` are different objects)."""
    if z1.dim() == 2:
        z1, z2 = z1[None], z2[None]
    batch, n, d = z1.shape
    plan = kernel_matrix_plan(batch, n, z2.shape[1], d, same)
    return z1, z2, _per_batch(outputscale, batch, "outputscale"), _per_batch(noise, batch, "noise"), plan


def _launch(z1: Tensor, z2: Tensor, outputscale: Tensor, noise: Tensor,
            kernel_name: str, add_noise: bool, same: bool, diag_offset: Optional[int] = None) -> Tensor:
    """Launch the CUDA kernel on (n, d)/(m, d) or (B, n, d)/(B, m, d) CUDA
    tensors: one call into the library."""
    global LAUNCHES, LAUNCHES_F64
    if z1.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {z1.dtype}")
    if not (z1.is_contiguous() and z2.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous inputs")
    if z1.shape[-2] == 0 or z2.shape[-2] == 0 or (z1.dim() == 3 and z1.shape[0] == 0):
        return torch.empty((*z1.shape[:-1], z2.shape[-2]), dtype=z1.dtype, device=z1.device)
    # the symmetric schedule mirrors tiles about i == j: not for a row block's offset diagonal
    same = same and not diag_offset
    a, b, (scale, scale_stride), (nz, noise_stride), plan = _kernel_matrix_args(z1, z2, outputscale, noise, same)
    batch, n, d = a.shape
    m = b.shape[1]
    out = torch.empty((batch, n, m), dtype=z1.dtype, device=z1.device)
    lib = _load("kernel_matrix")
    index = z1.device.index
    with torch.cuda.device(index):
        err = lib.kernel_matrix_launch(
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), scale_stride, nz.data_ptr(), noise_stride,
            out.data_ptr(), batch, n, m, d, int(plan.symmetric), KERNEL_IDS[kernel_name],
            int(add_noise), int(z1.dtype == torch.float64), diag_offset or 0, int(diag_offset is not None),
            torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"kernel_matrix launch failed: {lib.kernel_matrix_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    LAUNCHES_F64 += z1.dtype == torch.float64
    return out if z1.dim() == 3 else out[0]


def _forward(z1, z2, outputscale, noise, kernel_name, add_noise, same, diag_offset):
    if z1.device.type == "cpu":
        return kernel_matrix_reference(z1, z2, outputscale, noise, kernel_name, add_noise, diag_offset)
    if z1.device.type != "cuda":
        raise ValueError(f"kernel_matrix runs on CUDA or CPU tensors, not {z1.device}")
    return _launch(z1, z2, outputscale, noise, kernel_name, add_noise, same, diag_offset)


class KernelMatrix(torch.autograd.Function):
    """Forward: the CUDA kernel (the plain version on CPU tensors).
    Backward: the plain version recomputed under autograd."""

    @staticmethod
    def forward(ctx, z1, z2, outputscale, noise, kernel_name, add_noise, diag_offset=None):
        ctx.kernel_name, ctx.add_noise, ctx.same, ctx.diag_offset = kernel_name, add_noise, z2 is z1, diag_offset
        ctx.save_for_backward(z1, z2, outputscale, noise)
        return _forward(z1, z2, outputscale, noise, kernel_name, add_noise, ctx.same, diag_offset)

    @staticmethod
    def backward(ctx, grad_out):
        z1, z2, outputscale, noise = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in (z1, z2, outputscale, noise)]
            if ctx.same:
                leaves[1] = leaves[0]  # K(Z, Z): one input, one gradient
            k = kernel_matrix_reference(*leaves, ctx.kernel_name, ctx.add_noise, ctx.diag_offset)
            wanted = [i for i, t in enumerate(leaves) if t.requires_grad and not (ctx.same and i == 1)]
            grads = torch.autograd.grad(k, [leaves[i] for i in wanted], grad_out, allow_unused=True)
        out = [None, None, None, None]
        for i, g in zip(wanted, grads):
            out[i] = g
        return (*out, None, None, None)


def kernel_matrix(
    z1: Tensor, z2: Tensor, outputscale, noise,
    kernel_name: str = "matern52", add_noise: bool = False, diag_offset: Optional[int] = None,
) -> Tensor:
    """K = k(z1, z2) (+ noise on the diagonal i == j) for pre-scaled,
    centered inputs, (n, d)/(m, d) -> (n, m) or batched (B, n, d)/(B, m, d)
    -> (B, n, m) with ``outputscale``/``noise`` scalars or (B,) tensors.

    ``diag_offset`` (an int ≥ 0): z1 is a row block whose row i is row
    i + diag_offset of the whole matrix, as in the distributed GP's row
    blocks of K(X, X); the global diagonal j == i + diag_offset takes the
    exact self-value outputscale (+ noise), whatever round-off the two
    copies of the point carry.

    CUDA tensors go through the hand-written kernel (or raise); CPU tensors
    through ``kernel_matrix_reference``. Pass the same tensor as ``z1`` and
    ``z2`` for K(Z, Z)."""
    _check(z1, z2, kernel_name)
    if diag_offset is not None and not 0 <= diag_offset < 2**31:
        raise ValueError(f"diag_offset must be an int in [0, 2**31), got {diag_offset}")
    outputscale, noise = _param(outputscale, z1), _param(noise, z1)
    return KernelMatrix.apply(z1, z2, outputscale, noise, kernel_name, add_noise, diag_offset)


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


def _ts_cov_args(zs: Tensor, v: Tensor, outputscale: Tensor, jitter: Tensor, sms: int = _H100_SMS):
    """What ``csrc/ts_cov.cu`` is launched with: contiguous (B, m, d)/(B, n, m)
    inputs (a 2-D pair as a batch of one), outputscale and jitter each with
    its batch stride, and the plan."""
    if zs.dim() == 2:
        zs, v = zs[None], v[None]
    zs, v = zs.contiguous(), v.contiguous()
    batch, m, d = zs.shape
    plan = ts_cov_plan(batch, m, v.shape[1], d, sms)
    return zs, v, _per_batch(outputscale, batch, "outputscale"), _per_batch(jitter, batch, "jitter"), plan


def _launch_ts_cov(zs: Tensor, v: Tensor, outputscale: Tensor, jitter: Tensor, kernel_name: str) -> Tensor:
    """Launch the CUDA kernel on (m, d)/(n, m) or (B, m, d)/(B, n, m) CUDA
    tensors: one call into the library (its two passes)."""
    global TS_COV_LAUNCHES, TS_COV_LAUNCHES_F64
    if zs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA kernel takes float32 or float64, not {zs.dtype}")
    if zs.shape[-2] == 0 or (zs.dim() == 3 and zs.shape[0] == 0):
        return torch.empty((*zs.shape[:-1], zs.shape[-2]), dtype=zs.dtype, device=zs.device)
    z, vv, (scale, scale_stride), (jit, jitter_stride), plan = _ts_cov_args(
        zs, v, outputscale, jitter, _sms(zs.device))
    batch, m, d = z.shape
    out = torch.empty((batch, m, m), dtype=zs.dtype, device=zs.device)
    ws = torch.empty(plan.workspace, dtype=zs.dtype, device=zs.device)
    lib = _load("ts_cov")
    index = zs.device.index
    with torch.cuda.device(index):
        err = lib.ts_cov_launch(
            z.data_ptr(), vv.data_ptr(), scale.data_ptr(), scale_stride, jit.data_ptr(), jitter_stride,
            out.data_ptr(), ws.data_ptr(), batch, m, vv.shape[1], d,
            plan.splits, plan.chunk, plan.lead, KERNEL_IDS[kernel_name], int(zs.dtype == torch.float64),
            torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ts_cov launch failed: {lib.ts_cov_error_string(err).decode()} ({err})")
    TS_COV_LAUNCHES += 1
    TS_COV_LAUNCHES_F64 += zs.dtype == torch.float64
    return out if zs.dim() == 3 else out[0]


def ts_cov(zs: Tensor, v: Tensor, outputscale, jitter, kernel_name: str = "matern52") -> Tensor:
    """Cov = k(zs, zs) − vᵀv + jitter·I for pre-scaled, centered candidates
    zs and the forward solve v = L⁻¹K(X, zs): (m, d)/(n, m) -> (m, m) or
    batched (B, m, d)/(B, n, m) -> (B, m, m), with ``outputscale``/``jitter``
    scalars or (B,) tensors.

    CUDA tensors go through ``csrc/ts_cov.cu`` (or raise); CPU tensors
    through ``ts_cov_reference``."""
    _check_ts(zs, v, kernel_name)
    outputscale, jitter = _param(outputscale, zs), _param(jitter, zs)
    if zs.device.type == "cpu":
        return ts_cov_reference(zs, v, outputscale, jitter, kernel_name)
    if zs.device.type != "cuda":
        raise ValueError(f"ts_cov runs on CUDA or CPU tensors, not {zs.device}")
    return _launch_ts_cov(zs, v, outputscale, jitter, kernel_name)
