"""The hand-written kernels timed on one GPU at the shapes the paths launch.

    python3 -m turbojax_torch.kernel_bench
    python3 -m turbojax_torch.kernel_bench --baseline DIR
    python3 -m turbojax_torch.kernel_bench --chol
    python3 -m turbojax_torch.kernel_bench --baseline DIR --bitwise

For each shape (float32, and the f64 Thompson lane's shapes in float64) one
JSON line: the kernel's time and the plain version's by
CUDA events over back-to-back calls (at small shapes that is the host's
time per call), the kernel's device time per call from ``torch.profiler``,
the bound (the larger of the bytes over 3.35 TB/s and the operations over
67 TFLOP/s, an H100 SXM's peak in fp32 outside the tensor cores and in fp64
on them) with the resource
that sets it, the kernel's share of it, and ``library_ms`` (events) and
``library_device_ms`` (profiler), one PyTorch call's time where one
computes a comparable function (``v.mT @ v`` for ts_cov's Gram part; none
for the kernel matrix). Then the
``bench.py``-style iteration with the kernels and with the plain versions
(its sizes are config 3's, ``ts_q10``), the appends of ``bo._append_batch``
against one refactorization (``--chol`` prints only this table, which
``BOConfig.resolved_chol_mode`` follows), and one L-BFGS fit at config 2's
final size with its loss evaluations.

``--baseline DIR`` also times, in turns with this tree's kernels, the
kernels of another checkout's ``turbojax_torch/cuda_kernels.py`` (for
example the parent commit unpacked from ``git archive`` into a git-ignored
directory), built from that checkout's ``csrc/`` into its own ``build/``;
with ``--bitwise`` it only compares the float32 outputs of both at every
float32 shape, bit for bit.
Every line carries the card's ``nvidia-smi`` name and power limit. Needs a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from turbojax_torch import cuda_kernels as CK

HBM_BYTES_PER_S = 3.35e12
# fp64's peak is the tensor cores' (DMMA is exact fp64; cuBLAS's DGEMM runs
# above the 34 TFLOP/s of the fp64 CUDA cores), fp32's is outside them (TF32
# is not fp32)
FLOPS_PER_S = 67e12

# (label, batch, n, m, d, K(Z, Z), kernel function): config 5's grid at the
# 2000 and 512 rungs, its polish forward and cached factor, the small
# regions' factor, a TS cross matrix; config 4's grid and factor; the
# bench's matrices; config 1's factor, posterior cross and append row
# (60 points, d = 2, rbf) and config 2's L-BFGS lanes, cross and append row
# (112 points, d = 6)
KM_SHAPES = [
    ("grid16_2000x2000_d60", 16, 2000, 2000, 60, True, "matern52"),
    ("polish_2000x2000_d60", 1, 2000, 2000, 60, True, "matern52"),
    ("grid64_512x512_d60", 64, 512, 512, 60, True, "matern52"),
    ("regions4_512x512_d60", 4, 512, 512, 60, True, "matern52"),
    ("ts_cross_2000x1000_d60", 1, 2000, 1000, 60, False, "matern52"),
    ("grid15_1000x1000_d10", 15, 1000, 1000, 10, True, "matern52"),
    ("kxx_1000x1000_d10", 1, 1000, 1000, 10, True, "matern52"),
    ("cross_1000x1000_d10", 1, 1000, 1000, 10, False, "matern52"),
    ("bench_kxx_2048x2048_d10", 1, 2048, 2048, 10, True, "matern52"),
    ("bench_cross_2048x5000_d10", 1, 2048, 5000, 10, False, "matern52"),
    ("bo1_kxx_60x60_d2_rbf", 1, 60, 60, 2, True, "rbf"),
    ("bo1_cross_60x2000_d2_rbf", 1, 60, 2000, 2, False, "rbf"),
    ("bo1_append_1x60_d2_rbf", 1, 1, 60, 2, False, "rbf"),
    ("bo2_lanes4_112x112_d6", 4, 112, 112, 6, True, "matern52"),
    ("bo2_cross_112x2000_d6", 1, 112, 2000, 6, False, "matern52"),
    ("bo2_append_1x112_d6", 1, 1, 112, 6, False, "matern52"),
    # the pathwise sampler's cross k(x*, X): config 5's 5000 candidates against
    # its largest rung, config 4's 1000 against its 1000-row buffer
    ("pathwise_cross_5000x2000_d60", 1, 5000, 2000, 60, False, "matern52"),
    ("pathwise_cross_1000x1000_d10", 1, 1000, 1000, 10, False, "matern52"),
    # large-N plain BO at d = 10 (bench_large_n, chip_smoke phase 9): K(X, X) at
    # 16384 points (the factorization and each sequential grid row), the grid
    # fit's 15 rows and the L-BFGS fit's 4 lanes at 8192, the pathwise cross of
    # 5000 candidates and a posterior chunk of 1000 against 16384 rows
    ("large_kxx_16384x16384_d10", 1, 16384, 16384, 10, True, "matern52"),
    ("large_grid15_8192x8192_d10", 15, 8192, 8192, 10, True, "matern52"),
    ("large_lbfgs4_8192x8192_d10", 4, 8192, 8192, 10, True, "matern52"),
    ("large_cross_5000x16384_d10", 1, 5000, 16384, 10, False, "matern52"),
    ("large_post_16384x1000_d10", 1, 16384, 1000, 10, False, "matern52"),
]
# (label, batch, m, n, d): the single chunks the paths launch
TS_SHAPES = [
    ("path_1x1000_n2000_d60", 1, 1000, 2000, 60),
    ("path_1x1000_n512_d60", 1, 1000, 512, 60),
    ("path_1x1000_n1000_d10", 1, 1000, 1000, 10),
    ("bench_1x1000_n2048_d10", 1, 1000, 2048, 10),
    ("large_1x1000_n16384_d10", 1, 1000, 16384, 10),  # the exact Thompson chunk at large N
]
# the f64 Thompson lane (ts_dtype="float64"): acq._state_f64's refactorization,
# posterior_cov's cross and the chunk covariance, at config 4's sizes (the
# lane of phase 8) and at config 5's largest rung
KM_F64_SHAPES = [
    ("f64_kxx_1000x1000_d10", 1, 1000, 1000, 10, True, "matern52"),
    ("f64_cross_1000x1000_d10", 1, 1000, 1000, 10, False, "matern52"),
    ("f64_kxx_2000x2000_d60", 1, 2000, 2000, 60, True, "matern52"),
    ("f64_cross_2000x1000_d60", 1, 2000, 1000, 60, False, "matern52"),
]
TS_F64_SHAPES = [
    ("f64_path_1x1000_n1000_d10", 1, 1000, 1000, 10),
    ("f64_path_1x1000_n2000_d60", 1, 1000, 2000, 60),
]
# (label, rows, n, d, diag_offset): the distributed GP's row blocks of K(X, X)
# at N = 16384, d = 10, the exact self-value on the global diagonal: a mesh
# of one device (the whole matrix in the symmetric schedule, chip_smoke.py
# phase 10) and each rank's block on a mesh of two (here rank 1's)
KM_OFFSET_SHAPES = [
    ("dist_kxx_16384x16384_d10", 16384, 16384, 10, 0),
    ("dist_rowblock_8192x16384_d10_off8192", 8192, 16384, 10, 8192),
]
KM_HEADLINE, TS_HEADLINE = KM_SHAPES[0][0], TS_SHAPES[0][0]
KM_LARGE_HEADLINE, TS_LARGE_HEADLINE = "large_kxx_16384x16384_d10", "large_1x1000_n16384_d10"
KM_F64_HEADLINE, TS_F64_HEADLINE = KM_F64_SHAPES[0][0], TS_F64_SHAPES[0][0]
_EPILOGUE_OPS = 12  # per distinct entry: d² from the norms, clamp, sqrt, exp and the polynomial


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _bound(nbytes: float, ops: float) -> Dict[str, object]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def kernel_matrix_bound(batch, n, m, d, same, dtype=torch.float32) -> Dict[str, object]:
    """Each input read once, the output written once; 2d + 12 operations
    per distinct entry (K(Z, Z) has n(n+1)/2 of them)."""
    size = torch.finfo(dtype).bits // 8
    entries = batch * (n * (n + 1) // 2 if same else n * m)
    nbytes = size * batch * (n * d + (0 if same else m * d) + n * m)
    return _bound(nbytes, entries * (2 * d + _EPILOGUE_OPS))


def ts_cov_bound(batch, m, n, d, dtype=torch.float32) -> Dict[str, object]:
    """zs and v read once, the output written once; 2(n + d) + 12 operations
    per distinct entry of the symmetric output."""
    size = torch.finfo(dtype).bits // 8
    entries = batch * m * (m + 1) // 2
    nbytes = size * batch * (m * d + n * m + m * m)
    return _bound(nbytes, entries * (2 * (n + d) + _EPILOGUE_OPS))


def _event_ms(fn: Callable[[], object], reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: Dict[str, Callable[[], object]], reps: int, warmup: int = 3) -> Dict[str, float]:
    """ms per call of each function by CUDA events: one window each in the
    given order, then one each in reverse order; the mean of the two."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    order = list(fns)
    times = {k: [] for k in order}
    for label in order + order[::-1]:
        times[label].append(_event_ms(fns[label], reps))
    return {k: 0.5 * (a + b) for k, (a, b) in times.items()}


def device_ms(fn: Callable[[], object], reps: int) -> Optional[float]:
    """Device time per call from torch.profiler: the kernels' and copies'
    own time over ``reps`` calls. None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from turbojax_torch.profile_config5 import _self_device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages() if e.cpu_time_total == 0)
    return us / 1e3 / reps if us > 0 else None


def _inputs_km(gen, batch, n, m, d, same, dtype=torch.float32):
    kw = dict(device="cuda", dtype=dtype)
    z1 = torch.rand((batch, n, d), generator=gen, **kw) / math.sqrt(d / 24)
    z1 = (z1 - z1.mean(dim=-2, keepdim=True)).contiguous()
    z2 = z1 if same else (torch.rand((batch, m, d), generator=gen, **kw) / math.sqrt(d / 24)).contiguous()
    if batch == 1:
        z1 = z1[0]
        z2 = z1 if same else z2[0]
        return z1, z2, torch.tensor(1.3, **kw), torch.tensor(1e-3, **kw)
    return z1, z2, torch.full((batch,), 1.3, **kw), torch.full((batch,), 1e-3, **kw)


def _inputs_ts(gen, batch, m, n, d, dtype=torch.float32):
    kw = dict(device="cuda", dtype=dtype)
    zs = torch.rand((batch, m, d), generator=gen, **kw) / math.sqrt(d / 24)
    zs = (zs - zs.mean(dim=-2, keepdim=True)).contiguous()
    v = torch.randn((batch, n, m), generator=gen, **kw) / math.sqrt(n)
    jitter = torch.zeros((), **kw)
    if batch == 1:
        return zs[0], v[0], torch.tensor(1.3, **kw), jitter
    return zs, v, torch.full((batch,), 1.3, **kw), jitter


def _line(kind, label, dims, bound, times, dev, base_dev, smi, lib_dev=None) -> Dict[str, object]:
    line = {"kernel": kind, "shape": label, **dims, **bound, "kernel_ms": times["kernel"],
            "plain_ms": times["plain"], "library_ms": times.get("library"), "library_device_ms": lib_dev,
            "device_ms": dev, "share_of_bound": (bound["bound_ms"] / dev) if dev else None, "card": smi}
    if "baseline" in times:
        line.update(baseline_ms=times["baseline"], baseline_device_ms=base_dev)
    return line


def measure_kernels(smi: str, baseline=None, reps: int = 20, emit=print) -> Dict[str, Dict[str, object]]:
    """Times both kernels at KM_SHAPES and TS_SHAPES in float32 and at
    KM_F64_SHAPES and TS_F64_SHAPES in float64 (with ``baseline``, another
    cuda_kernels module, in turns), and the kernel matrix at
    KM_OFFSET_SHAPES (with no baseline: ``diag_offset`` is this PR's); returns {label: line} and passes each
    line to ``emit`` as it is measured."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    lines = {}
    mods = {"kernel": CK, **({"baseline": baseline} if baseline is not None else {})}
    km = [(s, torch.float32) for s in KM_SHAPES] + [(s, torch.float64) for s in KM_F64_SHAPES]
    for (label, batch, n, m, d, same, kfn), dtype in km:
        z1, z2, s, nz = _inputs_km(gen, batch, n, m, d, same, dtype)
        fns = {"plain": lambda: CK.kernel_matrix_reference(z1, z2, s, nz, kfn, same)}
        fns.update({k: (lambda mod=mod: mod.kernel_matrix(z1, z2, s, nz, kfn, same)) for k, mod in mods.items()})
        times = in_turns(fns, reps)
        dev = device_ms(fns["kernel"], reps)
        base_dev = device_ms(fns["baseline"], reps) if baseline is not None else None
        dims = {"batch": batch, "n": n, "m": m, "d": d, "same": same, "kernel_fn": kfn, "dtype": str(dtype)[6:]}
        lines[label] = _line("kernel_matrix", label, dims, kernel_matrix_bound(batch, n, m, d, same, dtype), times,
                             dev, base_dev, smi)
        emit(lines[label])
        del z1, z2
    for label, rows, n, d, off in KM_OFFSET_SHAPES:
        z, _, s, nz = _inputs_km(gen, 1, n, n, d, True)
        zr = z if rows == n else z[off:off + rows]
        fns = {"plain": lambda: CK.kernel_matrix_reference(zr, z, s, nz, "matern52", True, off),
               "kernel": lambda: CK.kernel_matrix(zr, z, s, nz, "matern52", True, off)}
        times = in_turns(fns, reps)
        dims = {"batch": 1, "n": rows, "m": n, "d": d, "same": rows == n, "diag_offset": off, "kernel_fn": "matern52",
                "dtype": "float32"}
        lines[label] = _line("kernel_matrix", label, dims, kernel_matrix_bound(1, rows, n, d, rows == n), times,
                             device_ms(fns["kernel"], reps), None, smi)
        emit(lines[label])
        del z, zr
    ts = [(s, torch.float32) for s in TS_SHAPES] + [(s, torch.float64) for s in TS_F64_SHAPES]
    for (label, batch, m, n, d), dtype in ts:
        zs, v, s, jit = _inputs_ts(gen, batch, m, n, d, dtype)
        fns = {"plain": lambda: CK.ts_cov_reference(zs, v, s, jit, "matern52"),
               "library": lambda: torch.matmul(v.mT, v)}
        fns.update({k: (lambda mod=mod: mod.ts_cov(zs, v, s, jit, "matern52")) for k, mod in mods.items()})
        times = in_turns(fns, reps)
        dev = device_ms(fns["kernel"], reps)
        base_dev = device_ms(fns["baseline"], reps) if baseline is not None else None
        plan = CK.ts_cov_plan(batch, m, n, d, dtype=dtype)
        dims = {"batch": batch, "m": m, "n": n, "d": d, "splits": plan.splits, "chunk": plan.chunk,
                "dtype": str(dtype)[6:]}
        lines[label] = _line("ts_cov", label, dims, ts_cov_bound(batch, m, n, d, dtype), times, dev, base_dev, smi,
                             device_ms(fns["library"], reps))
        emit(lines[label])
    return lines


BENCH_N, BENCH_N_MAX = 2000, 2048  # bench.py's training set; the other sizes are config 3's


def bench_iteration(check: Callable[[bool, str], None]) -> Dict[str, float]:
    """bench.py's iteration at N = 2000 in a 2048 buffer, at the sizes of
    config 3 (``ts_q10``: its benchmark's dimension, 5000 candidates, q = 10,
    Thompson chunks of 1000): make_gp_state, gp_posterior over the
    candidates, EI, thompson_select, with the kernels (use_kernel=None) and
    with the plain versions (use_kernel=False); host clock around
    synchronized iterations, plain, kernel, kernel, plain, five iterations
    each. ``check(ok, what)`` is given the finiteness of each iteration's
    output."""
    from turbojax_torch import acq as A
    from turbojax_torch import benchmarks as B
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch import registry as R

    cfg = R.get_config("ts_q10")
    dim, n_cand, q, chunk = B.get_benchmark(cfg.benchmark).dim, cfg.bo.n_candidates, cfg.bo.batch_size, cfg.bo.ts_chunk
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, f32 = "cuda", torch.float32
    x = torch.rand((BENCH_N, dim), generator=gen, device=dev, dtype=f32)
    y = torch.sin(3 * x[:, 0]) + 0.1 * torch.randn(BENCH_N, generator=gen, device=dev, dtype=f32)
    cands = torch.rand((n_cand, dim), generator=gen, device=dev, dtype=f32)
    x_buf = torch.zeros((BENCH_N_MAX, dim), device=dev, dtype=f32)
    x_buf[:BENCH_N] = x
    y_buf = torch.zeros((BENCH_N_MAX,), device=dev, dtype=f32)
    y_buf[:BENCH_N] = y
    mask = L.row_mask(BENCH_N_MAX, BENCH_N, dev)
    raw = G.default_params(dim, cfg.gp, f32, dev)
    configs = {"kernel": cfg.gp, "plain": dataclasses.replace(cfg.gp, use_kernel=False)}

    def iteration(config):
        state = G.make_gp_state(x_buf, y_buf, mask, raw, config)
        mu, var = G.gp_posterior(state, cands, config)
        best = torch.where(mask, y_buf, torch.inf).min()
        ei = A.expected_improvement(mu, var, best)
        xs, vals = A.thompson_select(state, cands, q, config, chunk, gen)
        check(bool(torch.isfinite(ei).all() & torch.isfinite(xs).all()), "bench iteration: non-finite output")

    def timed(label, reps=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            iteration(configs[label])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    for label in ("plain", "kernel", "plain", "kernel"):
        iteration(configs[label])  # warm up both
    p1, k1, k2, p2 = timed("plain"), timed("kernel"), timed("kernel"), timed("plain")
    return {"kernel": 0.5 * (k1 + k2), "plain": 0.5 * (p1 + p2)}


CHOL_SIZES, CHOL_BATCHES, CHOL_DIM = (64, 512, 2048), (1, 2, 4, 8, 16), 10


def append_against_refactor(smi: str, reps: int = 20) -> List[Dict[str, object]]:
    """``bo._append_batch`` in both modes at N = 64, 512 and 2048 active
    points (d = 10, float32, Matérn-5/2, a buffer of N + 16 rows): q
    ``chol_append`` rows against one masked refactorization, ms per call by
    CUDA events over back-to-back calls, in turns. Both write the same
    buffers and build their kernel entries through the kernel wrapper. One
    line per (N, q), the factors' largest difference beside the times."""
    from turbojax_torch import bo as BO
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch.config import GPConfig

    config = GPConfig(kernel="matern52")
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(5)
    raw = G.default_params(CHOL_DIM, config, torch.float32, device)
    lines = []
    for n in CHOL_SIZES:
        n_max = n + max(CHOL_BATCHES)
        x_buf = torch.zeros((n_max, CHOL_DIM), device=device)
        x_buf[:n] = torch.rand((n, CHOL_DIM), generator=gen, device=device)
        y_buf = torch.zeros((n_max,), device=device)
        y_buf[:n] = torch.sin(3 * x_buf[:n, 0])
        state = G.make_gp_state(x_buf, y_buf, L.row_mask(n_max, n, device), raw, config)
        carry = BO.BOCarry(x_buf=x_buf, y_buf=y_buf, n=n, chol=state.chol, raw=raw, y_mean=state.y_mean,
                           y_std=state.y_std)
        for q in CHOL_BATCHES:
            x_new = torch.rand((q, CHOL_DIM), generator=gen, device=device)
            y_new = torch.sin(3 * x_new[:, 0])
            fns = {mode: (lambda mode=mode: BO._append_batch(carry, x_new, y_new, config, mode))
                   for mode in ("incremental", "refactor")}
            diff = float((fns["incremental"]().chol - fns["refactor"]().chol).abs().max())
            times = in_turns(fns, reps)
            lines.append({"n": n, "q": q, "d": CHOL_DIM, "append_ms": times["incremental"],
                          "refactor_ms": times["refactor"], "max_abs_diff": diff, "card": smi})
    return lines


def lbfgs_fit(smi: str) -> Dict[str, object]:
    """One L-BFGS fit at config 2's final size (``hartmann6_lbfgs``: 112
    points, d = 6, 4 restarts as one batch of lanes, float32): its batched
    loss evaluations (each one kernel-matrix launch and one batched Cholesky
    forward and backward), the iterations each lane took, the wall of a
    second, warm fit, and the device's busy time during a third."""
    from turbojax_torch import benchmarks as B
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch import registry as R

    cfg = R.get_config("hartmann6_lbfgs")
    bench = B.get_benchmark(cfg.benchmark)
    n = cfg.bo.max_evals
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.rand((n, bench.dim), generator=gen, device=device)
    y = bench.fn(x)
    mask = L.row_mask(n, n, device)
    uniforms = torch.rand((cfg.gp.fit_restarts - 1, bench.dim + 2), generator=gen, device=device)
    walls, stats = [], {}
    for _ in range(2):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = G.fit_gp(x, y, mask, cfg.gp, restart_uniforms=uniforms, stats=stats)
        finite = bool(torch.isfinite(state.chol).all())
        walls.append(time.perf_counter() - t0)
    if not finite:
        raise RuntimeError("the L-BFGS fit returned a non-finite factor")
    busy_ms = device_ms(lambda: G.fit_gp(x, y, mask, cfg.gp, restart_uniforms=uniforms), 1)
    return {"fit": "lbfgs", "lanes": cfg.gp.fit_restarts, "n": n, "d": bench.dim, "loss_evals": stats["loss_evals"],
            "iterations_per_lane": stats["steps"].tolist(), "wall_s_cold": walls[0], "wall_s": walls[1],
            "ms_per_loss_eval": 1e3 * walls[1] / stats["loss_evals"], "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / (1e3 * walls[1]), "card": smi}


def bitwise_against(baseline, smi: str, emit=print) -> bool:
    """This tree's float32 kernels against ``baseline``'s (another checkout's
    cuda_kernels, e.g. the parent commit's) on the same inputs, at every
    float32 shape above and for the four kernel functions: one line per
    shape, whether every output is equal bit for bit. Returns whether all
    were."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    all_equal = True

    def check(kind, label, run):
        nonlocal all_equal
        equal = all(torch.equal(run(CK, name), run(baseline, name)) for name in CK.KERNEL_IDS)
        all_equal &= equal
        emit({"bitwise": kind, "shape": label, "dtype": "float32", "equal": equal, "card": smi})

    for label, batch, n, m, d, same, _ in KM_SHAPES:
        z1, z2, s, nz = _inputs_km(gen, batch, n, m, d, same)
        check("kernel_matrix", label, lambda mod, name: mod.kernel_matrix(z1, z2, s, nz, name, True))
        del z1, z2
    for label, rows, n, d, off in KM_OFFSET_SHAPES:
        z, _, s, nz = _inputs_km(gen, 1, n, n, d, True)
        zr = z if rows == n else z[off:off + rows]
        check("kernel_matrix", label, lambda mod, name: mod.kernel_matrix(zr, z, s, nz, name, True, off))
        del z, zr
    for label, batch, m, n, d in TS_SHAPES:
        zs, v, s, _ = _inputs_ts(gen, batch, m, n, d)
        check("ts_cov", label, lambda mod, name: mod.ts_cov(zs, v, s, 1e-6, name))
    return all_equal


def load_baseline(tree: str):
    """Another checkout's ``turbojax_torch/cuda_kernels.py`` as a module of
    its own, its kernels built from that checkout's ``csrc/``."""
    path = os.path.join(os.path.abspath(tree), "turbojax_torch", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up while the class is made
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", default=None, help="a checkout whose kernels to time in turns with these")
    ap.add_argument("--chol", action="store_true", help="only the append-against-refactor table")
    ap.add_argument("--bitwise", action="store_true",
                    help="only the float32 outputs against --baseline's, bit for bit (exit 1 if any differs)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench measures the card: torch.cuda.is_available() is False")
    smi = card()
    CK.build()
    if args.bitwise:
        if not args.baseline:
            raise SystemExit("--bitwise needs --baseline DIR")
        equal = bitwise_against(load_baseline(args.baseline), smi, emit=lambda line: print(json.dumps(line), flush=True))
        return 0 if equal else 1
    if not args.chol:
        baseline = load_baseline(args.baseline) if args.baseline else None
        measure_kernels(smi, baseline, args.reps, emit=lambda line: print(json.dumps(line), flush=True))
        print(json.dumps({"bench_iteration_ms": bench_iteration(_check), "card": smi}), flush=True)
        print(json.dumps(lbfgs_fit(smi)), flush=True)
    for line in append_against_refactor(smi, args.reps):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
