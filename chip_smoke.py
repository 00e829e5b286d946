#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``turbojax_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the process exits
non-zero and the final line is not printed:

0. device check: the ``nvidia-smi`` name and power limit, torch/CUDA
   versions; fails without a CUDA device;
1. build both kernels, ``turbojax_torch/csrc/kernel_matrix.cu`` and
   ``csrc/ts_cov.cu``, for sm_90a (one ``nvcc`` each, started together);
2. each kernel against its plain PyTorch version on the card, for the four
   kernel functions, float32 and float64: the kernel matrix with and
   without noise at config 4's shapes plus ragged, d = 60 and clustered
   inputs; the TS covariance with jitter 0 and 1e-6 at config 5's chunks
   (5 × 1000 candidates, d = 60, n = 2048 and 512 training rows), ragged
   (m = 999, n = 1750), d = 10 and a trust region of side 0.5**7 at
   ℓ = 0.01, to 3e-5·outputscale in f32 (the TS ladder's first rung) and
   1e-12·outputscale in f64, each version's f32 error against the f64 plain
   version printed; the kernel-matrix gradients (kernel forward, plain
   backward) against plain autograd at (16, 2048, 60); then a small GP
   problem on the card (float64, through the kernels) against the same
   problem on the CPU (the plain versions);
3. timings with CUDA events: each kernel against plain at the main paths'
   shapes, and one ``bench.py``-style iteration (N = 2000 in a 2048 buffer,
   5000 candidates, EI, Thompson q = 10 in chunks of 1000) with the kernels
   and with the plain versions;
4. config 4 (``turbo1_ackley10``: TuRBO-1, Ackley-10D, 1000 evaluations,
   seed 0) end to end through ``turbojax_torch.optimize``;
5. config 5 (``turbom5_rover60``: TuRBO-m with m = 5, rover-60D, 2000
   evaluations, 5000 candidates per region, TS chunks of 1000, the
   grid+Adam trainer, seed 0) end to end through ``optimize``.

In phases 4 and 5 the launch counters are reset just before the run and
read just after; each fails unless both kernels were launched and the
result is finite and better than the initial design. Then one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
"""

import json
import math
import subprocess
import sys
import time

F32_RTOL, F32_ATOL = 2e-5, 2e-6  # as the JAX package's Pallas parity tests
F64_RTOL = 1e-12
TS_F32_ATOL = 3e-5  # × outputscale: acq._TS_EPS_RUNGS[0], the TS ladder's first diagonal bump
TS_F64_ATOL = 1e-12  # × outputscale
BENCH_N, BENCH_N_MAX, BENCH_D, BENCH_CAND, BENCH_Q, BENCH_CHUNK = 2000, 2048, 10, 5000, 10, 1000


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def phase0_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit({"phase": 0, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase1_build(CK):
    t0 = time.perf_counter()
    paths = CK.build()
    _emit({"phase": 1, "build_s": time.perf_counter() - t0,
           "libraries": {k: v.split("/build/")[-1] for k, v in paths.items()}})


def _cases(torch, gen):
    """(label, z1, z2, outputscale, noise) in float64 on the card; z1 is z2
    for K(Z, Z). Inputs are scaled by 1/ℓ and centered, as gp._kernel_matrix
    hands them to the kernel."""
    dev = "cuda"

    def unit(n, d):
        return torch.rand((n, d), generator=gen, device=dev, dtype=torch.float64)

    def centered(z1, z2=None):
        if z2 is None:
            return z1 - z1.mean(dim=-2, keepdim=True)
        c = 0.5 * (z1.mean(dim=-2, keepdim=True) + z2.mean(dim=-2, keepdim=True))
        return z1 - c, z2 - c

    one = torch.tensor(1.3, dtype=torch.float64, device=dev)
    nz = torch.tensor(1e-3, dtype=torch.float64, device=dev)
    out = []
    # the 15-row grid fit: ℓ ∈ {0.1, 0.25, 0.5, 1.0, 1.9} × noise ∈ {2e-4, 1e-3, 1e-2}
    x = unit(1000, 10)
    ls = torch.tensor([v for v in (0.1, 0.25, 0.5, 1.0, 1.9) for _ in range(3)], dtype=torch.float64, device=dev)
    z = centered(x[None] / ls[:, None, None])
    noise15 = torch.tensor([2e-4, 1e-3, 1e-2] * 5, dtype=torch.float64, device=dev)
    out.append(("grid_15x1000x1000_d10", z, z, torch.ones(15, dtype=torch.float64, device=dev), noise15))
    ell = math.sqrt(10 / 24)  # typical d² ≈ 4: kernel values neither 0 nor 1
    z1, z2 = centered(unit(1000, 10) / ell, unit(1000, 10) / ell)
    out.append(("cross_1000x1000_d10", z1, z2, one, nz))
    zc = centered(unit(1000, 10) / ell)
    out.append(("ts_chunk_1000x1000_d10", zc, zc, one, nz))
    xb = torch.cat([unit(BENCH_N, 10), torch.zeros(BENCH_N_MAX - BENCH_N, 10, dtype=torch.float64, device=dev)])
    z1, z2 = centered(xb / ell, unit(BENCH_CAND, 10) / ell)
    out.append(("bench_cross_2048x5000_d10", z1, z2, one, nz))
    z1, z2 = centered(xb / ell, unit(BENCH_CHUNK, 10) / ell)
    out.append(("bench_chunk_2048x1000_d10", z1, z2, one, nz))
    for n, m in ((1, 1), (130, 257), (999, 1000)):
        z1, z2 = centered(unit(n, 10) / ell, unit(m, 10) / ell)
        out.append((f"ragged_{n}x{m}_d10", z1, z2, one, nz))
    ell60 = math.sqrt(60 / 24)
    z1, z2 = centered(unit(1024, 60) / ell60, unit(1000, 60) / ell60)
    out.append(("d60_1024x1000", z1, z2, one, nz))
    # a trust region of side 0.5**7 around one point, at a small fitted ℓ
    c0 = unit(1, 10)
    x1 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    x2 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    z1, z2 = centered(x1 / 0.01, x2 / 0.01)
    out.append(("clustered_1000x1000_d10", z1, z2, one, nz))
    return out


def phase2_parity(torch, CK):
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    n_checked = 0
    for label, z1, z2, os_, noise in _cases(torch, gen):
        same = z2 is z1
        for dtype in (torch.float32, torch.float64):
            a = z1.to(dtype).contiguous()
            b = a if same else z2.to(dtype).contiguous()
            s, nz = os_.to(dtype), noise.to(dtype)
            for name in CK.KERNEL_IDS:
                for add_noise in (False, True):
                    got = CK.kernel_matrix(a, b, s, nz, name, add_noise)
                    torch.cuda.synchronize()
                    ref = CK.kernel_matrix_reference(a, b, s, nz, name, add_noise)
                    err = (got - ref).abs()
                    if dtype == torch.float32:
                        bad = err > F32_ATOL + F32_RTOL * ref.abs()
                    else:
                        bad = err > F64_RTOL * ref.abs()
                    _require(bool(torch.isfinite(got).all()), f"{label} {dtype} {name}: non-finite output")
                    _require(not bool(bad.any()), (
                        f"{label} {dtype} {name} noise={add_noise}: {int(bad.sum())} entries out of "
                        f"tolerance, max abs err {float(err.max()):.3e}"))
                    worst[dtype] = max(worst[dtype], float(err.max()))
                    n_checked += 1
        _emit({"phase": 2, "case": label, "shape": [list(z1.shape), list(z2.shape)], "ok": True})
    _emit({"phase": 2, "kernel": "kernel_matrix", "comparisons": n_checked, "max_abs_err_f32": worst[torch.float32],
           "max_abs_err_f64": worst[torch.float64], "tolerance_f32": [F32_RTOL, F32_ATOL],
           "tolerance_f64_rtol": F64_RTOL})
    ts_worst = _ts_cov_parity(torch, CK)
    grad_err = _kernel_matrix_grad_parity(torch, CK)
    e2e = _small_gp_agreement(torch)
    _emit({"phase": 2, "kernel_matrix_grad_max_rel_err": grad_err, "small_gp_cuda_vs_cpu": e2e})
    return worst[torch.float32], ts_worst


def _ts_cases(torch, gen):
    """(label, zs (B, m, d), v (B, n, m), outputscale (B,)) in float64 on the
    card: candidates scaled by 1/ℓ and centered as gp._scale_center hands
    them over, and v = L⁻¹K(X, zs) from a training set of n rows (noise
    1e-2), so that vᵀv cancels most of k(zs, zs) as it does in the TS."""
    from turbojax_torch import cuda_kernels as CK

    dev, f64 = "cuda", torch.float64

    def chunk(m, n, d, ell, cluster=None):
        x = torch.rand((n, d), generator=gen, device=dev, dtype=f64)
        xs = torch.rand((m, d), generator=gen, device=dev, dtype=f64)
        if cluster is not None:
            c0 = torch.rand((1, d), generator=gen, device=dev, dtype=f64)
            x, xs = c0 + cluster * (x - 0.5), c0 + cluster * (xs - 0.5)
        zx, zs = x / ell, xs / ell
        c = 0.5 * (zx.mean(0) + zs.mean(0))
        zx, zs = zx - c, zs - c
        s = torch.tensor(1.3, dtype=f64, device=dev)
        k_xx = CK.kernel_matrix_reference(zx, zx, s, torch.tensor(1e-2, dtype=f64, device=dev), "matern52", True)
        k_xs = CK.kernel_matrix_reference(zx, zs, s, 0.0, "matern52", False)
        v = torch.linalg.solve_triangular(torch.linalg.cholesky(k_xx), k_xs, upper=False)
        return zs, v

    def batch(label, parts, scales):
        zs = torch.stack([p[0] for p in parts])
        v = torch.stack([p[1] for p in parts])
        return label, zs.contiguous(), v.contiguous(), torch.tensor(scales, dtype=f64, device=dev)

    ell60 = math.sqrt(60 / 24)
    scales5 = [1.3, 0.7, 2.0, 1.0, 0.3]
    return [
        batch("tr5_chunk_5x1000_n2048_d60", [chunk(1000, 2048, 60, ell60) for _ in range(5)], scales5),
        batch("tr5_chunk_5x1000_n512_d60", [chunk(1000, 512, 60, ell60) for _ in range(5)], scales5),
        batch("ragged_999_n1750_d60", [chunk(999, 1750, 60, ell60)], [1.3]),
        batch("d10_1000_n1000", [chunk(1000, 1000, 10, math.sqrt(10 / 24))], [1.3]),
        batch("clustered_1000_n1000_d60", [chunk(1000, 1000, 60, 0.01, cluster=0.5**7)], [1.3]),
    ]


def _ts_cov_parity(torch, CK):
    """The TS covariance kernel against its plain version on the same inputs.
    Returns the largest float32 absolute error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    worst_abs = 0.0
    n_checked = 0
    for label, zs64, v64, s64 in _ts_cases(torch, gen):
        scale = s64[:, None, None]
        versus_f64 = {"kernel": 0.0, "plain": 0.0}
        for dtype in (torch.float32, torch.float64):
            zs, v, s = zs64.to(dtype), v64.to(dtype), s64.to(dtype)
            tol = TS_F32_ATOL if dtype == torch.float32 else TS_F64_ATOL
            for name in CK.KERNEL_IDS:
                for jitter in (0.0, 1e-6):
                    got = CK.ts_cov(zs, v, s, jitter, name)
                    torch.cuda.synchronize()
                    ref = CK.ts_cov_reference(zs, v, s, jitter, name)
                    err = float(((got - ref).abs() / scale).max())
                    _require(bool(torch.isfinite(got).all()), f"ts_cov {label} {dtype} {name}: non-finite output")
                    _require(err <= tol, f"ts_cov {label} {dtype} {name} jitter={jitter}: max err "
                                         f"{err:.3e}·outputscale > {tol:.0e}")
                    worst[dtype] = max(worst[dtype], err)
                    n_checked += 1
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs, float((got - ref).abs().max()))
                        exact = CK.ts_cov_reference(zs.double(), v.double(), s.double(), jitter, name)
                        versus_f64["kernel"] = max(versus_f64["kernel"], float(((got.double() - exact).abs() / scale).max()))
                        versus_f64["plain"] = max(versus_f64["plain"], float(((ref.double() - exact).abs() / scale).max()))
        _emit({"phase": 2, "kernel": "ts_cov", "case": label, "zs": list(zs64.shape), "v": list(v64.shape),
               "ok": True, "f32_err_vs_f64_plain_per_outputscale": versus_f64})
    _emit({"phase": 2, "kernel": "ts_cov", "comparisons": n_checked,
           "max_err_f32_per_outputscale": worst[torch.float32], "max_err_f64_per_outputscale": worst[torch.float64],
           "max_abs_err_f32": worst_abs, "tolerance_f32": TS_F32_ATOL, "tolerance_f64": TS_F64_ATOL})
    return worst_abs


def _kernel_matrix_grad_parity(torch, CK):
    """KernelMatrix (kernel forward, plain backward) against plain autograd
    at the polish's shape, (16, 2048, 60) in float32. Returns the largest
    gradient error relative to the gradient's largest entry."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    z0 = torch.rand((16, 2048, 60), generator=gen, device="cuda") / math.sqrt(60 / 24)
    z0 = z0 - z0.mean(dim=-2, keepdim=True)
    upstream = torch.randn((16, 2048, 2048), generator=gen, device="cuda")
    worst = 0.0
    for name in CK.KERNEL_IDS:
        grads = []
        for fn in (CK.kernel_matrix, CK.kernel_matrix_reference):
            z = z0.clone().requires_grad_(True)
            s = torch.full((16,), 1.3, device="cuda", requires_grad=True)
            nz = torch.full((16,), 1e-2, device="cuda", requires_grad=True)
            k = fn(z, z, s, nz, name, True)
            grads.append(torch.autograd.grad((k * upstream).sum(), (z, s, nz)))
        for g_kernel, g_plain in zip(*grads):
            err = float((g_kernel - g_plain).abs().max() / g_plain.abs().max().clamp_min(1e-30))
            _require(err <= 1e-5, f"KernelMatrix gradient ({name}) differs from plain autograd: {err:.3e}")
            worst = max(worst, err)
    return worst


def _small_gp_agreement(torch):
    """A small GP problem in float64: the grid fit, the cached factor and the
    posterior on the card (through the kernel) against the CPU (the plain
    version). Returns the largest relative differences."""
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch.config import GPConfig

    config = GPConfig(kernel="matern52", fit_optimizer="grid")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((64, 10), generator=g, dtype=torch.float64)
    x[50:] = 0.0
    y = torch.sin(3 * x[:, 0]) + 0.1 * torch.randn(64, generator=g, dtype=torch.float64)
    y[50:] = 0.0
    xs = torch.rand((128, 10), generator=g, dtype=torch.float64)
    res = {}
    for dev in ("cpu", "cuda"):
        mask = L.row_mask(64, 50, dev)
        state = G.fit_gp(x.to(dev), y.to(dev), mask, config)
        mu, var = G.gp_posterior(state, xs.to(dev), config)
        res[dev] = [t.cpu() for t in (state.params["lengthscale"], state.chol, state.alpha, mu, var)]
    diffs = {}
    for key, a, b in zip(("lengthscale", "chol", "alpha", "mu", "var"), res["cpu"], res["cuda"]):
        rel = float(((a - b).abs() / (b.abs() + 1e-300)).max()) if key != "chol" else float((a - b).abs().max())
        diffs[key] = rel
        _require(torch.allclose(a, b, rtol=1e-9, atol=1e-12), f"small GP {key}: CUDA and CPU disagree ({rel:.3e})")
    return diffs


def _event_ms(torch, fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _paired(torch, plain, kernel, reps: int, warmup: int = 3):
    """Plain, kernel, kernel, plain; returns (kernel ms, plain ms), each the
    mean of its two windows."""
    for _ in range(warmup):
        plain()
        kernel()
    torch.cuda.synchronize()
    p1 = _event_ms(torch, plain, reps)
    k1 = _event_ms(torch, kernel, reps)
    k2 = _event_ms(torch, kernel, reps)
    p2 = _event_ms(torch, plain, reps)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def phase3_timings(torch, CK, smi):
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32 = torch.float32

    def unit(*shape):
        return torch.rand(shape, generator=gen, device="cuda", dtype=f32)

    shapes = {
        "grid_15x1000x1000_d10_noise": (unit(15, 1000, 10), None, torch.ones(15, device="cuda"), True),
        "kxx_1000x1000_d10_noise": (unit(1000, 10), None, torch.tensor(1.0, device="cuda"), True),
        "cross_1000x1000_d10": (unit(1000, 10), unit(1000, 10), torch.tensor(1.0, device="cuda"), False),
        "bench_kxx_2048x2048_d10_noise": (unit(2048, 10), None, torch.tensor(1.0, device="cuda"), True),
        "bench_cross_2048x5000_d10": (unit(2048, 10), unit(5000, 10), torch.tensor(1.0, device="cuda"), False),
        "bench_chunk_2048x1000_d10": (unit(2048, 10), unit(1000, 10), torch.tensor(1.0, device="cuda"), False),
    }
    kernel_times = {}
    for label, (z1, z2, os_, add_noise) in shapes.items():
        z2 = z1 if z2 is None else z2
        noise = torch.full_like(os_, 1e-3)
        k_ms, p_ms = _paired(
            torch,
            lambda: CK.kernel_matrix_reference(z1, z2, os_, noise, "matern52", add_noise),
            lambda: CK.kernel_matrix(z1, z2, os_, noise, "matern52", add_noise),
            reps=20,
        )
        kernel_times[label] = (k_ms, p_ms)
        _emit({"phase": 3, "shape": label, "kernel_ms": k_ms, "plain_ms": p_ms, "card": smi})

    ts_times = _ts_cov_timings(torch, CK, smi)
    it_ms = _bench_iteration(torch)
    _emit({"phase": 3, "bench_iteration_ms": it_ms, "card": smi})
    return kernel_times, ts_times


def _ts_cov_timings(torch, CK, smi):
    """ts_cov against its plain version (kernel-matrix kernel + v.mT @ v +
    jitter·I in cuBLAS fp32) at config 5's shapes: one region's five chunks
    at the full capacity (n = 2048), the four small regions' twenty chunks
    at the 512 rung, and the single chunk the path calls (n = 2000)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {
        "tr_chunks_5x1000_n2048_d60": (5, 1000, 2048, 60),
        "cap512_group_20x1000_n512_d60": (20, 1000, 512, 60),
        "path_chunk_1x1000_n2000_d60": (1, 1000, 2000, 60),
    }
    times = {}
    for label, (b, m, n, d) in shapes.items():
        zs = torch.rand((b, m, d), generator=gen, device="cuda") / math.sqrt(d / 24)
        zs = (zs - zs.mean(dim=-2, keepdim=True)).contiguous()
        v = torch.randn((b, n, m), generator=gen, device="cuda") / math.sqrt(n)
        s = torch.ones(b, device="cuda")
        k_ms, p_ms = _paired(
            torch,
            lambda: CK.ts_cov_reference(zs, v, s, 1e-6, "matern52"),
            lambda: CK.ts_cov(zs, v, s, 1e-6, "matern52"),
            reps=10,
        )
        gflop = 2.0 * b * m * m * (n + d) / 1e9
        times[label] = (k_ms, p_ms)
        _emit({"phase": 3, "kernel": "ts_cov", "shape": label, "kernel_ms": k_ms, "plain_ms": p_ms,
               "kernel_tflops": gflop / k_ms, "plain_tflops": gflop / p_ms, "card": smi})
    return times


def _bench_iteration(torch):
    """bench.py's iteration at N = 2000 in a 2048 buffer: make_gp_state,
    gp_posterior over 5000 candidates, EI, thompson_select q = 10 in chunks
    of 1000, with the kernel (use_kernel=None) and with the plain version
    (use_kernel=False); host clock around a synchronized iteration."""
    import dataclasses

    from turbojax_torch import acq as A
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch.config import GPConfig

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev, f32 = "cuda", torch.float32
    x = torch.rand((BENCH_N, BENCH_D), generator=gen, device=dev, dtype=f32)
    y = torch.sin(3 * x[:, 0]) + 0.1 * torch.randn(BENCH_N, generator=gen, device=dev, dtype=f32)
    cands = torch.rand((BENCH_CAND, BENCH_D), generator=gen, device=dev, dtype=f32)
    x_buf = torch.zeros((BENCH_N_MAX, BENCH_D), device=dev, dtype=f32)
    x_buf[:BENCH_N] = x
    y_buf = torch.zeros((BENCH_N_MAX,), device=dev, dtype=f32)
    y_buf[:BENCH_N] = y
    mask = L.row_mask(BENCH_N_MAX, BENCH_N, dev)
    base = GPConfig(kernel="matern52")
    raw = G.default_params(BENCH_D, base, f32, dev)
    configs = {"kernel": base, "plain": dataclasses.replace(base, use_kernel=False)}

    def iteration(config):
        state = G.make_gp_state(x_buf, y_buf, mask, raw, config)
        mu, var = G.gp_posterior(state, cands, config)
        best = torch.where(mask, y_buf, torch.inf).min()
        ei = A.expected_improvement(mu, var, best)
        xs, vals = A.thompson_select(state, cands, BENCH_Q, config, BENCH_CHUNK, gen)
        _require(bool(torch.isfinite(ei).all() & torch.isfinite(xs).all()), "bench iteration: non-finite output")

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


def phase4_config4(torch, CK, smi):
    from turbojax_torch import benchmarks as B
    from turbojax_torch import optimize
    from turbojax_torch import registry as R

    cfg = R.get_config("turbo1_ackley10")
    bench = B.get_benchmark(cfg.benchmark)
    t = cfg.turbo
    res, wall, launches = _drive(torch, CK, lambda: optimize(
        bench.fn, bench.lb, bench.ub, t.max_evals, method=cfg.method, n_init=t.n_init,
        batch_size=t.batch_size, n_candidates=t.n_candidates, gp_config=cfg.gp, seed=0,
        device="cuda",
    ))
    init_best = _check_run(cfg.name, res, launches, t.n_init // t.batch_size - 1)
    _emit({"phase": 4, "config": cfg.name, "evals": t.max_evals, "wall_s": wall, "best_y": res.best_y,
           "regret": res.best_y - bench.optimum, "init_design_best": init_best, "launches": launches,
           "iterations": len(res.incumbent_trace), "card": smi})
    return launches


def _drive(torch, CK, run):
    """Run one path with both launch counters set to 0 just before and read
    just after; returns (result, wall seconds, {kernel: launches})."""
    torch.cuda.synchronize()
    CK.LAUNCHES = 0
    CK.TS_COV_LAUNCHES = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {"kernel_matrix": CK.LAUNCHES, "ts_cov": CK.TS_COV_LAUNCHES}


def _check_run(name, res, launches, init_index):
    """Fails unless both kernels were launched, the history is finite and
    the best value beats the initial design's; returns the latter."""
    init_best = float(res.incumbent_trace[init_index])
    for kernel, n in launches.items():
        _require(n > 0, f"{name} ran without launching the {kernel} kernel")
    _require(bool(len(res.y_hist) > 0 and all(map(math.isfinite, res.y_hist.tolist()))), f"{name}: non-finite history")
    _require(math.isfinite(res.best_y), f"{name}: non-finite best_y")
    _require(res.best_y < init_best, f"{name}: best_y {res.best_y} does not improve on the initial design {init_best}")
    return init_best


def phase5_config5(torch, CK, smi):
    from turbojax_torch import benchmarks as B
    from turbojax_torch import optimize
    from turbojax_torch import registry as R

    cfg = R.get_config("turbom5_rover60")
    bench = B.get_benchmark(cfg.benchmark)
    t = cfg.turbo
    res, wall, launches = _drive(torch, CK, lambda: optimize(
        bench.fn, bench.lb, bench.ub, t.max_evals, method=cfg.method, m=cfg.m, n_init=t.n_init,
        batch_size=t.batch_size, n_candidates=t.n_candidates, ts_chunk=t.ts_chunk, gp_config=cfg.gp,
        seed=0, device="cuda",
    ))
    # the m init designs fill the first m·n_init/q batches
    init_best = _check_run(cfg.name, res, launches, cfg.m * t.n_init // t.batch_size - 1)
    _emit({"phase": 5, "config": cfg.name, "m": cfg.m, "evals": len(res.y_hist), "wall_s": wall,
           "best_y": res.best_y, "regret": res.best_y - bench.optimum, "init_design_best": init_best,
           "launches": launches, "iterations": len(res.incumbent_trace), "card": smi})
    return launches


def main() -> int:
    import torch

    smi = phase0_device(torch)
    from turbojax_torch import cuda_kernels as CK

    phase1_build(CK)
    max_err, ts_err = phase2_parity(torch, CK)
    kernel_times, ts_times = phase3_timings(torch, CK, smi)
    launches4 = phase4_config4(torch, CK, smi)
    launches5 = phase5_config5(torch, CK, smi)
    k_ms, p_ms = kernel_times["grid_15x1000x1000_d10_noise"]
    ts_ms, ts_plain_ms = ts_times["tr_chunks_5x1000_n2048_d60"]
    by_path = {name: {"turbo1_ackley10": launches4[name], "turbom5_rover60": launches5[name]}
               for name in launches5}
    _emit({"kernels": [
        {"name": "kernel_matrix", "route": "cuda", "source": "turbojax_torch/csrc/kernel_matrix.cu",
         "replaces": "turbojax/pallas_kernels.py:72", "launches": launches5["kernel_matrix"],
         "launches_by_path": by_path["kernel_matrix"], "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "ts_cov", "route": "cuda", "source": "turbojax_torch/csrc/ts_cov.cu",
         "replaces": "turbojax/pallas_kernels.py:194", "launches": launches5["ts_cov"],
         "launches_by_path": by_path["ts_cov"], "max_abs_err": ts_err, "ms": ts_ms, "plain_ms": ts_plain_ms},
    ]})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
