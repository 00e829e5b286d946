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
   without noise at config 4's shapes, config 5's grid batches (16 × 2000²
   and the 64-row batch at the 512 rung), K(Z, Z) at
   m = 1, 63, 65 and 999 (ragged tiles of the symmetric schedule), ragged
   cross matrices, d = 60 and clustered inputs; the TS covariance with
   jitter 0 and 1e-6 at the chunks the paths launch (one 1000-candidate
   chunk, d = 60 with n = 2000 and 512, d = 10 with n = 1000 and 2048: n
   split in four, the last split shorter), config 5's five-chunk batches,
   m = 1, 63, 65 and 999, n = 1 and n = 1750, and a trust region of side
   0.5**7 at ℓ = 0.01; and plain BO's shapes: K(Z, Z) at 60 points, d = 2
   (config 1) and four lanes of 112 points, d = 6 (config 2's L-BFGS
   restarts), their posterior cross matrices against 2000 candidates and the
   one-row cross of an append. Tolerances: the kernel matrix rtol 2e-5 / atol 2e-6
   in f32 and rtol 1e-12 in f64, the TS covariance 3e-5·outputscale in f32
   (the TS ladder's first rung) and 1e-12·outputscale in f64. For each case
   the kernel's and the plain version's f32 errors against the f64 plain
   version are printed, and the kernel's may be no larger; K(Z, Z) and
   every TS covariance must be bitwise
   symmetric, two calls bitwise equal, and in f32 the diagonal exact
   (K(Z, Z)'s is outputscale + noise; ts_cov's kernel term, with v = 0, is
   outputscale). Then the kernel-matrix gradients (kernel forward, plain
   backward) against plain autograd at (16, 2048, 60) and (4, 112, 6), and a small GP
   problem on the card (float64, through the kernels) against the same
   problem on the CPU (the plain versions);
3. ``turbojax_torch.kernel_bench``: both kernels at the shapes the paths
   launch, each against its plain version (CUDA events) with its device
   time (torch.profiler), its bound and share and, for ts_cov, the time of
   ``v.mT @ v`` alone; then one ``bench.py``-style iteration (N = 2000 in a
   2048 buffer, 5000 candidates, EI, Thompson q = 10 in chunks of 1000)
   with the kernels and with the plain versions; ``bo._append_batch``'s
   appends against one refactorization at N = 64, 512 and 2048, and one
   L-BFGS fit at (4, 112, 6) with its loss evaluations and wall;
4. config 4 (``turbo1_ackley10``: TuRBO-1, Ackley-10D, 1000 evaluations,
   seed 0) end to end through ``turbojax_torch.optimize``;
5. config 5 (``turbom5_rover60``: TuRBO-m with m = 5, rover-60D, 2000
   evaluations, 5000 candidates per region, TS chunks of 1000, the
   grid+Adam trainer, seed 0) end to end through ``optimize``;
6. plain BO through ``run_bo``: config 1 (``branin_ei``: 60 evaluations,
   fixed hypers, EI) with the incremental Cholesky and again with
   refactorizations, and config 2 (``hartmann6_lbfgs``: 112 evaluations,
   four L-BFGS restarts per iteration), seed 0;
7. config 3 (``ts_q10``: one Thompson suggestion of q = 10 from 5000
   candidates in chunks of 1000 over 2000 training points), and the
   ask/tell ``Optimizer`` with the objective evaluated on the host in
   numpy: TuRBO-1 at config 4's sizes (Ackley-10D, 1000 evaluations,
   q = 10), a short plain-BO run (Branin, EI, L-BFGS refits) and a short
   TuRBO-m run (m = 2, rover-60D).

In phases 4 to 7 the launch counters are set to 0 just before each run and
read just after; a run fails unless the kernels of its path were launched
(the kernel matrix on every path; the TS covariance wherever Thompson
sampling runs: configs 3, 4 and 5 and the TuRBO ask/tell runs) and the
result is finite, its incumbent trace non-increasing, and its best value
better than the initial design's. Then one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": ...}``.
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

    def rows(vals):
        return torch.tensor(vals, dtype=torch.float64, device=dev)

    one = torch.tensor(1.3, dtype=torch.float64, device=dev)
    nz = torch.tensor(1e-3, dtype=torch.float64, device=dev)
    out = []
    # the 15-row grid fit: ℓ ∈ {0.1, 0.25, 0.5, 1.0, 1.9} × noise ∈ {2e-4, 1e-3, 1e-2}
    x = unit(1000, 10)
    ls = rows([v for v in (0.1, 0.25, 0.5, 1.0, 1.9) for _ in range(3)])
    z = centered(x[None] / ls[:, None, None])
    out.append(("grid_15x1000x1000_d10", z, z, torch.ones(15, dtype=torch.float64, device=dev),
                rows([2e-4, 1e-3, 1e-2] * 5)))
    ell = math.sqrt(10 / 24)  # typical d² ≈ 4: kernel values neither 0 nor 1
    ell60 = math.sqrt(60 / 24)
    # config 5's grid batches: 16 rows at the 2000 rung, 4 regions × 16 rows at the 512 rung
    z = centered(unit(2000, 60)[None] / (ell60 * rows([0.5, 0.8, 1.0, 1.6] * 4)[:, None, None]))
    out.append(("grid_16x2000x2000_d60", z, z, rows([1.3, 0.7] * 8), rows([1e-2, 1e-3] * 8)))
    z = centered(torch.rand((64, 512, 60), generator=gen, device=dev, dtype=torch.float64) / ell60)
    out.append(("grid_64x512x512_d60", z, z, rows([1.3, 0.7, 2.0, 1.0] * 16), rows([1e-2, 1e-3] * 32)))
    for m in (1, 63, 65, 999):
        zc = centered(unit(m, 60) / ell60)
        out.append((f"kzz_{m}_d60", zc, zc, one, nz))
    z1, z2 = centered(unit(1000, 10) / ell, unit(1000, 10) / ell)
    out.append(("cross_1000x1000_d10", z1, z2, one, nz))
    zc = centered(unit(1000, 10) / ell)
    out.append(("kxx_1000_d10", zc, zc, one, nz))
    xb = torch.cat([unit(2000, 10), torch.zeros(48, 10, dtype=torch.float64, device=dev)])
    z1, z2 = centered(xb / ell, unit(5000, 10) / ell)
    out.append(("bench_cross_2048x5000_d10", z1, z2, one, nz))
    for n, m in ((1, 1), (130, 257), (999, 1000)):
        z1, z2 = centered(unit(n, 10) / ell, unit(m, 10) / ell)
        out.append((f"ragged_{n}x{m}_d10", z1, z2, one, nz))
    z1, z2 = centered(unit(2000, 60) / ell60, unit(1000, 60) / ell60)
    out.append(("ts_cross_2000x1000_d60", z1, z2, one, nz))
    # plain BO: config 1 (60 points, d = 2) and config 2 (112 points, d = 6, four L-BFGS lanes)
    for tag, n, d, lanes in (("bo1", 60, 2, 1), ("bo2", 112, 6, 4)):
        ell_d = math.sqrt(d / 24)
        if lanes == 1:
            zc = centered(unit(n, d) / ell_d)
            out.append((f"{tag}_kzz_{n}_d{d}", zc, zc, one, nz))
        else:
            zc = centered(unit(n, d)[None] / (ell_d * rows([0.5, 0.8, 1.0, 1.6])[:, None, None]))
            out.append((f"{tag}_lanes{lanes}_kzz_{n}_d{d}", zc, zc, rows([1.3, 0.7, 2.0, 1.0]), rows([1e-2, 1e-3, 1e-4, 0.1])))
        z1, z2 = centered(unit(n, d) / ell_d, unit(2000, d) / ell_d)
        out.append((f"{tag}_cross_{n}x2000_d{d}", z1, z2, one, nz))
        z1, z2 = centered(unit(1, d) / ell_d, unit(n, d) / ell_d)
        out.append((f"{tag}_append_1x{n}_d{d}", z1, z2, one, nz))
    # a trust region of side 0.5**7 around one point, at a small fitted ℓ
    c0 = unit(1, 10)
    x1 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    x2 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    z1, z2 = centered(x1 / 0.01, x2 / 0.01)
    out.append(("clustered_1000x1000_d10", z1, z2, one, nz))
    return out


def _exact_diagonal(torch, got, s, noise, add_noise, label):
    """The f32 diagonal of K(Z, Z) is outputscale (+ noise) exactly: d² = 0
    there, and k(0) rounds to 1 in every kernel function."""
    batch = got.shape[0] if got.dim() == 3 else 1
    want = s.reshape(-1, 1).expand(batch, 1)
    if add_noise:
        want = want + noise.reshape(-1, 1).expand(batch, 1)
    diag = got.diagonal(dim1=-2, dim2=-1).reshape(batch, -1)
    _require(bool((diag == want).all()), f"{label}: the diagonal is not outputscale + noise exactly")


def phase2_parity(torch, CK):
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    n_checked = 0
    for label, z1, z2, os_, noise in _cases(torch, gen):
        same = z2 is z1
        versus_f64 = {"kernel": 0.0, "plain": 0.0}
        for dtype in (torch.float32, torch.float64):
            a = z1.to(dtype).contiguous()
            b = a if same else z2.to(dtype).contiguous()
            s, nz = os_.to(dtype), noise.to(dtype)
            for name in CK.KERNEL_IDS:
                for add_noise in (False, True):
                    what = f"{label} {dtype} {name} noise={add_noise}"
                    got = CK.kernel_matrix(a, b, s, nz, name, add_noise)
                    again = CK.kernel_matrix(a, b, s, nz, name, add_noise)
                    torch.cuda.synchronize()
                    ref = CK.kernel_matrix_reference(a, b, s, nz, name, add_noise)
                    err = (got - ref).abs()
                    if dtype == torch.float32:
                        bad = err > F32_ATOL + F32_RTOL * ref.abs()
                    else:
                        bad = err > F64_RTOL * ref.abs()
                    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
                    _require(not bool(bad.any()), f"{what}: {int(bad.sum())} entries out of tolerance, "
                                                  f"max abs err {float(err.max()):.3e}")
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    if same:
                        _require(torch.equal(got, got.mT), f"{what}: K(Z, Z) is not bitwise symmetric")
                        if dtype == torch.float32:
                            _exact_diagonal(torch, got, s, nz, add_noise, what)
                    worst[dtype] = max(worst[dtype], float(err.max()))
                    n_checked += 1
                    if dtype == torch.float32:
                        a64 = a.double()
                        exact = CK.kernel_matrix_reference(a64, a64 if same else b.double(), s.double(), nz.double(),
                                                           name, add_noise)
                        versus_f64["kernel"] = max(versus_f64["kernel"], float((got.double() - exact).abs().max()))
                        versus_f64["plain"] = max(versus_f64["plain"], float((ref.double() - exact).abs().max()))
                        del exact
        _require(versus_f64["kernel"] <= versus_f64["plain"], f"kernel_matrix {label}: f32 error against the f64 "
                 f"plain version {versus_f64['kernel']:.3e} above the plain f32 version's {versus_f64['plain']:.3e}")
        _emit({"phase": 2, "kernel": "kernel_matrix", "case": label, "shape": [list(z1.shape), list(z2.shape)],
               "ok": True, "f32_err_vs_f64_plain": versus_f64})
    _emit({"phase": 2, "kernel": "kernel_matrix", "comparisons": n_checked,
           "max_abs_err_f32": worst[torch.float32], "max_abs_err_f64": worst[torch.float64],
           "tolerance_f32": [F32_RTOL, F32_ATOL], "tolerance_f64_rtol": F64_RTOL})
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

    ell10, ell60 = math.sqrt(10 / 24), math.sqrt(60 / 24)
    scales5 = [1.3, 0.7, 2.0, 1.0, 0.3]
    return [
        batch("path_1000_n2000_d60", [chunk(1000, 2000, 60, ell60)], [1.3]),
        batch("path_1000_n512_d60", [chunk(1000, 512, 60, ell60)], [0.7]),
        batch("path_1000_n1000_d10", [chunk(1000, 1000, 10, ell10)], [1.3]),
        batch("bench_1000_n2048_d10", [chunk(1000, 2048, 10, ell10)], [1.3]),
        batch("tr5_chunk_5x1000_n2048_d60", [chunk(1000, 2048, 60, ell60) for _ in range(5)], scales5),
        batch("tr5_chunk_5x1000_n512_d60", [chunk(1000, 512, 60, ell60) for _ in range(5)], scales5),
        batch("m1_n600_d60", [chunk(1, 600, 60, ell60)], [1.3]),
        batch("m63_n300_d60", [chunk(63, 300, 60, ell60)], [1.3]),
        batch("m65_n700_d60", [chunk(65, 700, 60, ell60)], [1.3]),
        batch("m999_n1750_d60", [chunk(999, 1750, 60, ell60)], [1.3]),
        batch("m1000_n1_d10", [chunk(1000, 1, 10, ell10)], [1.3]),
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
        plan = CK.ts_cov_plan(*zs64.shape[:2], v64.shape[1], zs64.shape[2])
        for dtype in (torch.float32, torch.float64):
            zs, v, s = zs64.to(dtype), v64.to(dtype), s64.to(dtype)
            tol = TS_F32_ATOL if dtype == torch.float32 else TS_F64_ATOL
            for name in CK.KERNEL_IDS:
                for jitter in (0.0, 1e-6):
                    what = f"ts_cov {label} {dtype} {name} jitter={jitter}"
                    got = CK.ts_cov(zs, v, s, jitter, name)
                    again = CK.ts_cov(zs, v, s, jitter, name)
                    torch.cuda.synchronize()
                    ref = CK.ts_cov_reference(zs, v, s, jitter, name)
                    err = float(((got - ref).abs() / scale).max())
                    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
                    _require(err <= tol, f"{what}: max err {err:.3e}·outputscale > {tol:.0e}")
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    _require(torch.equal(got, got.mT), f"{what}: not bitwise symmetric")
                    worst[dtype] = max(worst[dtype], err)
                    n_checked += 1
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs, float((got - ref).abs().max()))
                        exact = CK.ts_cov_reference(zs.double(), v.double(), s.double(), jitter, name)
                        versus_f64["kernel"] = max(versus_f64["kernel"], float(((got.double() - exact).abs() / scale).max()))
                        versus_f64["plain"] = max(versus_f64["plain"], float(((ref.double() - exact).abs() / scale).max()))
            if dtype == torch.float32:  # the kernel term alone: its diagonal is outputscale exactly
                for name in CK.KERNEL_IDS:
                    got = CK.ts_cov(zs, torch.zeros_like(v), s, 0.0, name)
                    _exact_diagonal(torch, got, s, None, False, f"ts_cov {label} {name} kernel term")
        _require(versus_f64["kernel"] <= versus_f64["plain"], f"ts_cov {label}: f32 error against the f64 plain "
                 f"version {versus_f64['kernel']:.3e} above the plain f32 version's {versus_f64['plain']:.3e}")
        _emit({"phase": 2, "kernel": "ts_cov", "case": label, "zs": list(zs64.shape), "v": list(v64.shape),
               "splits": plan.splits, "chunk": plan.chunk, "ok": True,
               "f32_err_vs_f64_plain_per_outputscale": versus_f64})
    _emit({"phase": 2, "kernel": "ts_cov", "comparisons": n_checked,
           "max_err_f32_per_outputscale": worst[torch.float32], "max_err_f64_per_outputscale": worst[torch.float64],
           "max_abs_err_f32": worst_abs, "tolerance_f32": TS_F32_ATOL, "tolerance_f64": TS_F64_ATOL})
    return worst_abs


def _kernel_matrix_grad_parity(torch, CK):
    """KernelMatrix (kernel forward, plain backward) against plain autograd
    at the polish's shape, (16, 2048, 60), and at config 2's L-BFGS lanes,
    (4, 112, 6), in float32. Returns the largest gradient error relative to
    the gradient's largest entry."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for lanes, n, d in ((16, 2048, 60), (4, 112, 6)):
        z0 = torch.rand((lanes, n, d), generator=gen, device="cuda") / math.sqrt(d / 24)
        z0 = z0 - z0.mean(dim=-2, keepdim=True)
        upstream = torch.randn((lanes, n, n), generator=gen, device="cuda")
        for name in CK.KERNEL_IDS:
            grads = []
            for fn in (CK.kernel_matrix, CK.kernel_matrix_reference):
                z = z0.clone().requires_grad_(True)
                s = torch.full((lanes,), 1.3, device="cuda", requires_grad=True)
                nz = torch.full((lanes,), 1e-2, device="cuda", requires_grad=True)
                k = fn(z, z, s, nz, name, True)
                grads.append(torch.autograd.grad((k * upstream).sum(), (z, s, nz)))
            for g_kernel, g_plain in zip(*grads):
                err = float((g_kernel - g_plain).abs().max() / g_plain.abs().max().clamp_min(1e-30))
                _require(err <= 1e-5, f"KernelMatrix gradient ({name}, {lanes}x{n}x{d}) differs from plain autograd: "
                                      f"{err:.3e}")
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


def phase3_timings(smi):
    from turbojax_torch import kernel_bench as KB

    lines = KB.measure_kernels(smi, emit=lambda line: _emit({"phase": 3, **line}))
    _emit({"phase": 3, "bench_iteration_ms": KB.bench_iteration(_require), "card": smi})
    for line in KB.append_against_refactor(smi):
        _require(line["max_abs_diff"] <= 1e-4, f"append and refactorization disagree: {line}")
        _emit({"phase": 3, "chol": "append_against_refactor", **line})
    _emit({"phase": 3, **KB.lbfgs_fit(smi)})
    return lines[KB.KM_HEADLINE], lines[KB.TS_HEADLINE]


def _counted(torch, CK, run):
    """``run()`` with both launch counters set to 0 just before and read just
    after; returns (its value, wall seconds, {kernel: launches})."""
    torch.cuda.synchronize()
    CK.LAUNCHES = 0
    CK.TS_COV_LAUNCHES = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {"kernel_matrix": CK.LAUNCHES, "ts_cov": CK.TS_COV_LAUNCHES}


def _check_run(name, res, launches, init_best, iterations, kernels=("kernel_matrix", "ts_cov")):
    """Fails unless the path's kernels were launched, the incumbent trace has
    one finite, non-increasing entry per batch, the history is finite (under
    TuRBO it holds the last region's points, as the JAX package's does: none
    right after a restart) and the best value beats the initial design's."""
    for kernel in kernels:
        _require(launches[kernel] > 0, f"{name} ran without launching the {kernel} kernel")
    trace = [float(v) for v in res.incumbent_trace]
    _require(len(trace) == iterations and all(map(math.isfinite, trace)), f"{name}: incumbent trace {trace[-3:]}")
    _require(all(b <= a for a, b in zip(trace, trace[1:])), f"{name}: the incumbent trace rises")
    _require(all(map(math.isfinite, res.y_hist.tolist())), f"{name}: non-finite history")
    _require(math.isfinite(res.best_y) and res.best_y == trace[-1], f"{name}: best_y {res.best_y} is not the trace's last")
    _require(res.best_y < init_best, f"{name}: best_y {res.best_y} does not improve on the initial design {init_best}")


def phase_config(torch, CK, smi, phase, name, chol_mode=None):
    """One registered configuration at seed 0 through ``run_config``."""
    from turbojax_torch import registry as R
    from turbojax_torch.profile_config5 import run_config

    cfg = R.get_config(name)
    (res, bench), wall, launches = _counted(torch, CK, lambda: run_config(name, 0, chol_mode=chol_mode))
    if cfg.method == "bo":
        loop, kernels = cfg.bo, ("kernel_matrix",)  # EI: no Thompson sampling, so no TS covariance
        init_best = float(res.y_hist[:loop.n_init].min())
    else:
        loop, kernels = cfg.turbo, ("kernel_matrix", "ts_cov")
        # the m init designs fill the first m·n_init/q batches
        init_best = float(res.incumbent_trace[cfg.m * loop.n_init // loop.batch_size - 1])
    _check_run(name, res, launches, init_best, loop.n_iters, kernels)
    _emit({"phase": phase, "config": name, "m": cfg.m, "chol_mode": chol_mode, "evals": len(res.y_hist),
           "wall_s": wall, "best_y": res.best_y, "regret": res.best_y - bench.optimum, "init_design_best": init_best,
           "launches": launches, "iterations": len(res.incumbent_trace), "card": smi})
    return launches


def phase7_acquisition_only(torch, CK, smi):
    """Config 3: one Thompson suggestion; q distinct finite points in the
    box, both kernels launched."""
    import numpy as np

    from turbojax_torch import registry as R
    from turbojax_torch.profile_config5 import run_config

    cfg = R.get_config("ts_q10")
    (res, bench), wall, launches = _counted(torch, CK, lambda: run_config("ts_q10", 0))
    for kernel, n in launches.items():
        _require(n > 0, f"ts_q10 ran without launching the {kernel} kernel")
    xs = res.x_hist
    _require(xs.shape == (cfg.bo.batch_size, bench.dim) and bool(np.isfinite(xs).all())
             and bool(np.isfinite(res.y_hist).all()), "ts_q10: the suggestion is not q finite points")
    _require(bool((xs >= np.asarray(bench.lb) - 1e-5).all() and (xs <= np.asarray(bench.ub) + 1e-5).all()),
             "ts_q10: a suggested point lies outside the box")
    _require(np.unique(xs, axis=0).shape[0] == cfg.bo.batch_size, "ts_q10: the suggestion repeats a point")
    _emit({"phase": 7, "config": "ts_q10", "wall_s": wall, "best_of_suggestion": res.best_y, "launches": launches,
           "candidates": cfg.bo.n_candidates, "q": cfg.bo.batch_size, "ts_chunk": cfg.bo.ts_chunk, "card": smi})
    return launches


def _ackley_numpy(x):
    import numpy as np

    return (-20.0 * np.exp(-0.2 * np.sqrt((x**2).mean(axis=-1))) - np.exp(np.cos(2 * np.pi * x).mean(axis=-1))
            + 20.0 + np.e)


def phase7_ask_tell(torch, CK, smi, label, method, bench_name, objective=None, **kwargs):
    """An ask/tell run with the objective evaluated on the host in numpy
    (``objective``, or the benchmark through a CPU tensor)."""
    import numpy as np

    from turbojax_torch import Optimizer
    from turbojax_torch import benchmarks as B

    bench = B.get_benchmark(bench_name)
    if objective is None:
        def objective(x):
            return bench.fn(torch.as_tensor(x)).numpy()

    opt = Optimizer(bench.lb, bench.ub, method=method, seed=0, **kwargs)
    _require(opt.device.type == "cuda", f"{label}: the Optimizer is not on the GPU")
    res, wall, launches = _counted(torch, CK, lambda: opt.optimize(lambda x: np.asarray(objective(x), np.float32)))
    n_init = kwargs["n_init"] * kwargs.get("m", 1) if method == "turbom" else kwargs["n_init"]
    init_best = float(res.y_hist[:n_init].min())
    tells = -(-kwargs["max_evals"] // kwargs["batch_size"])
    kernels = ("kernel_matrix",) if method == "bo" and kwargs.get("acq") != "ts" else ("kernel_matrix", "ts_cov")
    _check_run(label, res, launches, init_best, tells, kernels)
    _emit({"phase": 7, "ask_tell": label, "method": method, "benchmark": bench_name, "evals": len(res.y_hist),
           "wall_s": wall, "best_y": res.best_y, "regret": res.best_y - bench.optimum, "init_design_best": init_best,
           "launches": launches, "tells": tells, "card": smi})
    return launches


def main() -> int:
    import torch

    smi = phase0_device(torch)
    from turbojax_torch import cuda_kernels as CK

    phase1_build(CK)
    max_err, ts_err = phase2_parity(torch, CK)
    km_line, ts_line = phase3_timings(smi)
    from turbojax_torch import registry as R

    paths = {
        "turbo1_ackley10": phase_config(torch, CK, smi, 4, "turbo1_ackley10"),
        "turbom5_rover60": phase_config(torch, CK, smi, 5, "turbom5_rover60"),
        "branin_ei": phase_config(torch, CK, smi, 6, "branin_ei"),
        "branin_ei_refactor": phase_config(torch, CK, smi, 6, "branin_ei", chol_mode="refactor"),
        "hartmann6_lbfgs": phase_config(torch, CK, smi, 6, "hartmann6_lbfgs"),
        "ts_q10": phase7_acquisition_only(torch, CK, smi),
    }
    c4 = R.get_config("turbo1_ackley10")
    paths["ask_tell_turbo1_ackley10"] = phase7_ask_tell(
        torch, CK, smi, "ask_tell_turbo1_ackley10", "turbo1", "ackley10", _ackley_numpy, n_init=c4.turbo.n_init,
        max_evals=c4.turbo.max_evals, batch_size=c4.turbo.batch_size, n_candidates=c4.turbo.n_candidates,
        gp_config=c4.gp)
    paths["ask_tell_bo_branin"] = phase7_ask_tell(
        torch, CK, smi, "ask_tell_bo_branin", "bo", "branin", n_init=10, max_evals=30, batch_size=2, acq="ei",
        n_candidates=2000)
    c5 = R.get_config("turbom5_rover60")
    paths["ask_tell_turbom_rover60"] = phase7_ask_tell(
        torch, CK, smi, "ask_tell_turbom_rover60", "turbom", "rover60", m=2, n_init=20, max_evals=200, batch_size=10,
        n_candidates=1000, gp_config=c5.gp)
    entries = []
    for name, source, replaces, err, line in (
        ("kernel_matrix", "turbojax_torch/csrc/kernel_matrix.cu", "turbojax/pallas_kernels.py:72", max_err, km_line),
        ("ts_cov", "turbojax_torch/csrc/ts_cov.cu", "turbojax/pallas_kernels.py:194", ts_err, ts_line),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths["turbom5_rover60"][name],
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "max_abs_err": err, "ms": line["kernel_ms"], "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"], "device_ms": line["device_ms"],
            "shape": line["shape"],
        })
    _emit({"kernels": entries})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
