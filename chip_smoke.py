#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``turbojax_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the process exits
non-zero and the final line is not printed:

0. device check: the ``nvidia-smi`` name and power limit, torch/CUDA
   versions; fails without a CUDA device;
1. build ``turbojax_torch/csrc/kernel_matrix.cu`` for sm_90a (first use);
2. the kernel against its plain PyTorch version on the card, for the four
   kernel functions, float32 and float64, with and without noise, at the
   main path's shapes plus ragged, d = 60 and clustered inputs; then a small
   GP problem on the card (float64, through the kernel) against the same
   problem on the CPU (the plain version);
3. timings with CUDA events: kernel against plain at the main path's
   shapes, and one ``bench.py``-style iteration (N = 2000 in a 2048 buffer,
   5000 candidates, EI, Thompson q = 10 in chunks of 1000) with the kernel
   and with the plain version;
4. config 4 (``turbo1_ackley10``: TuRBO-1, Ackley-10D, 1000 evaluations,
   seed 0) end to end through ``turbojax_torch.optimize`` with the launch
   counter reset just before; fails unless the kernel was launched and the
   result is finite and better than the initial design.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
"""

import json
import math
import subprocess
import sys
import time

F32_RTOL, F32_ATOL = 2e-5, 2e-6  # as the JAX package's Pallas parity tests
F64_RTOL = 1e-12
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
    path = CK.build()
    _emit({"phase": 1, "build_s": time.perf_counter() - t0, "library": path.split("/build/")[-1]})


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
    e2e = _small_gp_agreement(torch)
    _emit({"phase": 2, "comparisons": n_checked, "max_abs_err_f32": worst[torch.float32],
           "max_abs_err_f64": worst[torch.float64], "tolerance_f32": [F32_RTOL, F32_ATOL],
           "tolerance_f64_rtol": F64_RTOL, "small_gp_cuda_vs_cpu": e2e})
    return worst[torch.float32]


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

    it_ms = _bench_iteration(torch)
    _emit({"phase": 3, "bench_iteration_ms": it_ms, "card": smi})
    return kernel_times


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
    torch.cuda.synchronize()
    CK.LAUNCHES = 0
    t0 = time.perf_counter()
    res = optimize(
        bench.fn, bench.lb, bench.ub, t.max_evals, method=cfg.method, n_init=t.n_init,
        batch_size=t.batch_size, n_candidates=t.n_candidates, gp_config=cfg.gp, seed=0,
        device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = CK.LAUNCHES
    init_best = float(res.incumbent_trace[t.n_init // t.batch_size - 1])
    _require(launches > 0, "config 4 ran without launching the CUDA kernel")
    _require(bool(len(res.y_hist) > 0 and all(map(math.isfinite, res.y_hist.tolist()))), "non-finite history")
    _require(math.isfinite(res.best_y), "non-finite best_y")
    _require(res.best_y < init_best, f"best_y {res.best_y} does not improve on the initial design {init_best}")
    _emit({"phase": 4, "config": cfg.name, "evals": t.max_evals, "wall_s": wall, "best_y": res.best_y,
           "regret": res.best_y - bench.optimum, "init_design_best": init_best, "launches": launches,
           "iterations": len(res.incumbent_trace), "card": smi})
    return launches


def main() -> int:
    import torch

    smi = phase0_device(torch)
    from turbojax_torch import cuda_kernels as CK

    phase1_build(CK)
    max_err = phase2_parity(torch, CK)
    kernel_times = phase3_timings(torch, CK, smi)
    launches = phase4_config4(torch, CK, smi)
    k_ms, p_ms = kernel_times["grid_15x1000x1000_d10_noise"]
    _emit({"kernels": [{
        "name": "kernel_matrix", "route": "cuda", "source": "turbojax_torch/csrc/kernel_matrix.cu",
        "replaces": "turbojax/pallas_kernels.py:72", "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
    }]})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
