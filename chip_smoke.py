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
   cross matrices, d = 60 and clustered inputs, the large-N crosses
   (5000 × 16384 and 16384 × 1000 at d = 10); the TS covariance with
   jitter 0 and 1e-6 at the chunks the paths launch (one 1000-candidate
   chunk, d = 60 with n = 2000 and 512, d = 10 with n = 1000, 2048 and
   16384), config 5's five-chunk batches,
   m = 1, 63, 65 and 999, n = 1 and n = 1750, and a trust region of side
   0.5**7 at ℓ = 0.01; and plain BO's shapes: K(Z, Z) at 60 points, d = 2
   (config 1) and four lanes of 112 points, d = 6 (config 2's L-BFGS
   restarts), their posterior cross matrices against 2000 candidates and the
   one-row cross of an append; the float64 designs' edges (K(Z, Z) at 15,
   17 and 33 points, d = 2, 100 and 70, a batch of three at 97 points, a
   31 x 65 cross; the TS covariance at m = 15, n = 3; m = 17, n = 1001,
   d = 70; three chunks of m = 999, n = 1001; two of m = 97, n = 17,
   d = 100). Each case draws its inputs from its own
   generator, seeded from its label. The float32 outputs are gated against
   the plain version in float64 on the same inputs (the exact result): the
   kernel matrix at rtol 2e-5 / atol 2e-6, the TS covariance at
   3e-5·outputscale (the TS ladder's first rung); per case the kernel's
   largest error may exceed the plain float32 version's by at most 2e-6
   (·outputscale for the TS covariance). The float64 outputs are gated
   against the plain float64 version at rtol 1e-12 and 1e-12·outputscale.
   K(Z, Z) and every TS covariance must be bitwise
   symmetric, two calls bitwise equal, and in f32 the diagonal exact
   (K(Z, Z)'s is outputscale + noise; ts_cov's kernel term, with v = 0, is
   outputscale). K(Z, Z) at the large-N shapes, (1, 16384², 10), the grid
   fit's (15, 8192², 10) and (1, 46400², 10) (where a row offset times the
   row length passes 2³¹), is checked whole for finiteness, run-to-run
   equality and its diagonal, and gated in three blocks of 64 rows that
   must equal their mirrored columns. The distributed GP's row blocks with
   the exact self-value on their global diagonal (``diag_offset``): a
   2048-row block of 8192 points at offset 4096, a ragged 130-row block at
   d = 60, the whole 4096-point matrix at offset 0 (one tensor: the
   symmetric schedule) and a 100-row block at offset 3, gated the same way,
   the diagonal exact in both dtypes. Then the kernel-matrix gradients
   (kernel forward, plain
   backward) against plain autograd at (16, 2048, 60) and (4, 112, 6), and a small GP
   problem on the card (float64, through the kernels) against the same
   problem on the CPU (the plain versions);
3. ``turbojax_torch.kernel_bench``: both kernels at the shapes the paths
   launch (with the large-N shapes: K(X, X) at 16384 points, the grid's
   15 and the L-BFGS fit's 4 lanes at 8192, the 5000 × 16384 pathwise
   cross, a 16384 × 1000 posterior chunk, the TS chunk at n = 16384; the
   distributed GP's blocks at N = 16384: the whole matrix of a mesh of one
   device and an 8192-row block of a mesh of two), each
   against its plain version (CUDA events) with its device
   time (torch.profiler, by ``portbench/trace.py``'s recipe), its bound
   (``portbench/yardstick/bounds.py``) and share and, for ts_cov, the time of
   ``v.mT @ v`` alone; then one ``bench.py``-style iteration (N = 2000 in a
   2048 buffer, 5000 candidates, EI, Thompson q = 10 in chunks of 1000)
   with the kernels and with the plain versions; ``bo._append_batch``'s
   appends against one refactorization at N = 64, 512 and 2048, one
   L-BFGS fit at (4, 112, 6) with its loss evaluations and wall, and
   ``linalg.chol_inverse`` (the marginal likelihood's backward) at
   N = 16384 beside its bound and ``torch.cholesky_inverse`` (within 1e-4
   of it);
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
   TuRBO-m run (m = 2, rover-60D);
8. the loop options, each through ``profile_config5.run_config`` with the
   configuration's ``TurboConfig`` changed: (a) config 4 with
   ``ts_dtype="float64"`` (the f64 Thompson lane: the f64 instantiations of
   both kernels must be launched); (b) config 4 with ``ts_sampler="rff"``
   and with ``"pathwise"``; (c) config 5 with ``"pathwise"`` at full width
   (m = 5, d = 60, 5000 candidates per region), 600 evaluations; (d)
   config 5 with ``local_frac=0.3`` and with ``fit_every=2``, 400
   evaluations each (depths cut to make room for phase 9); (e) config 4 through ``run_turbo1`` killed from
   ``on_iteration`` at iteration 40 and resumed from its checkpoint (under
   ``build/chip_smoke/``): the incumbent trace must equal an uninterrupted
   run's bit for bit; and an ask/tell ``Optimizer`` at config 4's sizes
   saved after five tells and restored into a fresh one must ask what the
   saved one asks next; (f) config 5 with ``ts_dtype="float64"`` at full
   width (m = 5, d = 60, 5000 candidates per region, TS chunks of 1000),
   400 evaluations as (d): both kernels' float64 designs must be launched
   (``LAUNCHES_F64``, ``TS_COV_LAUNCHES_F64``);
9. large-N plain BO at d = 10 and full width (5000 candidates, q = 10),
   ``turbojax_torch.bench_large_n`` and ``bo_distributed``: (a) at N = 4096,
   8192 and 16384, ``make_gp_state``, the posterior in chunks of 1000 and
   auto-chunked, the exact Thompson selection (q = 10, chunks of 1000: the
   TS covariance at n = N), the pathwise paths, 5 Adam steps and the grid
   fit in the branch ``gp.grid_rows_batched`` picks, each the median of
   three warm synchronized calls with its peak device memory; (b) two loops
   through ``run_bo_distributed`` on the objective of
   ``turbojax_torch/examples/run_distributed_bo.py``: EI from 8192 initial
   points, 4 iterations, the default L-BFGS fit every second iteration; and
   pathwise Thompson sampling from 16384 points, 3 iterations, a 5-step
   Adam fit every iteration; (c) the checkpoint the EI loop saved after
   iteration 2 (what a run killed in iteration 3 leaves) resumed: iteration
   3 is off the fit cadence, so the resumed run refactorizes at the
   restored hypers, and its trace and history must equal the uninterrupted
   run's bit for bit;
10. the multi-device modules on a mesh of one device, an NCCL process group
   of this process alone (``turbojax_torch.parallel``): (a) at d = 10,
   N = 16384, 5000 candidates, q = 10, panels of 128, the row-sharded
   ``DistributedGP`` (factorization, posterior, MLL),
   ``distributed_pathwise_paths`` with the dense sampler's draws and
   ``fit_distributed_gp``'s 5 Adam steps, each against the dense route on
   the same inputs (in f32 the distributed route's error against the dense
   route in f64 at most twice the dense route's own, or 1e-5 of the
   reference's magnitude), and the same at N = 4096 in f64 to rtol 1e-9;
   (b) ``sharded_acq_topq`` over 40000 candidates (above
   ``CAND_SHARD_MIN``) at N = 2000, bitwise the dense top-q, and
   ``sharded_fit_gp`` at config 2's width against ``gp.fit_gp`` by the
   fitted loss (rtol 1e-4); (c) ``optimize(method="turbom", mesh=...)`` at
   config 5's width, 400 evaluations, which must improve on its initial
   design; (d) ``optimize(method="bo", mesh=...)`` on Branin with
   ``budget_bytes=1``, and the same loop's run log: dense every iteration.

In phases 4 to 10 the launch counters are set to 0 just before each run and
read just after; a run fails unless the kernels of its path were launched
(the kernel matrix on every path; the TS covariance wherever the exact
Thompson sampler runs: configs 3, 4 and 5 and the TuRBO ask/tell runs, not
the RFF and pathwise samplers, which build no candidate covariance; in
phase 9 the kernel matrix in each loop and the TS covariance in the
components; in phase 10 the kernel matrix in every part and the TS
covariance in the TuRBO-m run) and the
result is finite, its incumbent trace non-increasing, and its best value
better than the initial design's. Phase 3 also times both kernels at the f64
lane's shapes and the pathwise cross (5000 × 2000 at d = 60, 1000 × 1000 at
d = 10), which phase 2 checks too. Then one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": ...}``.
"""

import json
import math
import os
import shutil
import sys
import time
import zlib

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
    from turbojax_torch.kernel_bench import card

    smi = card()
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


def _case_generator(torch, label):
    """Each case's own generator, seeded from its label: adding or moving a
    case changes no other case's inputs."""
    return torch.Generator(device="cuda").manual_seed(zlib.crc32(label.encode()))


def _cases(torch):
    """(label, z1, z2, outputscale, noise) in float64 on the card; z1 is z2
    for K(Z, Z). Inputs are scaled by 1/ℓ and centered, as gp._kernel_matrix
    hands them to the kernel. Each case draws from its own generator."""
    dev = "cuda"
    out = []

    def case(label):
        gen = _case_generator(torch, label)

        def unit(*shape):
            return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

        return label, unit

    def centered(z1, z2=None):
        if z2 is None:
            return z1 - z1.mean(dim=-2, keepdim=True)
        c = 0.5 * (z1.mean(dim=-2, keepdim=True) + z2.mean(dim=-2, keepdim=True))
        return z1 - c, z2 - c

    def rows(vals):
        return torch.tensor(vals, dtype=torch.float64, device=dev)

    one = torch.tensor(1.3, dtype=torch.float64, device=dev)
    nz = torch.tensor(1e-3, dtype=torch.float64, device=dev)
    # the 15-row grid fit: ℓ ∈ {0.1, 0.25, 0.5, 1.0, 1.9} × noise ∈ {2e-4, 1e-3, 1e-2}
    label, unit = case("grid_15x1000x1000_d10")
    ls = rows([v for v in (0.1, 0.25, 0.5, 1.0, 1.9) for _ in range(3)])
    z = centered(unit(1000, 10)[None] / ls[:, None, None])
    out.append((label, z, z, torch.ones(15, dtype=torch.float64, device=dev), rows([2e-4, 1e-3, 1e-2] * 5)))
    ell = math.sqrt(10 / 24)  # typical d² ≈ 4: kernel values neither 0 nor 1
    ell60 = math.sqrt(60 / 24)
    # config 5's grid batches: 16 rows at the 2000 rung, 4 regions × 16 rows at the 512 rung
    label, unit = case("grid_16x2000x2000_d60")
    z = centered(unit(2000, 60)[None] / (ell60 * rows([0.5, 0.8, 1.0, 1.6] * 4)[:, None, None]))
    out.append((label, z, z, rows([1.3, 0.7] * 8), rows([1e-2, 1e-3] * 8)))
    label, unit = case("grid_64x512x512_d60")
    z = centered(unit(64, 512, 60) / ell60)
    out.append((label, z, z, rows([1.3, 0.7, 2.0, 1.0] * 16), rows([1e-2, 1e-3] * 32)))
    for m in (1, 63, 65, 999):
        label, unit = case(f"kzz_{m}_d60")
        zc = centered(unit(m, 60) / ell60)
        out.append((label, zc, zc, one, nz))
    label, unit = case("cross_1000x1000_d10")
    z1, z2 = centered(unit(1000, 10) / ell, unit(1000, 10) / ell)
    out.append((label, z1, z2, one, nz))
    label, unit = case("kxx_1000_d10")
    zc = centered(unit(1000, 10) / ell)
    out.append((label, zc, zc, one, nz))
    label, unit = case("bench_cross_2048x5000_d10")
    xb = torch.cat([unit(2000, 10), torch.zeros(48, 10, dtype=torch.float64, device=dev)])
    z1, z2 = centered(xb / ell, unit(5000, 10) / ell)
    out.append((label, z1, z2, one, nz))
    for n, m in ((1, 1), (130, 257), (999, 1000)):
        label, unit = case(f"ragged_{n}x{m}_d10")
        z1, z2 = centered(unit(n, 10) / ell, unit(m, 10) / ell)
        out.append((label, z1, z2, one, nz))
    label, unit = case("ts_cross_2000x1000_d60")
    z1, z2 = centered(unit(2000, 60) / ell60, unit(1000, 60) / ell60)
    out.append((label, z1, z2, one, nz))
    # plain BO: config 1 (60 points, d = 2) and config 2 (112 points, d = 6, four L-BFGS lanes)
    for tag, n, d, lanes in (("bo1", 60, 2, 1), ("bo2", 112, 6, 4)):
        ell_d = math.sqrt(d / 24)
        if lanes == 1:
            label, unit = case(f"{tag}_kzz_{n}_d{d}")
            zc = centered(unit(n, d) / ell_d)
            out.append((label, zc, zc, one, nz))
        else:
            label, unit = case(f"{tag}_lanes{lanes}_kzz_{n}_d{d}")
            zc = centered(unit(n, d)[None] / (ell_d * rows([0.5, 0.8, 1.0, 1.6])[:, None, None]))
            out.append((label, zc, zc, rows([1.3, 0.7, 2.0, 1.0]), rows([1e-2, 1e-3, 1e-4, 0.1])))
        label, unit = case(f"{tag}_cross_{n}x2000_d{d}")
        z1, z2 = centered(unit(n, d) / ell_d, unit(2000, d) / ell_d)
        out.append((label, z1, z2, one, nz))
        label, unit = case(f"{tag}_append_1x{n}_d{d}")
        z1, z2 = centered(unit(1, d) / ell_d, unit(n, d) / ell_d)
        out.append((label, z1, z2, one, nz))
    # a trust region of side 0.5**7 around one point, at a small fitted ℓ
    label, unit = case("clustered_1000x1000_d10")
    c0 = unit(1, 10)
    x1 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    x2 = c0 + 0.5**7 * (unit(1000, 10) - 0.5)
    z1, z2 = centered(x1 / 0.01, x2 / 0.01)
    out.append((label, z1, z2, one, nz))
    # the pathwise sampler's cross k(x*, X): 5000 candidates against a 2000-row buffer
    label, unit = case("pathwise_cross_5000x2000_d60")
    xb = torch.cat([unit(1950, 60), torch.zeros(50, 60, dtype=torch.float64, device=dev)])
    z1, z2 = centered(unit(5000, 60) / ell60, xb / ell60)
    out.append((label, z1, z2, one, nz))
    # large-N plain BO (d = 10): the pathwise cross against 16384 rows and a posterior chunk
    label, unit = case("large_cross_5000x16384_d10")
    z1, z2 = centered(unit(5000, 10) / ell, unit(16384, 10) / ell)
    out.append((label, z1, z2, one, nz))
    label, unit = case("large_post_16384x1000_d10")
    z1, z2 = centered(unit(16384, 10) / ell, unit(1000, 10) / ell)
    out.append((label, z1, z2, one, nz))
    # the float64 design's edges: K(Z, Z) around its 32-tiles, d past the 64
    # features staged at once, a batch of three, a ragged cross
    for m, d in ((15, 2), (17, 100), (33, 70)):
        label, unit = case(f"kzz_{m}_d{d}")
        zc = centered(unit(m, d) / math.sqrt(d / 24))
        out.append((label, zc, zc, one, nz))
    label, unit = case("batch3_kzz_97_d5")
    zc = centered(unit(3, 97, 5) / math.sqrt(5 / 24))
    out.append((label, zc, zc, rows([1.3, 0.7, 2.0]), rows([1e-2, 1e-3, 1e-4])))
    label, unit = case("ragged_31x65_d10")
    z1, z2 = centered(unit(31, 10) / ell, unit(65, 10) / ell)
    out.append((label, z1, z2, one, nz))
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


def _gate_kernel_matrix(torch, what, got, ref, exact):
    """One kernel-matrix output against the exact result, the plain version
    in float64 on the same (rounded) inputs: finite, and in float32 within
    rtol 2e-5 / atol 2e-6 of it, in float64 within rtol 1e-12. Returns the
    kernel's and the plain version's (``ref``, in the kernel's dtype) largest
    absolute errors against it."""
    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.double() - exact).abs()
    tol = F32_ATOL + F32_RTOL * exact.abs() if got.dtype == torch.float32 else F64_RTOL * exact.abs()
    bad = err > tol
    _require(not bool(bad.any()), f"{what}: {int(bad.sum())} entries out of tolerance against the f64 plain "
                                  f"version, max abs err {float(err.max()):.3e}")
    return float(err.max()), float((ref.double() - exact).abs().max())


def _require_no_worse(kernel, what, versus_f64, atol):
    _require(versus_f64["kernel"] <= versus_f64["plain"] + atol,
             f"{kernel} {what}: f32 error against the f64 plain version {versus_f64['kernel']:.3e} above the plain "
             f"f32 version's {versus_f64['plain']:.3e} + {atol:.0e}")


def phase2_parity(torch, CK):
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    n_checked = 0
    for label, z1, z2, os_, noise in _cases(torch):
        same = z2 is z1
        versus_f64 = {"kernel": 0.0, "plain": 0.0}
        for dtype in (torch.float32, torch.float64):
            a = z1.to(dtype).contiguous()
            b = a if same else z2.to(dtype).contiguous()
            s, nz = os_.to(dtype), noise.to(dtype)
            a64 = a.double()
            b64 = a64 if same else b.double()
            for name in CK.KERNEL_IDS:
                for add_noise in (False, True):
                    what = f"{label} {dtype} {name} noise={add_noise}"
                    got = CK.kernel_matrix(a, b, s, nz, name, add_noise)
                    again = CK.kernel_matrix(a, b, s, nz, name, add_noise)
                    torch.cuda.synchronize()
                    ref = CK.kernel_matrix_reference(a, b, s, nz, name, add_noise)
                    exact = ref if dtype == torch.float64 else CK.kernel_matrix_reference(
                        a64, b64, s.double(), nz.double(), name, add_noise)
                    err, plain_err = _gate_kernel_matrix(torch, what, got, ref, exact)
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    if same:
                        _require(torch.equal(got, got.mT), f"{what}: K(Z, Z) is not bitwise symmetric")
                        if dtype == torch.float32:
                            _exact_diagonal(torch, got, s, nz, add_noise, what)
                    worst[dtype] = max(worst[dtype], err)
                    n_checked += 1
                    if dtype == torch.float32:
                        versus_f64["kernel"] = max(versus_f64["kernel"], err)
                        versus_f64["plain"] = max(versus_f64["plain"], plain_err)
                    del got, again, ref, exact
        _require_no_worse("kernel_matrix", label, versus_f64, F32_ATOL)
        _emit({"phase": 2, "kernel": "kernel_matrix", "case": label, "shape": [list(z1.shape), list(z2.shape)],
               "ok": True, "f32_err_vs_f64_plain": versus_f64})
    n_checked += _large_kernel_matrix_parity(torch, CK, worst)
    n_checked += _offset_parity(torch, CK, worst)
    _emit({"phase": 2, "kernel": "kernel_matrix", "comparisons": n_checked,
           "max_abs_err_f32_vs_f64_plain": worst[torch.float32], "max_abs_err_f64": worst[torch.float64],
           "tolerance_f32": [F32_RTOL, F32_ATOL], "tolerance_f64_rtol": F64_RTOL})
    ts_worst = _ts_cov_parity(torch, CK)
    grad_err = _kernel_matrix_grad_parity(torch, CK)
    e2e = _small_gp_agreement(torch)
    _emit({"phase": 2, "kernel_matrix_grad_max_rel_err": grad_err, "small_gp_cuda_vs_cpu": e2e})
    return worst[torch.float32], ts_worst


# (label, batch, n): K(Z, Z) at d = 10 too large to compare whole
LARGE_KZZ_CASES = (("large_kxx_16384_d10", 1, 16384), ("large_grid15_8192_d10", 15, 8192),
                   ("index_kxx_46400_d10", 1, 46400))


def _large_kernel_matrix_parity(torch, CK, worst):
    """K(Z, Z) at the large-N shapes, too large to hold beside their plain
    versions whole: (1, 16384², 10), the grid fit's (15, 8192², 10) and
    (1, 46400², 10), where a row offset times the row length passes 2³¹ (the
    kernel's store offsets are 64-bit). The whole output must be finite,
    two calls bitwise equal and, in f32, the diagonal exact; three blocks
    of 64 rows (the first, the middle and the last) are gated against the
    plain version on those rows as the cases above are, and must equal
    their mirrored columns bitwise. Returns the comparisons made."""
    n_checked = 0
    ell = math.sqrt(10 / 24)
    for label, batch, n in LARGE_KZZ_CASES:
        gen = _case_generator(torch, label)
        z = torch.rand((batch, n, 10), generator=gen, device="cuda", dtype=torch.float64)
        ls = torch.tensor([v for v in (0.1, 0.25, 0.5, 1.0, 1.9) for _ in range(3)][:batch] if batch > 1 else [ell],
                          dtype=torch.float64, device="cuda")
        z = z / ls[:, None, None]
        z = z - z.mean(dim=-2, keepdim=True)
        s64 = torch.full((batch,), 1.3, dtype=torch.float64, device="cuda")
        nz64 = torch.tensor([2e-4, 1e-3, 1e-2] * 5, dtype=torch.float64, device="cuda")[:batch]
        if batch == 1:
            z, s64, nz64 = z[0], s64[0], nz64[0]
        blocks = [range(0, 64), range(n // 2, n // 2 + 64), range(n - 64, n)]
        versus_f64 = {"kernel": 0.0, "plain": 0.0}
        for dtype in (torch.float32, torch.float64):
            a, s, nz = z.to(dtype).contiguous(), s64.to(dtype), nz64.to(dtype)
            a64 = a.double()
            for name in CK.KERNEL_IDS:
                for add_noise in (False, True):
                    what = f"{label} {dtype} {name} noise={add_noise}"
                    got = CK.kernel_matrix(a, a, s, nz, name, add_noise)
                    again = CK.kernel_matrix(a, a, s, nz, name, add_noise)
                    torch.cuda.synchronize()
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    del again
                    if dtype == torch.float32:
                        _exact_diagonal(torch, got, s, nz, add_noise, what)
                    for rows in blocks:
                        r = torch.tensor(list(rows), device="cuda")
                        got_rows = got.index_select(-2, r)
                        _require(torch.equal(got_rows, got.index_select(-1, r).mT),
                                 f"{what}: rows {rows.start}-{rows.stop} differ from their mirrored columns")
                        ref, exact = (_rows_reference(torch, CK, x, r, sc, noise, name, add_noise)
                                      for x, sc, noise in ((a, s, nz), (a64, s.double(), nz.double())))
                        err, plain_err = _gate_kernel_matrix(torch, f"{what} rows {rows.start}-{rows.stop}",
                                                             got_rows, ref, exact)
                        worst[dtype] = max(worst[dtype], err)
                        n_checked += 1
                        if dtype == torch.float32:
                            versus_f64["kernel"] = max(versus_f64["kernel"], err)
                            versus_f64["plain"] = max(versus_f64["plain"], plain_err)
                    del got
        _require_no_worse("kernel_matrix", label, versus_f64, F32_ATOL)
        _emit({"phase": 2, "kernel": "kernel_matrix", "case": label, "shape": list(z.shape), "rows_checked": 192,
               "ok": True, "f32_err_vs_f64_plain": versus_f64})
        del z, a, a64
        torch.cuda.empty_cache()
    return n_checked


# (label, rows, n, d, diag_offset): the distributed GP's row blocks of K(Z, Z)
# with the exact self-value on the global diagonal (``diag_offset``): a rank's
# block of a mesh of four at N = 8192, a ragged block at d = 60, the whole
# matrix of a mesh of one device (one tensor: the symmetric schedule), and a
# block whose diagonal crosses the tiles off their corners
OFFSET_CASES = (("dist_rowblock_2048x8192_d10_off4096", 2048, 8192, 10, 4096),
                ("dist_rowblock_130x390_d60_off130", 130, 390, 60, 130),
                ("dist_whole_4096x4096_d10", 4096, 4096, 10, 0),
                ("dist_rowblock_100x333_d7_off3", 100, 333, 7, 3))


def _offset_parity(torch, CK, worst):
    """The kernel matrix of a row block against all of Z with the exact
    global diagonal, gated against the plain version with the same offset as
    the cases above are; the entries (i, i + offset) must be outputscale
    (+ noise) exactly in both dtypes, two calls bitwise equal and the whole
    matrix bitwise symmetric. Returns the comparisons made."""
    n_checked = 0
    for label, rows, n, d, off in OFFSET_CASES:
        gen = _case_generator(torch, label)
        z = torch.rand((n, d), generator=gen, device="cuda", dtype=torch.float64) / math.sqrt(d / 24)
        z = z - z.mean(dim=0, keepdim=True)
        versus_f64 = {"kernel": 0.0, "plain": 0.0}
        for dtype in (torch.float32, torch.float64):
            a = z.to(dtype).contiguous()
            ar = a if rows == n else a[off:off + rows]
            a64 = a.double()
            ar64 = a64 if rows == n else a64[off:off + rows]
            s = torch.tensor(1.3, dtype=dtype, device="cuda")
            nz = torch.tensor(1e-3, dtype=dtype, device="cuda")
            r = torch.arange(rows, device="cuda")
            for name in CK.KERNEL_IDS:
                for add_noise in (False, True):
                    what = f"{label} {dtype} {name} noise={add_noise}"
                    got = CK.kernel_matrix(ar, a, s, nz, name, add_noise, diag_offset=off)
                    again = CK.kernel_matrix(ar, a, s, nz, name, add_noise, diag_offset=off)
                    torch.cuda.synchronize()
                    ref = CK.kernel_matrix_reference(ar, a, s, nz, name, add_noise, off)
                    exact = ref if dtype == torch.float64 else CK.kernel_matrix_reference(
                        ar64, a64, s.double(), nz.double(), name, add_noise, off)
                    err, plain_err = _gate_kernel_matrix(torch, what, got, ref, exact)
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    _require(bool((got[r, off + r] == (s + nz if add_noise else s)).all()),
                             f"{what}: the global diagonal is not outputscale + noise exactly")
                    if rows == n:
                        _require(torch.equal(got, got.mT), f"{what}: K(Z, Z) is not bitwise symmetric")
                    worst[dtype] = max(worst[dtype], err)
                    n_checked += 1
                    if dtype == torch.float32:
                        versus_f64["kernel"] = max(versus_f64["kernel"], err)
                        versus_f64["plain"] = max(versus_f64["plain"], plain_err)
                    del got, again, ref, exact
        _require_no_worse("kernel_matrix", label, versus_f64, F32_ATOL)
        _emit({"phase": 2, "kernel": "kernel_matrix", "case": label, "shape": [[rows, d], [n, d]],
               "diag_offset": off, "ok": True, "f32_err_vs_f64_plain": versus_f64})
    return n_checked


def _rows_reference(torch, CK, z, rows, s, noise, name, add_noise):
    """The plain version's rows ``rows`` of K(Z, Z). Where a row meets its
    own column the entry is outputscale (+ noise) exactly, as the plain
    K(Z, Z) and the kernel give it: the plain cross of the rows with Z
    would put the expansion's round-off into d² = 0 there, which Matérn-1/2
    turns into ~3e-8."""
    k = CK.kernel_matrix_reference(z.index_select(-2, rows).contiguous(), z, s, noise, name, False)
    diag = s + noise if add_noise else s
    k[..., torch.arange(len(rows), device=k.device), rows] = diag.reshape(-1, 1) if k.dim() == 3 else diag
    return k


def _ts_cases(torch):
    """(label, zs (B, m, d), v (B, n, m), outputscale (B,)) in float64 on the
    card: candidates scaled by 1/ℓ and centered as gp._scale_center hands
    them over, and v = L⁻¹K(X, zs) from a training set of n rows (noise
    1e-2), so that vᵀv cancels most of k(zs, zs) as it does in the TS. Each
    case draws from its own generator."""
    from turbojax_torch import cuda_kernels as CK

    dev, f64 = "cuda", torch.float64

    def chunk(gen, m, n, d, ell, cluster=None):
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

    def batch(label, chunks, scales, **kw):
        """``chunks`` (m, n, d, ℓ) chunks from the case's own generator."""
        gen = _case_generator(torch, label)
        parts = [chunk(gen, *spec, **kw) for spec in chunks]
        zs = torch.stack([p[0] for p in parts])
        v = torch.stack([p[1] for p in parts])
        return label, zs.contiguous(), v.contiguous(), torch.tensor(scales, dtype=f64, device=dev)

    ell10, ell60 = math.sqrt(10 / 24), math.sqrt(60 / 24)
    scales5 = [1.3, 0.7, 2.0, 1.0, 0.3]
    return [
        batch("path_1000_n2000_d60", [(1000, 2000, 60, ell60)], [1.3]),
        batch("path_1000_n512_d60", [(1000, 512, 60, ell60)], [0.7]),
        batch("path_1000_n1000_d10", [(1000, 1000, 10, ell10)], [1.3]),
        batch("bench_1000_n2048_d10", [(1000, 2048, 10, ell10)], [1.3]),
        batch("tr5_chunk_5x1000_n2048_d60", [(1000, 2048, 60, ell60)] * 5, scales5),
        batch("tr5_chunk_5x1000_n512_d60", [(1000, 512, 60, ell60)] * 5, scales5),
        batch("m1_n600_d60", [(1, 600, 60, ell60)], [1.3]),
        batch("m63_n300_d60", [(63, 300, 60, ell60)], [1.3]),
        batch("m65_n700_d60", [(65, 700, 60, ell60)], [1.3]),
        batch("m999_n1750_d60", [(999, 1750, 60, ell60)], [1.3]),
        batch("m1000_n1_d10", [(1000, 1, 10, ell10)], [1.3]),
        batch("clustered_1000_n1000_d60", [(1000, 1000, 60, 0.01)], [1.3], cluster=0.5**7),
        # large-N plain BO: the exact Thompson chunk against 16384 training rows
        batch("large_1000_n16384_d10", [(1000, 16384, 10, ell10)], [1.3]),
        # the float64 design's edges: m and n off its 96-tiles, 32-sub-tiles and
        # 16-row steps, d past the 64 features staged at once, batches
        batch("m15_n3_d60", [(15, 3, 60, ell60)], [1.3]),
        batch("m17_n1001_d70", [(17, 1001, 70, math.sqrt(70 / 24))], [1.3]),
        batch("b3_m999_n1001_d10", [(999, 1001, 10, ell10)] * 3, [1.3, 0.7, 2.0]),
        batch("b2_m97_n17_d100", [(97, 17, 100, math.sqrt(100 / 24))] * 2, [1.3, 0.3]),
    ]


def _ts_cov_parity(torch, CK):
    """The TS covariance kernel against its plain version on the same inputs:
    in float32 against the plain version in float64 at 3e-5·outputscale
    (and no worse than the plain float32 version + 2e-6·outputscale), in
    float64 against it at 1e-12·outputscale. Returns the largest float32
    absolute error against the float64 plain version."""
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    worst_abs = 0.0
    n_checked = 0
    for label, zs64, v64, s64 in _ts_cases(torch):
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
                    exact = ref if dtype == torch.float64 else CK.ts_cov_reference(
                        zs.double(), v.double(), s.double(), jitter, name)
                    err = float(((got.double() - exact).abs() / scale).max())
                    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
                    _require(err <= tol, f"{what}: max err {err:.3e}·outputscale against the f64 plain version "
                                         f"> {tol:.0e}")
                    _require(torch.equal(got, again), f"{what}: two calls differ")
                    _require(torch.equal(got, got.mT), f"{what}: not bitwise symmetric")
                    worst[dtype] = max(worst[dtype], err)
                    n_checked += 1
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs, float((got.double() - exact).abs().max()))
                        versus_f64["kernel"] = max(versus_f64["kernel"], err)
                        versus_f64["plain"] = max(versus_f64["plain"], float(((ref.double() - exact).abs() / scale).max()))
            if dtype == torch.float32:  # the kernel term alone: its diagonal is outputscale exactly
                for name in CK.KERNEL_IDS:
                    got = CK.ts_cov(zs, torch.zeros_like(v), s, 0.0, name)
                    _exact_diagonal(torch, got, s, None, False, f"ts_cov {label} {name} kernel term")
        _require_no_worse("ts_cov", label, versus_f64, F32_ATOL)
        _emit({"phase": 2, "kernel": "ts_cov", "case": label, "zs": list(zs64.shape), "v": list(v64.shape),
               "splits": plan.splits, "chunk": plan.chunk, "ok": True,
               "f32_err_vs_f64_plain_per_outputscale": versus_f64})
    _emit({"phase": 2, "kernel": "ts_cov", "comparisons": n_checked,
           "max_err_f32_per_outputscale": worst[torch.float32], "max_err_f64_per_outputscale": worst[torch.float64],
           "max_abs_err_f32_vs_f64_plain": worst_abs, "tolerance_f32": TS_F32_ATOL, "tolerance_f64": TS_F64_ATOL})
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
    line = KB.chol_inverse(smi)
    _require(line["max_rel_diff"] <= 1e-4, f"chol_inverse and torch.cholesky_inverse disagree: {line}")
    _emit({"phase": 3, **line})
    return ((lines[KB.KM_HEADLINE], lines[KB.KM_F64_HEADLINE], lines[KB.KM_LARGE_HEADLINE]),
            (lines[KB.TS_HEADLINE], lines[KB.TS_F64_HEADLINE], lines[KB.TS_LARGE_HEADLINE]))


def _counted(torch, CK, run):
    """``run()`` with the launch counters set to 0 just before and read just
    after; returns (its value, wall seconds, {kernel: launches}, the f64
    instantiations' as ``<kernel>_f64``)."""
    torch.cuda.synchronize()
    CK.LAUNCHES = CK.TS_COV_LAUNCHES = CK.LAUNCHES_F64 = CK.TS_COV_LAUNCHES_F64 = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {"kernel_matrix": CK.LAUNCHES, "ts_cov": CK.TS_COV_LAUNCHES,
                       "kernel_matrix_f64": CK.LAUNCHES_F64, "ts_cov_f64": CK.TS_COV_LAUNCHES_F64}


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


def phase_config(torch, CK, smi, phase, name, chol_mode=None, **options):
    """One registered configuration at seed 0 through ``run_config``, with
    ``options`` changing a TuRBO configuration's loop settings."""
    import dataclasses

    from turbojax_torch import registry as R
    from turbojax_torch.profile_config5 import run_config

    cfg = R.get_config(name)
    (res, bench), wall, launches = _counted(torch, CK, lambda: run_config(name, 0, chol_mode=chol_mode, **options))
    if cfg.method == "bo":
        loop, kernels = cfg.bo, ("kernel_matrix",)  # EI: no Thompson sampling, so no TS covariance
        init_best = float(res.y_hist[:loop.n_init].min())
    else:
        loop = dataclasses.replace(cfg.turbo, **options)
        # the RFF and pathwise samplers build no candidate covariance; the f64 lane runs both kernels in f64
        kernels = ("kernel_matrix",) if loop.ts_sampler != "exact" else ("kernel_matrix", "ts_cov")
        if loop.ts_dtype == "float64":
            kernels += ("kernel_matrix_f64", "ts_cov_f64")
        # the m init designs fill the first m·n_init/q batches
        init_best = float(res.incumbent_trace[cfg.m * loop.n_init // loop.batch_size - 1])
    _check_run(name, res, launches, init_best, loop.n_iters, kernels)
    _emit({"phase": phase, "config": name, "options": options, "m": cfg.m, "chol_mode": chol_mode,
           "evals": len(res.y_hist), "wall_s": wall, "best_y": res.best_y, "regret": res.best_y - bench.optimum,
           "init_design_best": init_best, "launches": launches, "iterations": len(res.incumbent_trace), "card": smi})
    return launches


def phase7_acquisition_only(torch, CK, smi):
    """Config 3: one Thompson suggestion; q distinct finite points in the
    box, both kernels launched."""
    import numpy as np

    from turbojax_torch import registry as R
    from turbojax_torch.profile_config5 import run_config

    cfg = R.get_config("ts_q10")
    (res, bench), wall, launches = _counted(torch, CK, lambda: run_config("ts_q10", 0))
    for kernel in ("kernel_matrix", "ts_cov"):
        _require(launches[kernel] > 0, f"ts_q10 ran without launching the {kernel} kernel")
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


class _Kill(Exception):
    """Ends a run from ``on_iteration``, as a crash would."""


def phase8_kill_and_resume(torch, CK, smi, kill_at=40, every=10):
    """Config 4 through ``run_turbo1`` three times at seed 0: uninterrupted;
    checkpointing every ``every`` iterations and killed from
    ``on_iteration`` at iteration ``kill_at``; resumed from that
    checkpoint. The resumed trace must equal the uninterrupted one bit for
    bit. Then an ask/tell ``Optimizer`` at config 4's sizes saved after five
    tells and restored into a fresh one must ask what the saved one asks."""
    import numpy as np

    from turbojax_torch import Optimizer
    from turbojax_torch import benchmarks as B
    from turbojax_torch import checkpoint as CKPT
    from turbojax_torch import registry as R
    from turbojax_torch import trust_region as TR

    cfg = R.get_config("turbo1_ackley10")
    bench = B.get_benchmark(cfg.benchmark)
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "turbo1_ackley10")
    for suffix in (".npz", ".meta.json"):
        if os.path.exists(path + suffix):
            os.remove(path + suffix)

    def run(**kw):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return TR.run_turbo1(bench.fn, bench.lb, bench.ub, cfg.turbo, cfg.gp, gen, **kw)

    def kill(it, best):
        if it == kill_at:
            raise _Kill

    (_, ref), wall_ref, launches_ref = _counted(torch, CK, run)
    killed = False
    try:
        run(checkpoint_path=path, checkpoint_every=every, on_iteration=kill)
    except _Kill:
        killed = True
    _require(killed and CKPT.load_meta(path)["it"] == kill_at, "kill_and_resume: no checkpoint at the kill")
    (carry, trace), wall, launches = _counted(
        torch, CK, lambda: run(checkpoint_path=path, checkpoint_every=every, resume=True))
    for kernel in ("kernel_matrix", "ts_cov"):
        _require(launches_ref[kernel] > 0 and launches[kernel] > 0, f"kill_and_resume ran without the {kernel} kernel")
    _require(trace.shape == ref.shape and torch.equal(trace, ref),
             f"kill_and_resume: the resumed trace differs from the uninterrupted one "
             f"({int((trace != ref).sum())} of {ref.numel()} entries)")
    _require(float(ref[-1]) < float(ref[cfg.turbo.n_init // cfg.turbo.batch_size - 1]),
             "kill_and_resume: no improvement on the initial design")
    t = cfg.turbo
    opts = dict(method="turbo1", n_init=t.n_init, max_evals=t.max_evals, batch_size=t.batch_size,
                n_candidates=t.n_candidates, gp_config=cfg.gp, seed=0)

    def f(x):
        return bench.fn(torch.as_tensor(x)).numpy()

    def ask_tell():
        saved = Optimizer(bench.lb, bench.ub, **opts)
        for _ in range(5):
            xs = saved.ask()
            saved.tell(xs, f(xs))
        opt_path = os.path.join(ckpt_dir, "optimizer_turbo1")
        saved.save(opt_path)
        restored = Optimizer(bench.lb, bench.ub, **opts).restore(opt_path)
        return saved.ask(), restored.ask()

    (want, got), _, launches_opt = _counted(torch, CK, ask_tell)
    _require(np.array_equal(want, got), "Optimizer.restore: the next ask differs from the saved optimizer's")
    _emit({"phase": 8, "kill_and_resume": "turbo1_ackley10", "killed_at": kill_at, "checkpoint_every": every,
           "wall_s_uninterrupted": wall_ref, "wall_s_resumed": wall, "resumed_iterations": t.n_iters - kill_at,
           "traces_equal": True, "best_y": float(ref[-1]), "launches_uninterrupted": launches_ref,
           "launches_resumed": launches, "optimizer_restore_same_ask": True, "card": smi})
    return launches


LARGE_N_DIM, LARGE_N_CAND, LARGE_N_Q = 10, 5000, 10
LARGE_N_EI, LARGE_N_TS = 8192, 16384  # the initial designs of phase 9's two loops


def _large_n_loop(torch, CK, smi, label, n_init, iterations, acq, config, **kw):
    """One ``run_bo_distributed`` loop on the port's example objective (d =
    10, 5000 candidates, q = 10) at seed 0, counted: it must launch the
    kernel matrix, keep a finite, non-increasing trace and improve on its
    initial design's best point."""
    from turbojax_torch.bo import BOConfig
    from turbojax_torch.bo_distributed import run_bo_distributed
    from turbojax_torch.examples.run_distributed_bo import objective
    from turbojax_torch.runlog import RunLog

    bo = BOConfig(n_init=n_init, max_evals=n_init + iterations * LARGE_N_Q, batch_size=LARGE_N_Q, acq=acq,
                  n_candidates=LARGE_N_CAND, **kw.pop("bo", {}))
    log = RunLog()

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return run_bo_distributed(objective, [0.0] * LARGE_N_DIM, [1.0] * LARGE_N_DIM, bo, config, runlog=log,
                                  generator=gen, **kw)

    res, wall, launches = _counted(torch, CK, run)
    trace = res.incumbent_trace.tolist()
    init_best = float(res.y_hist[:n_init].min())
    _require(launches["kernel_matrix"] > 0, f"{label} ran without launching the kernel_matrix kernel")
    _require(len(trace) == iterations and all(map(math.isfinite, trace)), f"{label}: incumbent trace {trace}")
    _require(all(b <= a for a, b in zip(trace, trace[1:])), f"{label}: the incumbent trace rises")
    _require(bool(torch.isfinite(res.y_hist).all()) and res.y_hist.shape == (n_init + iterations * LARGE_N_Q,),
             f"{label}: the history is not finite or not of its size")
    _require(float(res.best_y) == trace[-1] < init_best,
             f"{label}: best_y {float(res.best_y)} does not improve on the initial design {init_best}")
    _emit({"phase": 9, "loop": label, "acq": acq, "n_init": n_init, "iterations": iterations, "wall_s": wall,
           "iter_s": [r["iter_s"] for r in log.records], "n": [r["n"] for r in log.records],
           "route": sorted({r["route"] for r in log.records}), "best_y": trace[-1], "init_design_best": init_best,
           "trace": trace, "launches": launches, "card": smi})
    return res, launches


def phase9_large_n(torch, CK, smi):
    """Large-N plain BO at d = 10 and full width (5000 candidates, q = 10):
    (a) the components at N = 4096, 8192 and 16384 (bench_large_n), (b) two
    loops through ``run_bo_distributed``: EI at N = 8192 with the default
    L-BFGS fit every second iteration, and pathwise Thompson sampling at
    N = 16384 with a 5-step Adam fit every iteration, (c) the checkpoint the
    EI loop saved after iteration 2 (what a run killed in iteration 3
    leaves; phase 8 kills a run for real) resumed at iteration 3, off the
    fit cadence: the resumed run refactorizes at the restored hypers (the
    stale-factor trap after a resume), and its trace and history must equal
    the uninterrupted run's bit for bit. A second full L-BFGS run to kill
    would cost a minute of the smoke's time for nothing more."""
    import dataclasses

    from turbojax_torch import bench_large_n as BL
    from turbojax_torch import checkpoint as CKPT
    from turbojax_torch.config import GPConfig

    (rows, wall, launches_a) = _counted(torch, CK, lambda: BL.component_rows(
        smi, emit=lambda row: _emit({"phase": 9, "components": True, **row}), check=_require))
    _require(launches_a["ts_cov"] > 0, "large-N components ran without launching the ts_cov kernel")
    _emit({"phase": 9, "components_wall_s": wall, "launches": launches_a, "card": smi})

    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path, killed = (os.path.join(ckpt_dir, name) for name in ("large_n_ei", "large_n_ei_killed"))
    for base in (path, killed):
        for suffix in (".npz", ".meta.json"):
            if os.path.exists(base + suffix):
                os.remove(base + suffix)
    kill_at = 3  # 3 % fit_every != 0: the resume takes the refactor branch

    def keep_killed(it, best):
        """After iteration ``kill_at`` ran and before its save, the checkpoint
        holds the iterations before it: what a run killed in that iteration
        leaves behind."""
        if it == kill_at:
            for suffix in (".npz", ".meta.json"):
                shutil.copyfile(path + suffix, killed + suffix)

    lbfgs = GPConfig(kernel="matern52")
    ei_kw = dict(bo=dict(fit_every=2))
    ei_label = f"ei_n{LARGE_N_EI}_lbfgs"
    ei, launches_ei = _large_n_loop(torch, CK, smi, ei_label, LARGE_N_EI, 4, "ei", lbfgs, checkpoint_path=path,
                                    checkpoint_every=1, on_iteration=keep_killed, **ei_kw)
    adam5 = dataclasses.replace(lbfgs, fit_optimizer="adam", fit_maxiter=5, fit_restarts=1)
    ts_label = f"ts_pathwise_n{LARGE_N_TS}_adam5"
    _, launches_ts = _large_n_loop(torch, CK, smi, ts_label, LARGE_N_TS, 3, "ts", adam5)

    _require(CKPT.load_meta(killed)["it"] == kill_at, "large-N kill_and_resume: no checkpoint at the kill")
    resumed, launches_resumed = _large_n_loop(torch, CK, smi, ei_label + "_resumed", LARGE_N_EI, 4, "ei", lbfgs,
                                              checkpoint_path=killed, checkpoint_every=1, resume=True, **ei_kw)
    _require(torch.equal(resumed.incumbent_trace, ei.incumbent_trace) and torch.equal(resumed.y_hist, ei.y_hist),
             "large-N kill_and_resume: the resumed run differs from the uninterrupted one")
    _emit({"phase": 9, "kill_and_resume": ei_label, "killed_at": kill_at, "traces_equal": True,
           "histories_equal": True, "card": smi})
    return {"large_n_components": launches_a, f"large_n_{ei_label}": launches_ei, f"large_n_{ts_label}": launches_ts,
            f"large_n_{ei_label}_resumed": launches_resumed}


DIST_D, DIST_N, DIST_N64, DIST_PANEL, DIST_CAND, DIST_Q, DIST_FEATURES = 10, 16384, 4096, 128, 5000, 10, 1024
# the f32 gate of phase 10(a): the distributed route's largest error against
# the dense route in f64 may be at most twice the dense route's own in f32,
# or this share of the reference's largest magnitude (the f32 round-off
# floor); in f64 the two routes agree to rtol 1e-9 (normwise)
DIST_F32_FLOOR, DIST_F64_RTOL = 1e-5, 1e-9
# phase 10(b): the restart-sharded L-BFGS fit against the dense one, on one
# device, by the fitted objective −mll/n. The hypers are not gated: in f32
# the lanes settle apart along the loss's flat directions (a lengthscale or
# the noise saturated at its bound; on the CPU at this width: raw values
# 14.9 against 16.4 at equal losses)
SHARDED_FIT_LOSS_RTOL = 1e-4


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _gate_route(torch, checks, what, dist, dense, exact=None):
    """Phase 10(a)'s gates (see DIST_F32_FLOOR): with ``exact`` (the dense
    route in f64) the f32 gate, without it the f64 one; records the errors
    and the tolerance under ``checks[what]``."""
    dist, dense = dist.double(), dense.double()
    _require(bool(torch.isfinite(dist).all()), f"phase 10 {what}: non-finite values")
    if exact is None:
        err = float((dist - dense).abs().max())
        tol = DIST_F64_RTOL * float(dense.abs().max())
        checks[what] = {"max_abs_err_vs_dense": err, "tol": tol}
    else:
        err, dense_err = (float((v - exact).abs().max()) for v in (dist, dense))
        tol = max(2.0 * dense_err, DIST_F32_FLOOR * float(exact.abs().max()))
        checks[what] = {"max_abs_err_vs_f64_dense": err, "dense_f32_err": dense_err, "tol": tol}
    _require(err <= tol, f"phase 10 {what}: error {err:.3e} above the tolerance {tol:.3e}")


def _phase10_primitives(torch, CK, mesh, dtype, n):
    """(a) At d = 10, N = ``n``, 5000 candidates, q = 10, panels of 128 and
    the default hypers: the row-sharded factorization (``DistributedGP``
    through ``refactor_gp_auto``'s assembly), its posterior, MLL and
    pathwise paths, and ``fit_distributed_gp``'s 5 Adam steps, each against
    the dense route on the same inputs and draws. Returns (launches of the
    distributed calls, checks, walls)."""
    import dataclasses

    from turbojax_torch import acq as A
    from turbojax_torch import bench_large_n as BL
    from turbojax_torch import distributed_linalg as DL
    from turbojax_torch import gp as G
    from turbojax_torch.config import GPConfig

    gen = torch.Generator(device="cuda").manual_seed(10)
    x, y, mask, cands = BL.problem(n, gen, DIST_D, DIST_CAND)
    x, y, cands = x.to(dtype), y.to(dtype), cands.to(dtype)
    config = GPConfig(kernel="matern52")
    adam5 = dataclasses.replace(config, fit_optimizer="adam", fit_maxiter=5, fit_restarts=1)
    raw = G.default_params(DIST_D, config, dtype, "cuda")
    omega, b = A.rff_frequencies(DIST_D, DIST_FEATURES, "matern52", gen, dtype, "cuda")
    draws = A.Draws(omega=omega, b=b, weights=torch.randn((DIST_Q, DIST_FEATURES), generator=gen, dtype=dtype,
                                                         device="cuda"),
                    eps=torch.randn((DIST_Q, n), generator=gen, dtype=dtype, device="cuda"))
    launches, walls = {}, {}

    def counted(label, fn):
        out, wall, counts = _counted(torch, CK, fn)
        _add_launches(launches, counts)
        walls[label] = wall
        return out

    dgp = counted("factor_s", lambda: DL._assemble_distributed_gp(x, y, raw, config, mesh, DIST_PANEL))
    mu_d, var_d = counted("posterior_s", lambda: dgp.posterior(cands))
    mll_d = counted("mll_s", dgp.mll)
    paths_d = counted("pathwise_s", lambda: DL.distributed_pathwise_paths(dgp, cands, DIST_Q, DIST_FEATURES,
                                                                         draws=draws))
    fit_d = counted("fit_adam5_s", lambda: DL.fit_distributed_gp(x, y, mesh, adam5, DIST_PANEL))
    del dgp

    def dense(xx, yy, cc, rr, dd):
        state = G.make_gp_state(xx, yy, mask, rr, config)
        mu, var = G.gp_posterior(state, cc, config)
        out = {"mu": mu, "var": var, "mll": DL._adapt_dense(state, yy, mask, config).mll(),
               "paths": A.pathwise_paths(state, cc, DIST_Q, config, DIST_FEATURES, draws=dd)}
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["fit"] = G.fit_gp(xx, yy, mask, adam5).raw
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ref, walls["dense_fit_adam5_s"] = dense(x, y, cands, raw, draws)
    got = {"mu": mu_d, "var": var_d, "mll": mll_d, "paths": paths_d, "fit": fit_d.raw}
    checks = {}
    if dtype == torch.float32:
        draws64 = A.Draws(**{k: None if v is None else v.double() for k, v in draws._asdict().items()})
        exact, _ = dense(x.double(), y.double(), cands.double(), G.GPParams(*(v.double() for v in raw)), draws64)
    for key in got:
        if key == "fit":
            flat = [torch.cat([v.reshape(-1) for v in r[key]]) for r in (got, ref)]
            ex = torch.cat([v.reshape(-1) for v in exact[key]]) if dtype == torch.float32 else None
            _gate_route(torch, checks, "fit_adam5_raw", *flat, ex)
        else:
            _gate_route(torch, checks, key, got[key], ref[key], exact[key] if dtype == torch.float32 else None)
    return launches, checks, walls


def _phase10_parallel(torch, CK, mesh):
    """(b) ``sharded_acq_topq`` (EI, q = 10) at N = 2000 over 40000
    candidates, above ``CAND_SHARD_MIN``, against the dense top-q (on one
    device the same arithmetic: bitwise); ``sharded_fit_gp`` at config 2's
    width (``hartmann6_lbfgs``: 112 points, d = 6, four L-BFGS restarts)
    against ``gp.fit_gp`` from the same restart draws. Returns ({part:
    launches}, checks)."""
    from turbojax_torch import acq as A
    from turbojax_torch import bench_large_n as BL
    from turbojax_torch import benchmarks as B
    from turbojax_torch import gp as G
    from turbojax_torch import parallel as PAR
    from turbojax_torch import registry as R
    from turbojax_torch import sampling as S
    from turbojax_torch import transforms as T
    from turbojax_torch.bo import lowest_k
    from turbojax_torch.bo_distributed import CAND_SHARD_MIN
    from turbojax_torch.config import GPConfig

    gen = torch.Generator(device="cuda").manual_seed(11)
    config = GPConfig(kernel="matern52")
    x, y, mask, _ = BL.problem(2000, gen)
    cands = torch.rand((40000, DIST_D), generator=gen, device="cuda")
    _require(cands.shape[0] >= CAND_SHARD_MIN, "phase 10(b): below CAND_SHARD_MIN")
    state = G.make_gp_state(x, y, mask, G.default_params(DIST_D, config, torch.float32, "cuda"), config)
    best = y.min()
    (pts, scores), _, l_acq = _counted(torch, CK, lambda: PAR.sharded_acq_topq(state, cands, best, DIST_Q, mesh,
                                                                               config, "ei"))
    mu, var = G.gp_posterior(state, cands, config)
    dense_scores = -A.expected_improvement(mu, var, best)
    idx = lowest_k(dense_scores, DIST_Q)
    _require(torch.equal(pts, cands[idx]) and torch.equal(scores, dense_scores[idx]),
             "phase 10(b): sharded_acq_topq differs from the dense top-q")
    checks = {"acq_topq_equal_to_dense": True, "candidates": cands.shape[0], "n": x.shape[0]}

    c2 = R.get_config("hartmann6_lbfgs")
    bench = B.get_benchmark(c2.benchmark)
    lb = torch.tensor(bench.lb, device="cuda")
    ub = torch.tensor(bench.ub, device="cuda")
    xs = S.latin_hypercube(c2.bo.max_evals, bench.dim, gen, torch.float32, "cuda")
    ys = bench.fn(T.from_unit_cube(xs, lb, ub)).to(torch.float32)
    mask2 = torch.ones(xs.shape[0], dtype=torch.bool, device="cuda")
    sharded, _, l_fit = _counted(torch, CK, lambda: PAR.sharded_fit_gp(
        xs, ys, mask2, c2.gp, mesh, generator=torch.Generator(device="cuda").manual_seed(13)))
    dense = G.fit_gp(xs, ys, mask2, c2.gp, generator=torch.Generator(device="cuda").manual_seed(13))
    y_std, _, _ = T.standardize(ys, mask2)
    loss_sh, loss_dn = (float(-G.mll(st.raw, xs, y_std, mask2, c2.gp)) / xs.shape[0] for st in (sharded, dense))
    err = abs(loss_sh - loss_dn)
    tol = SHARDED_FIT_LOSS_RTOL * max(1.0, abs(loss_dn))
    _require(err <= tol, f"phase 10(b): sharded_fit_gp's loss {loss_sh} against the dense fit's {loss_dn}")
    ls_sh, ls_dn = (G.constrain_params(st.raw, c2.gp)["lengthscale"] for st in (sharded, dense))
    checks["sharded_fit_loss"] = {"loss": loss_sh, "dense_loss": loss_dn, "abs_err": err, "tol": tol,
                                  "lengthscale_max_rel_diff": float(((ls_sh - ls_dn).abs() / ls_dn).max()),
                                  "restarts": c2.gp.fit_restarts, "n": xs.shape[0], "d": bench.dim}
    for kernel in ("kernel_matrix",):
        _require(l_acq[kernel] > 0 and l_fit[kernel] > 0, f"phase 10(b) ran without launching the {kernel} kernel")
    return {"mesh_acq_topq": l_acq, "mesh_sharded_fit": l_fit}, checks


def _phase10_loops(torch, CK, smi, mesh):
    """(c) ``optimize(method="turbom", mesh=mesh)`` at config 5's width (m =
    5, rover-60, 5000 candidates per region, TS chunks of 1000, its GP),
    400 evaluations; (d) ``optimize(method="bo", mesh=mesh)`` on Branin (30
    evaluations, q = 2, EI) with ``budget_bytes=1``, and the same loop
    through ``run_bo_distributed`` with a run log: on one device every
    iteration takes the dense route."""
    from turbojax_torch import benchmarks as B
    from turbojax_torch import optimize
    from turbojax_torch import registry as R
    from turbojax_torch.bo import BOConfig
    from turbojax_torch.bo_distributed import run_bo_distributed
    from turbojax_torch.runlog import RunLog
    from turbojax_torch.trust_region import TurboConfig

    c5 = R.get_config("turbom5_rover60")
    t = c5.turbo
    bench = B.get_benchmark(c5.benchmark)
    evals = 400
    res, wall, l_tm = _counted(torch, CK, lambda: optimize(
        bench.fn, bench.lb, bench.ub, evals, method="turbom", m=c5.m, n_init=t.n_init, batch_size=t.batch_size,
        gp_config=c5.gp, tr_config=t.tr, fit_every=t.fit_every, n_candidates=t.n_candidates, ts_chunk=t.ts_chunk,
        seed=0, mesh=mesh))
    iterations = TurboConfig(n_init=t.n_init, max_evals=evals, batch_size=t.batch_size).n_iters
    init_best = float(res.incumbent_trace[c5.m * t.n_init // t.batch_size - 1])
    _check_run("turbom5_rover60 on the mesh", res, l_tm, init_best, iterations)
    _emit({"phase": 10, "part": "c", "config": "turbom5_rover60", "mesh": mesh.size, "evals": len(res.y_hist),
           "wall_s": wall, "best_y": res.best_y, "init_design_best": init_best, "launches": l_tm, "card": smi})

    branin = B.get_benchmark("branin")
    kw = dict(n_init=10, max_evals=30, batch_size=2, acq="ei", n_candidates=2000)
    res, wall, l_bo = _counted(torch, CK, lambda: optimize(branin.fn, branin.lb, branin.ub, kw["max_evals"],
                                                           method="bo", seed=0, mesh=mesh, budget_bytes=1,
                                                           **{k: v for k, v in kw.items() if k != "max_evals"}))
    _check_run("branin bo on the mesh", res, l_bo, float(res.y_hist[:kw["n_init"]].min()),
               BOConfig(**kw).n_iters, ("kernel_matrix",))
    log = RunLog()
    run_bo_distributed(branin.fn, branin.lb, branin.ub, BOConfig(**kw), mesh=mesh, budget_bytes=1, runlog=log,
                       generator=torch.Generator(device="cuda").manual_seed(0))
    routes = sorted({r["route"] for r in log.records})
    _require(routes == ["dense"], f"phase 10(d): a mesh of one device took the routes {routes}")
    _emit({"phase": 10, "part": "d", "benchmark": "branin", "mesh": mesh.size, "evals": len(res.y_hist),
           "wall_s": wall, "best_y": res.best_y, "routes": routes, "launches": l_bo, "card": smi})
    return {"mesh_turbom5_rover60": l_tm, "mesh_bo_branin": l_bo}


def phase10_mesh(torch, CK, smi):
    """Phase 10: the multi-device modules on a mesh of one device, an NCCL
    process group of this process alone (a ``FileStore`` under
    ``build/chip_smoke/``, ``device_id`` cuda:0), destroyed at the end:
    (a) ``_phase10_primitives`` at N = 16384 in f32 and, the exactness
    check, at N = 4096 in f64; (b) ``_phase10_parallel``; (c) and (d)
    ``_phase10_loops``. Returns {part: launches}."""
    import tempfile

    import torch.distributed as dist

    from turbojax_torch import parallel as PAR

    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    store_dir = tempfile.mkdtemp(dir=ckpt_dir)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = PAR.make_mesh(axis="rows")
        _require(mesh.size == 1 and mesh.device == torch.device("cuda", 0) and dist.get_backend() == "nccl",
                 f"phase 10: the mesh is {mesh}")
        PAR.barrier(mesh)  # NCCL sets its communicator up at the first collective: not inside a timed call
        paths = {}
        for dtype, n in ((torch.float32, DIST_N), (torch.float64, DIST_N64)):
            launches, checks, walls = _phase10_primitives(torch, CK, mesh, dtype, n)
            label = f"mesh_primitives_{str(dtype)[6:]}_n{n}"
            _require(launches["kernel_matrix"] > 0, f"{label} ran without launching the kernel_matrix kernel")
            paths[label] = launches
            _emit({"phase": 10, "part": "a", "dtype": str(dtype)[6:], "n": n, "d": DIST_D, "candidates": DIST_CAND,
                   "q": DIST_Q, "panel": DIST_PANEL, "checks": checks, "walls_s": walls, "launches": launches,
                   "card": smi})
            torch.cuda.empty_cache()
        launches, checks = _phase10_parallel(torch, CK, mesh)
        paths.update(launches)
        _emit({"phase": 10, "part": "b", "checks": checks, "launches": launches, "card": smi})
        paths.update(_phase10_loops(torch, CK, smi, mesh))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    _emit({"phase": 10, "wall_s": time.perf_counter() - t0, "card": smi})
    return paths


def main() -> int:
    import torch

    smi = phase0_device(torch)
    from turbojax_torch import cuda_kernels as CK

    phase1_build(CK)
    max_err, ts_err = phase2_parity(torch, CK)
    km_lines, ts_lines = phase3_timings(smi)
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
    for label, name, options in (
        ("turbo1_ackley10_f64", "turbo1_ackley10", dict(ts_dtype="float64")),
        ("turbo1_ackley10_rff", "turbo1_ackley10", dict(ts_sampler="rff")),
        ("turbo1_ackley10_pathwise", "turbo1_ackley10", dict(ts_sampler="pathwise")),
        ("turbom5_rover60_pathwise", "turbom5_rover60", dict(ts_sampler="pathwise", max_evals=600)),
        ("turbom5_rover60_local_frac", "turbom5_rover60", dict(local_frac=0.3, max_evals=400)),
        ("turbom5_rover60_fit_every2", "turbom5_rover60", dict(fit_every=2, max_evals=400)),
    ):
        paths[label] = phase_config(torch, CK, smi, 8, name, **options)
    paths["turbo1_ackley10_resumed"] = phase8_kill_and_resume(torch, CK, smi)
    paths["turbom5_rover60_f64"] = phase_config(torch, CK, smi, 8, "turbom5_rover60", ts_dtype="float64",
                                                max_evals=400)
    paths.update(phase9_large_n(torch, CK, smi))
    paths.update(phase10_mesh(torch, CK, smi))
    entries = []
    keys = ("shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    for name, source, replaces, err, (line, f64_line, large_line) in (
        ("kernel_matrix", "turbojax_torch/csrc/kernel_matrix.cu", "turbojax/pallas_kernels.py:72", max_err, km_lines),
        ("ts_cov", "turbojax_torch/csrc/ts_cov.cu", "turbojax/pallas_kernels.py:194", ts_err, ts_lines),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths["turbom5_rover60"][name],
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "launches_f64_by_path": {path: counts[f"{name}_f64"] for path, counts in paths.items()
                                     if counts[f"{name}_f64"]},
            "max_abs_err": err, "ms": line["kernel_ms"], "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"], "device_ms": line["device_ms"],
            "shape": line["shape"],
            "f64": {k: f64_line[k] for k in keys},
            "large_n": {k: large_line[k] for k in keys},
        })
    _emit({"kernels": entries})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
