"""Config 5 (``turbom5_rover60``) on one GPU: regret over seeds, and a
profiler split of one late iteration; config 4 (``turbo1_ackley10``) over
seeds too.

    python -m turbojax_torch.profile_config5 --seeds 0 1 2
    python -m turbojax_torch.profile_config5 --config turbo1_ackley10 --seeds 0 1 2 3 4 5 6 7 8 9
    python -m turbojax_torch.profile_config5 --profile-iteration 150

``--seeds`` runs the full configuration (``--config``, config 5 unless
given) once per seed through ``optimize``, as ``chip_smoke.py`` does, and
prints one JSON line each (best_y, regret, wall, kernel launches), then the
median regret and best_y.
``--profile-iteration K`` runs config 5's seed 0 up to iteration K, traces
iteration K with ``torch.profiler`` and prints its split: the device's busy
time and idle share, device time by kernel family (Cholesky, triangular
solves, GEMM, the two hand-written kernels), the polish backward's device
time, and the host time inside the fit, polish-backward, Thompson and
TS-covariance spans. Every line carries the card's ``nvidia-smi`` name and
power limit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from turbojax_torch import benchmarks as B
from turbojax_torch import cuda_kernels as CK
from turbojax_torch import registry as R
from turbojax_torch import turbo_m as TM

_SPANS = ("turbom.fit", "gp.polish_backward", "turbom.thompson", "gp.ts_cov")
_FAMILIES = {  # kernel-name fragment -> family
    "ts_cov_partial": "ts_cov kernel", "ts_cov_finish": "ts_cov kernel", "kernel_matrix_tile": "kernel_matrix kernel",
    "potrf": "Cholesky", "cholesky": "Cholesky", "trsm": "triangular solve",
    "gemm": "GEMM", "gemv": "GEMM",
}


class _Stop(Exception):
    """Ends a run right after the traced iteration."""


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _run(seed: int, on_iteration=None):
    cfg = R.get_config("turbom5_rover60")
    bench = B.get_benchmark(cfg.benchmark)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    return TM.run_turbom(bench.fn, bench.lb, bench.ub, cfg.turbo, cfg.gp, cfg.m, generator,
                         on_iteration=on_iteration), bench


def run_config(name: str, seed: int, device: str = "cuda"):
    """One full run of a registered configuration through ``optimize``;
    returns (result, benchmark)."""
    from turbojax_torch import optimize

    cfg = R.get_config(name)
    bench = B.get_benchmark(cfg.benchmark)
    t = cfg.turbo
    res = optimize(bench.fn, bench.lb, bench.ub, t.max_evals, method=cfg.method, m=cfg.m, n_init=t.n_init,
                   batch_size=t.batch_size, n_candidates=t.n_candidates, ts_chunk=t.ts_chunk, gp_config=cfg.gp,
                   seed=seed, device=device)
    return res, bench


def regret_over_seeds(name: str, seeds: List[int], card: str) -> float:
    regrets = []
    for seed in seeds:
        torch.cuda.synchronize()
        CK.LAUNCHES = CK.TS_COV_LAUNCHES = 0
        t0 = time.perf_counter()
        res, bench = run_config(name, seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        regrets.append(res.best_y - bench.optimum)
        print(json.dumps({"config": name, "seed": seed, "best_y": res.best_y, "regret": regrets[-1], "wall_s": wall,
                          "evaluations": len(res.y_hist), "iterations": len(res.incumbent_trace),
                          "launches": {"kernel_matrix": CK.LAUNCHES, "ts_cov": CK.TS_COV_LAUNCHES},
                          "card": card}), flush=True)
    median = float(np.median(regrets))
    print(json.dumps({"config": name, "seeds": seeds, "median_regret": median,
                      "median_best_y": median + bench.optimum, "card": card}), flush=True)
    return median


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_iteration(k: int, card: str, trace_path: Optional[str] = None) -> None:
    """Trace iteration ``k`` of seed 0. Reported: its wall; the device's busy
    time (the kernels' own time) and idle share; device time by kernel
    family; the polish backward's device time (the autograd engine's
    nodes, which run on the engine's thread); and the host time inside each
    span (where the wall goes while the host binds). ``trace_path`` also
    writes the Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_iteration(it: int, best: torch.Tensor) -> None:
        if it == k - 1:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif it == k:
            torch.cuda.synchronize()
            marks["wall"] = time.perf_counter() - marks["t0"]
            prof.stop()
            raise _Stop

    try:
        _run(0, on_iteration)
    except _Stop:
        pass
    wall_ms = marks["wall"] * 1e3
    host_ms, families, busy_ms, backward_ms = {}, {}, 0.0, 0.0
    for evt in prof.events():  # the spans' host time, on the CPU timeline
        if evt.device_type == torch.autograd.DeviceType.CPU and evt.name.startswith(_SPANS):
            host_ms[evt.name] = host_ms.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    for evt in prof.key_averages():
        if evt.key.startswith("autograd::engine::evaluate_function"):
            backward_ms += _device_us(evt) / 1e3
        own = _self_device_us(evt) / 1e3
        # device-side entries (the kernels, copies and sets) have no CPU time;
        # the spans' device-timeline annotations are not work
        if own > 0 and evt.cpu_time_total == 0 and not evt.key.startswith(_SPANS):
            busy_ms += own
            name = evt.key.lower()
            fam = next((f for frag, f in _FAMILIES.items() if frag in name), "elementwise and other")
            families[fam] = families.get(fam, 0.0) + own
    print(json.dumps({
        "profiled_iteration": k, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ms_by_kernel_family": families,
        "polish_backward_device_ms": backward_ms, "host_ms_by_span": host_ms, "card": card,
    }), flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30), flush=True)
    if trace_path:
        prof.export_chrome_trace(trace_path)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="turbom5_rover60", choices=sorted(R.CONFIGS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--profile-iteration", type=int, default=None)
    ap.add_argument("--trace", default=None, help="write the traced iteration's Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_config5 measures the card: torch.cuda.is_available() is False")
    card = _card()
    if args.profile_iteration is not None:
        profile_iteration(args.profile_iteration, card, args.trace)
    if args.seeds:
        regret_over_seeds(args.config, args.seeds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
