"""The registered configurations on one GPU: regret over seeds for any of
them, a profiler split of one late iteration of config 5
(``turbom5_rover60``), and the device's busy share over one whole run.

    python -m turbojax_torch.profile_config5 --seeds 0 1 2
    python -m turbojax_torch.profile_config5 --config turbo1_ackley10 --seeds 0 1 2 3 4 5 6 7 8 9
    python -m turbojax_torch.profile_config5 --config branin_ei --seeds 0 1 2 3 4 --profile-run
    python -m turbojax_torch.profile_config5 --profile-iteration 150
    python -m turbojax_torch.profile_config5 --seeds 0 1 2 --ts-sampler pathwise
    python -m turbojax_torch.profile_config5 --config turbo1_ackley10 --seeds 0 --ts-dtype float64

``--seeds`` runs the full configuration (``--config``, config 5 unless
given) once per seed through ``optimize``, as ``chip_smoke.py`` does, and
prints one JSON line each (best_y, regret, wall, kernel launches, f64
launches among them), then the median regret and best_y. The TuRBO
options ``--ts-sampler``, ``--ts-dtype``, ``--local-frac``, ``--fit-every``
and ``--max-evals`` (the names of ``benchmarks/campaign_rover.py``) change
the configuration's loop settings; the run then goes through
``run_turbo1``/``run_turbom`` with the changed ``TurboConfig``.
``--profile-iteration K`` runs config 5's seed 0 (with the TuRBO options
above) up to iteration K and traces iteration K with ``torch.profiler``;
``--profile-run`` traces one whole run of ``--config`` (seed 0, after an
untraced run; meant for the short configurations). Either prints the
trace's split by ``portbench/trace.py``, the benchmark's recipe: the
window, the device's busy time (the union of the device operations'
intervals) and idle share, the device operations that took most time and
the idle gaps by host operation (the ledger's ``breakdown``), the polish
backward's device time (launched under ``gp.polish_backward``) and the
host time inside each span the trace holds (``runlog.span``). Every line
carries the card's ``nvidia-smi`` name and power limit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from turbojax_torch import benchmarks as B
from turbojax_torch import cuda_kernels as CK
from turbojax_torch import kernel_bench as KB
from turbojax_torch import registry as R
from turbojax_torch import turbo_m as TM
from turbojax_torch.runlog import span


class _Stop(Exception):
    """Ends a run right after the traced iteration."""


def _run(seed: int, on_iteration=None, **turbo_options):
    cfg = R.get_config("turbom5_rover60")
    bench = B.get_benchmark(cfg.benchmark)
    generator = torch.Generator(device="cuda").manual_seed(seed)
    return TM.run_turbom(bench.fn, bench.lb, bench.ub, dataclasses.replace(cfg.turbo, **turbo_options), cfg.gp, cfg.m,
                         generator, on_iteration=on_iteration), bench


ACQ_ONLY_N, ACQ_ONLY_N_MAX = 2000, 2048  # config 3's training set: 2000 points in a 2048-row buffer


def run_config(name: str, seed: int, device: str = "cuda", chol_mode: Optional[str] = None, **turbo_options):
    """One full run of a registered configuration through the entry point a
    user would call: ``optimize`` for the TuRBO methods, ``run_bo`` for plain
    BO (with the default hypers pinned when the configuration never refits;
    ``chol_mode`` overrides the configuration's), and for the
    acquisition-only configuration one ``bo._suggest`` over a carry of
    ``ACQ_ONLY_N`` uniform points of the benchmark at the default hypers: the
    result then holds the q selected points, their values and a one-entry
    trace. ``turbo_options`` (``TurboConfig`` fields such as ``ts_sampler``,
    ``ts_dtype``, ``local_frac``, ``fit_every``, ``max_evals``) change a
    TuRBO configuration's loop settings, which ``optimize`` does not take:
    the run then goes through ``run_turbo1``/``run_turbom``. Returns
    (result, benchmark)."""
    from turbojax_torch import api, optimize
    from turbojax_torch import bo as BO
    from turbojax_torch import gp as G
    from turbojax_torch import linalg as L
    from turbojax_torch import transforms as T
    from turbojax_torch import trust_region as TR

    cfg = R.get_config(name)
    bench = B.get_benchmark(cfg.benchmark)
    if cfg.method in ("turbo1", "turbom"):
        t = cfg.turbo
        if turbo_options:
            t = dataclasses.replace(t, **turbo_options)
            generator = torch.Generator(device=device).manual_seed(seed)
            if cfg.method == "turbom":
                carries, trace = TM.run_turbom(bench.fn, bench.lb, bench.ub, t, cfg.gp, cfg.m, generator)
            else:
                carries, trace = TR.run_turbo1(bench.fn, bench.lb, bench.ub, t, cfg.gp, generator)
            return api.turbo_result(carries, trace, bench.lb, bench.ub), bench
        res = optimize(bench.fn, bench.lb, bench.ub, t.max_evals, method=cfg.method, m=cfg.m, n_init=t.n_init,
                       batch_size=t.batch_size, n_candidates=t.n_candidates, ts_chunk=t.ts_chunk, gp_config=cfg.gp,
                       seed=seed, device=device)
        return res, bench
    if turbo_options:
        raise ValueError(f"{name} is not a TuRBO configuration: {sorted(turbo_options)} do not apply")
    generator = torch.Generator(device=device).manual_seed(seed)
    bo = cfg.bo if chol_mode is None else dataclasses.replace(cfg.bo, chol_mode=chol_mode)
    if cfg.method == "bo":
        fixed = G.default_params(bench.dim, cfg.gp, torch.float32, device) if bo.fit_every == 0 else None
        return api.bo_result(BO.run_bo(bench.fn, bench.lb, bench.ub, bo, cfg.gp, generator, fixed_params=fixed)), bench
    # acquisition only: the posterior cache is built once, the suggestion is the run
    lb_t, ub_t = (torch.tensor(v, device=device) for v in (bench.lb, bench.ub))
    x_buf = torch.zeros((ACQ_ONLY_N_MAX, bench.dim), device=device)
    y_buf = torch.zeros((ACQ_ONLY_N_MAX,), device=device)
    x_buf[:ACQ_ONLY_N] = torch.rand((ACQ_ONLY_N, bench.dim), generator=generator, device=device)
    y_buf[:ACQ_ONLY_N] = bench.fn(T.from_unit_cube(x_buf[:ACQ_ONLY_N], lb_t, ub_t))
    state = G.make_gp_state(x_buf, y_buf, L.row_mask(ACQ_ONLY_N_MAX, ACQ_ONLY_N, device),
                            G.default_params(bench.dim, cfg.gp, torch.float32, device), cfg.gp)
    carry = BO.BOCarry(x_buf=x_buf, y_buf=y_buf, n=ACQ_ONLY_N, chol=state.chol, raw=state.raw,
                       y_mean=state.y_mean, y_std=state.y_std)
    xs = T.from_unit_cube(BO._suggest(carry, cfg.gp, bo, generator), lb_t, ub_t)
    ys = bench.fn(xs)
    best = int(torch.argmin(ys))
    res = api.Result(best_x=xs[best].cpu().numpy(), best_y=float(ys[best]), x_hist=xs.cpu().numpy(),
                     y_hist=ys.cpu().numpy(), incumbent_trace=ys.min().reshape(1).cpu().numpy())
    return res, bench


def regret_over_seeds(name: str, seeds: List[int], card: str, **turbo_options) -> float:
    regrets = []
    for seed in seeds:
        torch.cuda.synchronize()
        CK.LAUNCHES = CK.TS_COV_LAUNCHES = CK.LAUNCHES_F64 = CK.TS_COV_LAUNCHES_F64 = 0
        t0 = time.perf_counter()
        res, bench = run_config(name, seed, **turbo_options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        regrets.append(res.best_y - bench.optimum)
        print(json.dumps({"config": name, "options": turbo_options, "seed": seed, "best_y": res.best_y,
                          "regret": regrets[-1], "wall_s": wall, "evaluations": len(res.y_hist),
                          "iterations": len(res.incumbent_trace),
                          "launches": {"kernel_matrix": CK.LAUNCHES, "ts_cov": CK.TS_COV_LAUNCHES},
                          "launches_f64": {"kernel_matrix": CK.LAUNCHES_F64, "ts_cov": CK.TS_COV_LAUNCHES_F64},
                          "card": card}), flush=True)
    median = float(np.median(regrets))
    print(json.dumps({"config": name, "options": turbo_options, "seeds": seeds, "median_regret": median,
                      "median_best_y": median + bench.optimum, "card": card}), flush=True)
    return median


def _report(trace) -> dict:
    """A trace's split by ``portbench/trace.py``, the benchmark's own
    recipe: the device's busy time (the union of the device operations'
    intervals) over the window, the device operations that took most time
    and the idle gaps by host operation (the ledger's ``breakdown``), the
    polish backward's device time (launched under ``gp.polish_backward``,
    as ``fit_backward_ms`` reads it) and the host time inside each span."""
    from portbench import trace as PT

    busy, window = PT.busy_s(trace), PT.window_s(trace)
    host_ms = {}
    for sp in trace.spans:
        host_ms[sp.name] = host_ms.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e6
    return {"window_s": window, "busy_s": busy, "device_idle_share": 1.0 - busy / window,
            "breakdown": PT.breakdown(trace),
            "polish_backward_device_s": PT.device_s(PT.launched_under(trace, "gp.polish_backward")),
            "host_ms_by_span": host_ms}


def profile_iteration(k: int, card: str, trace_path: Optional[str] = None, **turbo_options) -> None:
    """Trace iteration ``k`` of seed 0 and print its ``_report``;
    ``trace_path`` also writes the Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as PT

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = contextlib.ExitStack()

    def on_iteration(it: int, best: torch.Tensor) -> None:
        if it == k - 1:
            torch.cuda.synchronize()
            prof.start()
            window.enter_context(span(PT.WINDOW_SPAN))
        elif it == k:
            torch.cuda.synchronize()
            window.close()
            prof.stop()
            raise _Stop

    try:
        _run(0, on_iteration, **turbo_options)
    except _Stop:
        pass
    print(json.dumps({"profiled_iteration": k, "options": turbo_options, **_report(PT.collect(prof)), "card": card}),
          flush=True)
    if trace_path:
        prof.export_chrome_trace(trace_path)


def profile_run(name: str, card: str) -> None:
    """Trace one whole run of a configuration (seed 0) after an untraced
    one and print its ``_report``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as PT

    run_config(name, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span(PT.WINDOW_SPAN):
            run_config(name, 0)
            torch.cuda.synchronize()
    print(json.dumps({"profiled_run": name, **_report(PT.collect(prof)), "card": card}), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="turbom5_rover60", choices=sorted(R.CONFIGS))
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--profile-iteration", type=int, default=None)
    ap.add_argument("--trace", default=None, help="write the traced iteration's Chrome trace here")
    ap.add_argument("--profile-run", action="store_true", help="trace one whole run of --config")
    ap.add_argument("--ts-sampler", default=None, choices=["exact", "rff", "pathwise"])
    ap.add_argument("--ts-dtype", default=None, choices=["float64"])
    ap.add_argument("--local-frac", type=float, default=None)
    ap.add_argument("--fit-every", type=int, default=None)
    ap.add_argument("--max-evals", type=int, default=None, help="cut the run's depth")
    args = ap.parse_args(argv)
    options = {k: v for k, v in (("ts_sampler", args.ts_sampler), ("ts_dtype", args.ts_dtype),
                                 ("local_frac", args.local_frac), ("fit_every", args.fit_every),
                                 ("max_evals", args.max_evals)) if v is not None}
    if not torch.cuda.is_available():
        raise RuntimeError("profile_config5 measures the card: torch.cuda.is_available() is False")
    card = KB.card()
    if args.profile_iteration is not None:
        profile_iteration(args.profile_iteration, card, args.trace, **options)
    if args.profile_run:
        profile_run(args.config, card)
    if args.seeds:
        regret_over_seeds(args.config, args.seeds, card, **options)
    return 0


if __name__ == "__main__":
    sys.exit(main())
