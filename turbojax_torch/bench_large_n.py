"""Large-N plain BO on one GPU: the dense exact GP's components at the sizes
of ``benchmarks/bench_large_n.py`` (N = 4096, 8192 and 16384 training
points, d = 10, 5000 candidates, q = 10), timed on the card.

    python3 -m turbojax_torch.bench_large_n [--ns 4096 8192 16384] [--reps 3]
    python3 -m turbojax_torch.bench_large_n --rules
    python3 -m turbojax_torch.bench_large_n --budget

Rows per N, Matérn-5/2 at the default hypers (one JSON line per N):

    state_build        gp.make_gp_state (K(X, X) through the kernel, the
                       jitter ladder's Cholesky, α)
    posterior_5k       gp.gp_posterior over the candidates in chunks of 1000
    posterior_5k_auto  the same with chunk_size=None (the auto-chunk rule)
    ts_q10_5k          acq.thompson_select, the exact sampler, q = 10, chunks
                       of 1000 (ts_cov at n = N)
    pathwise_q10_5k    acq.pathwise_paths, q = 10 paths, 1024 features
    adam_fit5          gp.fit_gp: 5 Adam steps, one restart
    grid_fit           gp.fit_gp with the 15-row grid, in the branch that
                       gp.grid_rows_batched picks

Each row: the median wall of ``reps`` warm calls, each ended by
``torch.cuda.synchronize()`` (one call before them warms up), and the peak
of ``torch.cuda.max_memory_allocated`` over those calls in GiB (the inputs
and the cached state included).

One traced pathwise-loop iteration at N = 16384 (5-step Adam refit, q = 10)
is the benchmark's traced cell: ``python3 -m portbench.run --workload
bo_ackley10_16k.refit --seed <n> --seconds 30 --trace 1``.

``--budget`` measures the peak device memory of the default dense fit
(L-BFGS, 4 restarts; one iteration, whose loss evaluations all have the
fit's working set) at each N, beside the 3 N² · 4 bytes the multi-device
routing rule counts (``distributed_linalg.DENSE_BUDGET_BYTES``).

``--rules`` measures the two TPU-sized constants these sizes meet: the grid
fit in both branches (rows as one batch and one after another) at N = 1024, 2048,
4096, 8192 and 16384, and ``gp_posterior`` in chunks of 1000 and unchunked
over 5000 candidates at N = 8192 and 16384 and over 16000, 24000 and 40000
at N = 16384 (cross matrices of 0.16 to 2.6 GB, either side of the
auto-chunk rule); a branch that runs out of device memory is reported as
such. Every line carries the card's ``nvidia-smi`` name and
power limit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from turbojax_torch import acq as A
from turbojax_torch import gp as G
from turbojax_torch import linalg as L
from turbojax_torch.config import GPConfig

NS = (4096, 8192, 16384)
DIM, N_CAND, Q, TS_CHUNK = 10, 5000, 10, 1000
CONFIG = GPConfig(kernel="matern52")
ADAM5 = dataclasses.replace(CONFIG, fit_optimizer="adam", fit_maxiter=5, fit_restarts=1)
GRID = dataclasses.replace(CONFIG, fit_optimizer="grid")
RULE_GRID_NS = (1024, 2048, 4096, 8192, 16384)
# (N, candidates): the cross matrix from 0.16 to 2.6 GB, across the 1 GiB rule
RULE_POSTERIOR_CASES = ((8192, 5000), (16384, 5000), (16384, 16000), (16384, 24000), (16384, 40000))
_GIB = float(2**30)


def problem(n: int, gen: torch.Generator, d: int = DIM, n_cand: int = N_CAND):
    """x uniform in the unit cube, y = sin(3 x₀) + 0.1·noise, the candidates
    uniform (``benchmarks/bench_large_n.py``'s problem), on the generator's
    device in float32."""
    dev = gen.device
    x = torch.rand((n, d), generator=gen, device=dev)
    y = torch.sin(3.0 * x[:, 0]) + 0.1 * torch.randn(n, generator=gen, device=dev)
    cands = torch.rand((n_cand, d), generator=gen, device=dev)
    return x, y, L.row_mask(n, n, dev), cands


def timed(fn: Callable[[], object], reps: int) -> Tuple[float, float, object]:
    """(median wall s of ``reps`` synchronized warm calls, their peak device
    memory in GiB, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2], torch.cuda.max_memory_allocated() / _GIB, out


def _finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out).all())
    if isinstance(out, G.GPState):
        return _finite(out.chol) and _finite(out.alpha)
    return all(_finite(o) for o in out)


def component_rows(smi: str, ns: Sequence[int] = NS, reps: int = 3, check=None,
                   emit: Callable[[Dict[str, object]], None] = print) -> List[Dict[str, object]]:
    """The rows of the module docstring at each N; ``check(ok, what)`` is
    given each row's finiteness (default: raise)."""
    check = check or _check
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n in ns:
        x, y, mask, cands = problem(n, gen)
        raw = G.default_params(DIM, CONFIG, torch.float32, gen.device)
        state = G.make_gp_state(x, y, mask, raw, CONFIG)
        fns = {
            "state_build": lambda: G.make_gp_state(x, y, mask, raw, CONFIG),
            "posterior_5k": lambda: G.gp_posterior(state, cands, CONFIG, chunk_size=TS_CHUNK),
            "posterior_5k_auto": lambda: G.gp_posterior(state, cands, CONFIG),
            "ts_q10_5k": lambda: A.thompson_select(state, cands, Q, CONFIG, TS_CHUNK, gen),
            "pathwise_q10_5k": lambda: A.pathwise_paths(state, cands, Q, CONFIG, generator=gen),
            "adam_fit5": lambda: G.fit_gp(x, y, mask, ADAM5, generator=gen),
            "grid_fit": lambda: G.fit_gp(x, y, mask, GRID),
        }
        row: Dict[str, object] = {"n": n, "d": DIM, "candidates": N_CAND, "q": Q,
                                  "grid_branch": "batched" if G.grid_rows_batched(15, n, 4) else "sequential"}
        for name, fn in fns.items():
            wall, peak, out = timed(fn, reps)
            check(_finite(out), f"large-N {name} at N = {n}: non-finite output")
            row[f"{name}_s"], row[f"{name}_peak_gib"] = wall, peak
        row["card"] = smi
        emit(row)
        rows.append(row)
        del x, y, mask, cands, state, fns
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _grid_budget(nbytes: int):
    """The grid fit with ``gp._GRID_VMAP_BUDGET_BYTES`` set to ``nbytes``
    (0: rows one after another; huge: one batch)."""
    saved = G._GRID_VMAP_BUDGET_BYTES
    G._GRID_VMAP_BUDGET_BYTES = nbytes
    try:
        yield
    finally:
        G._GRID_VMAP_BUDGET_BYTES = saved


def _measure_or_oom(fn, reps) -> Dict[str, object]:
    """A branch's wall and peak, or the out-of-memory it ran into: where the
    card's memory ends is the measurement."""
    try:
        wall, peak, out = timed(fn, reps)
    except torch.cuda.OutOfMemoryError as e:
        peak = torch.cuda.max_memory_allocated() / _GIB
        torch.cuda.empty_cache()
        return {"s": None, "peak_gib": peak, "error": "OutOfMemoryError", "message": str(e).splitlines()[0][:160]}
    return {"s": wall, "peak_gib": peak, "out": out}


def rules(smi: str, reps: int = 3, emit: Callable[[Dict[str, object]], None] = print) -> None:
    """Both grid branches at each of ``RULE_GRID_NS`` (equal hypers where
    both ran), then the posterior chunked and unchunked at each of
    ``RULE_POSTERIOR_CASES``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in RULE_GRID_NS:
        x, y, mask, _ = problem(n, gen)
        line: Dict[str, object] = {"rule": "grid", "n": n, "rows": 15, "lane_bytes": 3 * n * n * 4,
                                   "rule_picks": "batched" if G.grid_rows_batched(15, n, 4) else "sequential"}
        hypers = {}
        for branch, budget in (("sequential", 0), ("batched", 1 << 62)):
            torch.cuda.empty_cache()
            with _grid_budget(budget):
                res = _measure_or_oom(lambda: G.fit_gp(x, y, mask, GRID), reps)
            state = res.pop("out", None)
            if state is not None:
                hypers[branch] = torch.cat([a.reshape(-1) for a in state.raw])
            line[branch] = res
            del state
        if len(hypers) == 2:
            line["equal_hypers"] = bool(torch.equal(hypers["sequential"], hypers["batched"]))
        line["card"] = smi
        emit(line)
        del x, y, mask, hypers
        torch.cuda.empty_cache()
    for n, n_cand in RULE_POSTERIOR_CASES:
        x, y, mask, cands = problem(n, gen, n_cand=n_cand)
        state = G.make_gp_state(x, y, mask, G.default_params(DIM, CONFIG, torch.float32, gen.device), CONFIG)
        cross_bytes = n * n_cand * 4
        line = {"rule": "posterior_chunk", "n": n, "candidates": n_cand, "cross_bytes": cross_bytes,
                "auto_chunk_bytes": G._POSTERIOR_AUTO_CHUNK_BYTES,
                "rule_picks": "chunked" if cross_bytes > G._POSTERIOR_AUTO_CHUNK_BYTES else "unchunked"}
        outs = {}
        for label, chunk in (("chunk_1000", TS_CHUNK), ("unchunked", n_cand)):
            res = _measure_or_oom(lambda: G.gp_posterior(state, cands, CONFIG, chunk_size=chunk), reps)
            outs[label] = res.pop("out", None)
            line[label] = res
        if all(o is not None for o in outs.values()):
            line["max_abs_diff_mu"] = float((outs["chunk_1000"][0] - outs["unchunked"][0]).abs().max())
        line["card"] = smi
        emit(line)
        del x, y, mask, cands, state, outs
        torch.cuda.empty_cache()


# The default dense fit (L-BFGS, 4 restarts as one batch of lanes) cut to one
# iteration and one line-search probe: every loss evaluation of the fit has
# the same working set, so its peak is the whole fit's
BUDGET_FIT = dataclasses.replace(CONFIG, fit_maxiter=1, fit_linesearch_steps=1)


def budget_rows(smi: str, ns: Sequence[int] = NS, emit: Callable[[Dict[str, object]], None] = print) -> None:
    """The peak device memory of the default dense fit at each N beside the
    routing rule's 3 N² · 4 bytes (``distributed_linalg.should_distribute``),
    the measurement behind ``DENSE_BUDGET_BYTES``."""
    from turbojax_torch import distributed_linalg as DL

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in ns:
        x, y, mask, _ = problem(n, gen)
        torch.cuda.empty_cache()
        res = _measure_or_oom(lambda: G.fit_gp(x, y, mask, BUDGET_FIT, generator=gen), 1)
        res.pop("out", None)
        rule = 3 * n * n * 4
        emit({"rule": "dense_budget", "n": n, "lanes": CONFIG.fit_restarts, "rule_gib": rule / _GIB,
              "peak_over_rule": res["peak_gib"] * _GIB / rule, "budget_gib": DL.DENSE_BUDGET_BYTES / _GIB,
              "dense_route_on_a_mesh": rule <= DL.DENSE_BUDGET_BYTES,
              "card_gib": torch.cuda.get_device_properties(gen.device).total_memory / _GIB, **res, "card": smi})
        del x, y, mask
        torch.cuda.empty_cache()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def main(argv: Optional[List[str]] = None) -> int:
    from turbojax_torch import cuda_kernels as CK
    from turbojax_torch.kernel_bench import card

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ns", type=int, nargs="+", default=list(NS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rules", action="store_true", help="only the grid-branch and posterior-chunk measurements")
    ap.add_argument("--budget", action="store_true",
                    help="only the default dense fit's peak memory at each N (DENSE_BUDGET_BYTES)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_large_n measures the card: torch.cuda.is_available() is False")
    smi = card()
    CK.build()

    def emit(line):
        print(json.dumps(line), flush=True)

    if args.rules:
        rules(smi, args.reps, emit)
    elif args.budget:
        budget_rows(smi, args.ns, emit)
    else:
        component_rows(smi, args.ns, args.reps, emit=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
