"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build on a checkout's first run, the inputs from the
seed, the program's cached state), warm-up of the cell's own shapes, the
window of ``--seconds`` (ended at the first batch boundary after it), then
the reference's judgement of the window's answers. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from the profiler's trace of the window), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number
compared with its limit, which are also the last lines of standard error.
Exits 2 without enough CUDA devices, and 3 when JAX or the JAX package
was loaded before set-up, by the window or before the result is printed.

A cell on more than one chip runs as one process per card (``ranks``):
this process is rank 0, its window is the result's, ``peak_mem_gib`` and
``memory_peak_bytes`` are the fullest rank's, ``device.count`` the number
of ranks and ``device.ranks`` each rank's peak, batches and busy share."""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, NamedTuple, Optional, Tuple  # noqa: E402

from portbench import guard, manifest  # noqa: E402

_GIB = float(2**30)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def end_to_end(cell: manifest.Cell, batches: List[dict], window_s: float, setup_s: float,
               window_peak: int) -> Dict[str, dict]:
    q = int(cell.config["batch_size"])
    values = {
        "points_per_s": q * len(batches) / window_s,
        "batch_p95_ms": 1e3 * p95([b["latency_s"] for b in batches]),
        "peak_mem_gib": window_peak / _GIB,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell: manifest.Cell, run) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"], cell.root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judged(numbers: Dict[str, object], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; ``checked`` (batches the
    reference judged) must be at least 1, every other number at most its
    limit."""
    checks = {"checked": {"value": numbers["checked"], "limit": 1}}
    ok = numbers["checked"] >= 1
    for name, limit in limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def memory_reading(cuda: bool) -> int:
    """The card's peak of allocated bytes since the last reset (0 on the
    CPU)."""
    import torch

    return torch.cuda.max_memory_allocated() if cuda else 0


class Window(NamedTuple):
    batches: List[dict]
    setup_s: float  # this process's clock from ``t0`` to the window
    setup_peak: int
    window_peak: int
    prof: object  # the stopped profiler, or None untraced


def set_up(cell: manifest.Cell, seed: int, device, entry_hook=None):
    """The cell's entry on ``device``, built from the seed and warmed up:
    the kernels' build, the inputs, the program's cached state, the warm
    batches. ``entry_hook(entry)`` may replace parts of the entry before
    the warm-up (the tests plant faults with it)."""
    import torch

    from portbench import inputs as I

    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if torch.device(device).type == "cuda":
        from turbojax_torch import cuda_kernels as CK

        CK.build()
    inputs = I.Inputs(cell.config, seed, device, cell.root)
    entry = manifest.find("entries", cell.traffic["entry"], cell.root).Entry(cell.config, cell.traffic, inputs, device)
    if entry_hook is not None:
        entry_hook(entry)
    entry.warm_up()
    return entry


def measure(entry, seconds: float, traced: bool, cuda: bool, t0: float) -> Window:
    """Set-up ends here: the set-up clock and peak are read, then the
    window runs, under the profiler when ``traced``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace as T

    setup_s = time.perf_counter() - t0
    setup_peak = memory_reading(cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced else None
    if prof is not None:
        prof.start()
    with record_function(T.WINDOW_SPAN):
        batches = entry.window(seconds)
    if prof is not None:
        prof.stop()
    return Window(batches, setup_s, setup_peak, memory_reading(cuda), prof)


def reading(rank: int, w: Window, trace) -> dict:
    """What one rank's window gives the result: its peaks, its batches and,
    traced, its device's busy and window seconds."""
    from portbench import trace as T

    out = {"rank": rank, "setup_peak": int(w.setup_peak), "window_peak": int(w.window_peak),
           "batches": len(w.batches)}
    if trace is not None:
        out.update(busy_s=T.busy_s(trace), window_s=T.window_s(trace))
    return out


def report(cell: manifest.Cell, entry, w: Window, trace, device, readings: List[dict]) -> dict:
    """The result before the judgement, from rank 0's window and trace and
    every rank's reading (one on one chip): ``peak_mem_gib`` and
    ``memory_peak_bytes`` are the fullest rank's, ``busy_s`` and
    ``window_s`` the mean over the ranks; ``device.ranks`` lists each rank
    where there are more than one."""
    import torch

    from portbench import trace as T

    cuda = torch.device(device).type == "cuda"
    batches = w.batches
    result = {"correct": False, "attempted": len(batches), "failed": 0}
    if trace is None:
        window_s = batches[-1]["t"] if batches else float("nan")
        result["metrics"] = end_to_end(cell, batches, window_s, w.setup_s, max(r["window_peak"] for r in readings))
    else:
        run = T.Run(cell.config, cell.traffic, batches, [entry.work(b) for b in batches], trace)
        result["metrics"] = per_layer(cell, run)
        breakdown = T.breakdown(trace)
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
        "count": len(readings),
        "memory_peak_bytes": max(max(r["setup_peak"], r["window_peak"]) for r in readings),
    }
    if trace is not None:
        result["device"].update(busy_s=sum(r["busy_s"] for r in readings) / len(readings),
                                window_s=sum(r["window_s"] for r in readings) / len(readings))
        result["breakdown"] = breakdown
    if len(readings) > 1:
        result["device"]["ranks"] = [
            dict({"rank": r["rank"], "memory_peak_bytes": max(r["setup_peak"], r["window_peak"]),
                  "window_peak_bytes": r["window_peak"], "batches": r["batches"]},
                 **({"busy_share": r["busy_s"] / r["window_s"]} if "busy_s" in r else {}))
            for r in readings]
    return result


def judge(cell: manifest.Cell, entry, batches: List[dict], result: dict, cuda: bool,
          more_checks: Optional[Dict[str, dict]] = None) -> dict:
    """The reference's judgement of the window's answers, once the
    program's state is freed; ``more_checks`` (each a value at most its
    limit) join the comparison."""
    import torch

    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = entry.judge(batches)
    print(f"portbench readings value_gap {numbers['value_gap']!r} pick_mismatch {numbers['pick_mismatch']} "
          f"checked {numbers['checked']} of {len(batches)} in {time.perf_counter() - t_judge:.1f} s",
          file=sys.stderr, flush=True)
    correct, checks = judged(numbers, cell.limits)
    for name, c in (more_checks or {}).items():
        checks[name] = c
        correct = correct and c["value"] <= c["limit"]
    result["correct"] = correct
    result["failed"] = sum(1 for b in numbers["per_batch"] if any(not b[k] <= lim for k, lim in cell.limits.items()))
    result["checks"] = checks
    return result


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t0: Optional[float] = None, entry_hook=None, ranks=None) -> dict:
    """One run of ``cell``; returns the result object (see the module
    docstring). ``entry_hook`` as in ``set_up``. With ``ranks`` (a
    ``ranks.Ranks``: a cell on more than one chip) this process is rank 0:
    it joins the group before set-up, meets the other ranks before the
    window, and its result takes in every rank's reading and checks."""
    import torch

    from portbench import trace as T

    t0 = time.perf_counter() if t0 is None else t0
    dev = device if ranks is None else ranks.device
    cuda = torch.device(dev).type == "cuda"
    if ranks is not None:
        ranks.join()
    entry = set_up(cell, seed, dev, entry_hook)
    if ranks is not None:
        ranks.window_starts(seconds)
    w = measure(entry, seconds, traced, cuda, t0)
    guard.check("after the window")
    trace = T.collect(w.prof) if traced else None
    readings = [reading(0, w, trace)]
    if ranks is not None:
        readings = ranks.readings(readings[0])
    result = report(cell, entry, w, trace, dev, readings)
    batches = w.batches
    del w, trace  # the profiler's record, before the reference runs
    return judge(cell, entry, batches, result, cuda, None if ranks is None else ranks.checks(readings))


def arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """A run's arguments, which every rank of a run is given alike."""
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv: Optional[List[str]] = None, device: str = "cuda", root: str = manifest.ROOT) -> int:
    """The command. ``device`` and ``root`` let the tests drive a whole run
    on the CPU over a directory of tiny cells; the command line always runs
    on the card."""
    args = arguments(argparse.ArgumentParser(description=__doc__,
                                             formatter_class=argparse.RawDescriptionHelpFormatter)).parse_args(argv)
    guard.check("before set-up")
    cell = manifest.load_cell(args.workload, root)
    import torch

    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {card_line() if device == 'cuda' else device}",
          file=sys.stderr, flush=True)
    if cell.chips > 1:
        from portbench import ranks

        result = ranks.lead(cell, args, device, root, _T0)
    else:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0=_T0)
    guard.check("before the result")
    for name, c in result["checks"].items():
        print(f"portbench check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
