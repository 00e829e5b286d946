"""Run logging and profiling hooks (port of ``turbojax.runlog``).

``RunLog`` keeps the verbose stdout of the best value per batch
(``verbose=True``) and writes one JSON record per iteration (incumbent, TR
length, timings) to an append-only JSONL file. ``profile`` wraps a region in
``torch.profiler.profile`` and writes a Chrome trace; ``annotate`` is a named
profiler span (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Optional

import torch


class RunLog:
    """Append-only JSONL run log + reference-style verbose stdout."""

    def __init__(self, path: Optional[str] = None, verbose: bool = False):
        self.path = path
        self.verbose = verbose
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._t0 = time.perf_counter()
        self.records = []

    def log(self, iteration: int, **fields) -> None:
        rec = {"iter": iteration, "t": round(time.perf_counter() - self._t0, 4), **fields}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()
        if self.verbose and "best_y" in fields:
            extra = ""
            if "tr_length" in fields:
                extra = f"  L={fields['tr_length']:.4f}"
            print(f"[{iteration:4d}] best = {fields['best_y']:.6f}{extra}")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def profile(trace_dir: Optional[str] = None):
    """Trace a region with ``torch.profiler.profile`` (host ops, and the
    device's kernels when there is a GPU) and write its Chrome trace to
    ``trace_dir/trace_<pid>_<ns>.json``. A no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named profiler span around fit/acquisition/selection phases."""
    with torch.profiler.record_function(name):
        yield


def start_profiler_server(port: int = 9999) -> int:
    """The JAX package's live profiler server (``jax.profiler.start_server``)
    has no PyTorch counterpart: torch.profiler traces a region in-process
    and has no server to attach to. Wrap the region in ``profile`` instead."""
    raise NotImplementedError(
        "start_profiler_server has no PyTorch counterpart (torch.profiler has no live server); "
        "wrap the region in runlog.profile(trace_dir) instead"
    )
