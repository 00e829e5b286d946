"""Run logging and profiling hooks (port of ``turbojax.runlog``).

``RunLog`` keeps the verbose stdout of the best value per batch
(``verbose=True``) and writes one JSON record per iteration (incumbent, TR
length, timings) to an append-only JSONL file. ``profile`` wraps a region in
``torch.profiler.profile`` and writes a Chrome trace; ``span`` is a named
profiler span (``torch.profiler.record_function``) that costs one check when
no profiler is recording. ``start_profiler_server``
lets a running process be traced on demand: each ``SIGUSR2`` opens or closes
a profiler window.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
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
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
    _export(prof, trace_dir)


def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])


def _export(prof, trace_dir: str) -> None:
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named profiler span: ``torch.profiler.record_function(name)`` while
    a profiler is recording, else one shared null context, so that a span
    costs an untraced run one check (``record_function`` itself costs
    several microseconds with no profiler). Every span of the package goes
    through here; a span never reads a device value, and the number of
    spans of a name in a trace is its counter."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _SignalProfiler:
    """The ``SIGUSR2`` toggle behind ``start_profiler_server``: the first
    signal starts a ``torch.profiler.profile``, the next stops it and writes
    its Chrome trace to ``trace_dir``."""

    def __init__(self, trace_dir: str, previous):
        self.trace_dir = trace_dir
        self.previous = previous  # the handler to put back on stop
        self.prof = None

    def toggle(self, signum, frame) -> None:
        if self.prof is None:
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.start()
            return
        prof, self.prof = self.prof, None
        prof.stop()
        _export(prof, self.trace_dir)


# one per process, as the signal handler it installs
_SIGNAL_PROFILER: Optional[_SignalProfiler] = None


def start_profiler_server(port: int = 9999, trace_dir: str = "profiler_traces") -> int:
    """On-demand profiling of a long run, in place of the JAX package's live
    profiler server (``jax.profiler.start_server``): installs a ``SIGUSR2``
    handler, so that ``kill -USR2 <pid>`` starts a ``torch.profiler`` window
    and the next ``kill -USR2 <pid>`` closes it and writes its Chrome trace
    to ``trace_dir/trace_<pid>_<ns>.json``. Nothing listens on ``port``: it
    is returned, as the JAX package's function returns it. A repeated call
    is a no-op (the first call's ``trace_dir`` stays); the handler runs in
    the main thread, so call this from there."""
    global _SIGNAL_PROFILER
    if _SIGNAL_PROFILER is None:
        handler = _SignalProfiler(trace_dir, signal.getsignal(signal.SIGUSR2))
        signal.signal(signal.SIGUSR2, handler.toggle)
        _SIGNAL_PROFILER = handler
    return port


def _stop_profiler_server() -> None:
    """Remove ``start_profiler_server``'s handler (an open window is closed
    and written first) and put the previous ``SIGUSR2`` handler back."""
    global _SIGNAL_PROFILER
    handler, _SIGNAL_PROFILER = _SIGNAL_PROFILER, None
    if handler is None:
        return
    signal.signal(signal.SIGUSR2, signal.SIG_DFL if handler.previous is None else handler.previous)
    if handler.prof is not None:
        handler.toggle(signal.SIGUSR2, None)
