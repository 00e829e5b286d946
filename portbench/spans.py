"""The program's own spans (``turbojax_torch.runlog.span``) in a window's
trace, reckoned as the span metrics read them. A counter is the number of
spans of a name in the window; a time is the device time of the operations
launched under a span (``trace.launched_under``); an idle gap (an interval
of the window outside ``trace.busy_intervals``) belongs to the innermost of
the loop's spans that holds its start on the host clock.

The loop's spans: one ``bo.suggest`` (a request) or ``bo.iteration`` (an
iteration of the large-N loop) a batch, ``bo.callback`` around each call
into the caller's code, and ``sync.<module>.<site>`` around each host read
of a device value. A program that marks no batch (an older one) gives the
readers nothing to read, and each returns ``None``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench import trace as T

BATCH = ("bo.suggest", "bo.iteration")
CALLBACK = "bo.callback"
SYNC = "sync."


def in_window(trace: T.Trace) -> List[T.Span]:
    t0, t1 = trace.window_ns
    return [s for s in trace.spans if t0 <= s.start_ns <= t1]


def marks_batches(trace: T.Trace) -> bool:
    return any(s.name in BATCH for s in in_window(trace))


def count(trace: T.Trace, name: str) -> int:
    """Spans named ``name``, or, for a name ending in ``.``, whose name
    starts with it."""
    if name.endswith("."):
        return sum(1 for s in in_window(trace) if s.name.startswith(name))
    return sum(1 for s in in_window(trace) if s.name == name)


def idle_gaps(trace: T.Trace) -> List[Tuple[int, int]]:
    """The intervals of the window in which no operation ran on the device."""
    t0, t1 = trace.window_ns
    edges = [t0] + [x for iv in T.busy_intervals(trace) for x in iv] + [t1]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2) if edges[k + 1] > edges[k]]


def _owner(name: str) -> str:
    if name.startswith(SYNC):
        return "sync"
    return "caller" if name == CALLBACK else "program"


def idle_by_owner(trace: T.Trace) -> Dict[str, int]:
    """Idle ns of the window by the owner of each gap: ``sync`` (its start
    inside a ``sync.*`` span), ``caller`` (inside a ``bo.callback`` span,
    or outside every batch span: the caller's own time between batches)
    and ``program`` (elsewhere inside a batch). The spans of one host
    thread nest, so a stack swept along the gaps' starts holds the
    innermost."""
    spans = sorted((s for s in in_window(trace) if s.name in BATCH or s.name == CALLBACK or s.name.startswith(SYNC)),
                   key=lambda s: s.start_ns)
    out = {"sync": 0, "caller": 0, "program": 0}
    stack: List[T.Span] = []
    i = 0
    for g0, g1 in idle_gaps(trace):
        while i < len(spans) and spans[i].start_ns <= g0:
            while stack and stack[-1].end_ns < spans[i].start_ns:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_ns < g0:
            stack.pop()
        out[_owner(stack[-1].name) if stack else "caller"] += g1 - g0
    return out


def device_ms_per_batch(run: T.Run, name: str):
    """Device ms per batch of the operations launched under ``name``."""
    ops = T.launched_under(run.trace, name)
    if not run.batches or not ops:
        return None
    return 1e3 * T.device_s(ops) / len(run.batches)


def idle_ms_per_batch(run: T.Run, owner: str):
    if not run.batches or not run.trace.ops or not marks_batches(run.trace):
        return None
    return 1e3 * idle_by_owner(run.trace)[owner] / 1e9 / len(run.batches)
