"""The profiler's record of a window, reduced to what the per-layer
metrics read: the device's operations (kernels, copies, sets) with their
times, the host's launch of each (by correlation id), the spans
(``record_function`` ranges) and the host's operations.

The recipe is ``turbojax_torch.profile_config5._device_split`` /
``bench_large_n.profile_loop_iteration``'s, copied here so that a change
to the program cannot move it: device work is what ran on the device,
never the spans' own device-side annotations; busy time is the union of the
device operations' intervals, so overlapping streams count once."""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Tuple

import torch


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    correlation: int
    kind: str  # "kernel", "memcpy" or "memset"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    ops: List[DeviceOp]  # device operations in the window, by start
    launch_ns: Dict[int, int]  # correlation id -> the host's launch call's start
    spans: List[Span]  # record_function ranges on the host
    host_ops: List[Span]  # the host's operator calls, by start
    window_ns: Tuple[int, int]


def _kind(name: str) -> str:
    n = name.lower()
    if n.startswith("memcpy"):
        return "memcpy"
    if n.startswith("memset"):
        return "memset"
    return "kernel"


WINDOW_SPAN = "portbench.window"


def collect(prof) -> Trace:
    """Reduce a stopped ``torch.profiler.profile`` to a ``Trace``; the
    window is the span ``WINDOW_SPAN`` the harness opens around it, and only
    device operations that start inside it count. On the device side the
    spans' own annotations are left out (they are no work); on the host
    side the CUDA API calls (names ``cuda*``/``cu*``) give each device
    operation's launch time by correlation id."""
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    span_names = {e.name() for e in events if e.device_type() == cpu and e.is_user_annotation()}
    win = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() == cpu]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0_ns, t1_ns = int(win[0].start_ns()), int(win[0].end_ns())
    ops, launch_ns, spans, host_ops = [], {}, [], []
    for e in events:
        start, end, name = int(e.start_ns()), int(e.end_ns()), e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and name not in span_names and t0_ns <= start <= t1_ns:
                ops.append(DeviceOp(name, start, end, int(e.correlation_id()), _kind(name)))
        elif e.device_type() == cpu:
            if e.is_user_annotation():
                spans.append(Span(name, start, end))
            elif name.startswith("cu"):
                launch_ns[int(e.correlation_id())] = start
            else:
                host_ops.append(Span(name, start, end))
    ops.sort(key=lambda o: o.start_ns)
    host_ops.sort(key=lambda s: s.start_ns)
    return Trace(ops, launch_ns, spans, host_ops, (t0_ns, t1_ns))


def busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, clipped to the window."""
    t0, t1 = trace.window_ns
    merged: List[List[int]] = []
    for o in trace.ops:
        s, e = max(o.start_ns, t0), min(o.end_ns, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e9


def window_s(trace: Trace) -> float:
    return (trace.window_ns[1] - trace.window_ns[0]) / 1e9


def device_s(ops) -> float:
    return sum(o.end_ns - o.start_ns for o in ops) / 1e9


def kernels(trace: Trace, fragments=None) -> List[DeviceOp]:
    """The kernels, or those whose lower-cased name holds one of ``fragments``."""
    out = [o for o in trace.ops if o.kind == "kernel"]
    if fragments is not None:
        out = [o for o in out if any(f in o.name.lower() for f in fragments)]
    return out


def launched_under(trace: Trace, span_name: str) -> List[DeviceOp]:
    """The device operations whose launch call started inside a span of
    that name (on any thread: autograd launches on its own)."""
    ranges = sorted((s.start_ns, s.end_ns) for s in trace.spans if s.name == span_name)
    if not ranges:
        return []
    starts = [r[0] for r in ranges]
    out = []
    for o in trace.ops:
        t = trace.launch_ns.get(o.correlation)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            out.append(o)
    return out


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by name) and the longest
    idle gaps of the device summed by the host operation it was in when
    each began (the innermost operation then running; "host" where none)."""
    by_name: Dict[str, int] = {}
    for o in trace.ops:
        by_name[_short(o.name)] = by_name.get(_short(o.name), 0) + (o.end_ns - o.start_ns)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = trace.host_ops
    starts = [h.start_ns for h in host]
    gaps: Dict[str, int] = {}
    t0, t1 = trace.window_ns
    edges = [t0] + [x for iv in busy_intervals(trace) for x in iv] + [t1]
    for k in range(0, len(edges) - 1, 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1
        label = "host"
        for j in range(i, max(i - 4000, -1), -1):
            if host[j].end_ns >= g0:
                label = _short(host[j].name)
                break
        gaps[label] = gaps.get(label, 0) + (g1 - g0)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in device_ops], "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}


class Run(NamedTuple):
    """What a per-layer metric's ``read(run)`` is given."""

    config: dict
    traffic: dict
    batches: List[dict]  # the window's completed batches: n, fit, latency_s, ...
    work: List[dict]  # each batch's work (the entry's ``work``, yardstick.work)
    trace: Trace
