"""Reading the profiler's trace of a window: the device's operations, the
harness's host spans, busy time, idle gaps and what the host was doing in
them.

The trace comes from ``torch.profiler`` (CUPTI on the card). Its events
carry wall-clock nanoseconds, host and device alike. Device work is every
event on the card (kernels, copies, memsets) but the device-side copies of
the harness's host spans, which are not work.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

SPAN_PREFIX = "portbench."


class Interval(NamedTuple):
    name: str
    start: int  # ns
    end: int  # ns


class Trace(NamedTuple):
    """A traced window: device operations, host spans, and the window's
    bounds (ns, the events' clock)."""

    device: List[Interval]
    spans: List[Interval]
    start: int
    end: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9


def from_profiler(prof, start_ns: int, end_ns: int) -> Trace:
    """The window's events out of a stopped ``torch.profiler.profile``."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        on_card = str(e.device_type()).endswith("CUDA")
        span = e.name().startswith(SPAN_PREFIX)
        if on_card and not span:
            device.append(Interval(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif span and not on_card:
            spans.append(Interval(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return Trace(clip(device, start_ns, end_ns), clip(spans, start_ns, end_ns), start_ns, end_ns)


def clip(items: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    out = []
    for it in items:
        s, e = max(it.start, lo), min(it.end, hi)
        if e > s:
            out.append(Interval(it.name, s, e))
    return sorted(out, key=lambda it: it.start)


def union(items: Sequence[Interval]) -> List[Tuple[int, int]]:
    """The merged [start, end) intervals covered by ``items``."""
    merged: List[List[int]] = []
    for it in sorted(items, key=lambda it: it.start):
        if merged and it.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], it.end)
        else:
            merged.append([it.start, it.end])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in union(trace.device)) / 1e9


def gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The window's idle intervals: no device operation running."""
    out, t = [], trace.start
    for s, e in union(trace.device):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def segments(spans: Sequence[Interval]) -> List[Interval]:
    """The time the host spans cover, cut at every span edge, each piece
    named by the innermost span that holds it (the one that started
    last)."""
    points = sorted({sp.start for sp in spans} | {sp.end for sp in spans})
    order = sorted(spans, key=lambda sp: sp.start)
    active: List[Interval] = []
    out, i = [], 0
    for x, nxt in zip(points, points[1:]):
        active = [sp for sp in active if sp.end > x]
        while i < len(order) and order[i].start <= x:
            if order[i].end > x:
                active.append(order[i])
            i += 1
        if active:
            out.append(Interval(max(active, key=lambda sp: sp.start).name, x, nxt))
    return out


def idle_by_span(trace: Trace, top: int = 10) -> List[List]:
    """The idle time by what the host was doing: each idle interval booked
    to the innermost host span over it (``outside_spans`` where none is).
    Longest first."""
    book: Dict[str, int] = defaultdict(int)
    segs = segments(trace.spans)
    j = 0
    for s, e in gaps(trace):
        covered = 0
        while j < len(segs) and segs[j].end <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k].start < e:
            overlap = min(e, segs[k].end) - max(s, segs[k].start)
            if overlap > 0:
                book[segs[k].name] += overlap
                covered += overlap
            k += 1
        if e - s > covered:
            book["outside_spans"] += e - s - covered
    ranked = sorted(book.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """Device seconds by operation name, longest first."""
    book: Dict[str, int] = defaultdict(int)
    for it in trace.device:
        book[it.name] += it.end - it.start
    ranked = sorted(book.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def kernel_time(trace: Trace, kernel: str) -> Tuple[int, float]:
    """(launches, seconds) of the device operations whose name, up to its
    argument list, is ``kernel``."""
    hits = [it for it in trace.device if it.name.split("(")[0].split(" ")[-1] == kernel]
    return len(hits), sum(it.end - it.start for it in hits) / 1e9
