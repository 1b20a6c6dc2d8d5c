"""The program's spans in a traced stretch, and the arithmetic the span
readers share (``portbench/metrics/*.py`` with ``program_span`` sources).

The program records its spans (``chattts_tpu_torch.utils.profiling``)
while a profiler runs, from every thread, stamped by ``time.time_ns()``:
the clock the profiler stamps its events on, so a span's microseconds
compare with the trace's.  A span lies in the traced stretch
``[trace.start_us, trace.stop_us)`` when its midpoint does, and then counts
whole.  A program that records no spans (one older than the recorder)
gives ``None`` here, and every reader reads nothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import trace

Interval = Tuple[float, float]


def program_spans() -> Optional[list]:
    """Every span the program recorded, or None where it keeps none."""
    try:
        from chattts_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def us(sp) -> Interval:
    """A span's (start, end) in microseconds."""
    return sp.start_ns / 1e3, sp.end_ns / 1e3


def stretch(s) -> Optional[Tuple[list, float, float]]:
    """(every recorded span, the traced stretch's start and stop in
    microseconds), or None without a trace or without spans."""
    tr = s.tracer.trace
    if tr is None or tr.stop_us <= tr.start_us:
        return None
    rec = program_spans()
    if not rec:
        return None
    return rec, tr.start_us, tr.stop_us


def inside(s, *names: str) -> Optional[list]:
    """The spans of ``names`` whose midpoint lies in the traced stretch
    (None without a trace or without spans)."""
    got = stretch(s)
    if got is None:
        return None
    rec, lo, hi = got
    out = []
    for sp in rec:
        if sp.name in names:
            a, b = us(sp)
            if lo <= (a + b) / 2 < hi:
                out.append(sp)
    return out


def dur_us(spans) -> float:
    return sum(sp.end_ns - sp.start_ns for sp in spans) / 1e3


def merge(intervals: List[Interval]) -> List[Interval]:
    """The union of ``intervals`` as disjoint, sorted intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in merge(intervals))


def intersect(x: List[Interval], y: List[Interval]) -> List[Interval]:
    """Where both ``x`` and ``y`` cover."""
    x, y = merge(x), merge(y)
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(x: List[Interval], y: List[Interval]) -> List[Interval]:
    """Where ``x`` covers and ``y`` does not."""
    out = []
    y = merge(y)
    for a, b in merge(x):
        at = a
        for c, d in y:
            if d <= at or c >= b:
                continue
            if c > at:
                out.append((at, c))
            at = max(at, d)
        if at < b:
            out.append((at, b))
    return out


def self_us(parent, children) -> float:
    """Microseconds of ``parent`` that none of ``children`` covers."""
    a, b = us(parent)
    return (b - a) - length(intersect([(a, b)], [us(c) for c in children]))


def device_idle(s) -> Optional[List[Interval]]:
    """The traced stretch's intervals in which no device operation ran."""
    tr = s.tracer.trace
    if tr is None or tr.stop_us <= tr.start_us:
        return None
    _, gaps = trace.union_us([(e.start_us, e.end_us) for e in tr.device],
                             tr.start_us, tr.stop_us)
    return gaps
