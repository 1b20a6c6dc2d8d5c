"""The device trace of a traced run (``--trace 1``) and what is read from it.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over a part of
the measured window that the driver chooses, marks its start and stop with
two host ranges, and keeps the raw events: the device's operations
(kernels, copies, fills) and the host's.  The readers below turn them into
the busy time (the union of the device's intervals), the idle gaps (each
named by the innermost host operation running at its middle), the time of
each kernel family and the breakdown of the result line.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

START_MARK = "portbench.trace_start"
STOP_MARK = "portbench.trace_stop"
# the profiler's own host events, never what the host was doing
PROFILER_EVENTS = ("Activity Buffer Request",)


@dataclass
class Event:
    name: str
    start_us: float
    dur_us: float
    device: bool

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclass
class Trace:
    """The events of one traced stretch, and its bounds on their clock."""

    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    start_us: float = 0.0
    stop_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.stop_us - self.start_us) / 1e6

    def kernels(self) -> List[Event]:
        """The device's kernels (not its copies and fills)."""
        return [e for e in self.device if not _is_copy(e.name)]


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith(("memcpy", "memset")) or "memcpy" in n[:16]


def clean_name(name: str) -> str:
    """A kernel's name without its namespace decorations and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].strip()[:80]


def union_us(intervals: List[Tuple[float, float]], lo: float, hi: float
             ) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered microseconds, the uncovered gaps) of [lo, hi] under
    ``intervals`` (start, end), which may overlap and stick out."""
    covered = 0.0
    gaps = []
    at = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        if e > at:
            covered += e - max(s, at)
            at = e
    if at < hi:
        gaps.append((at, hi))
    return covered, gaps


def busy_s(trace: Trace) -> float:
    covered, _ = union_us([(e.start_us, e.end_us) for e in trace.device],
                          trace.start_us, trace.stop_us)
    return covered / 1e6


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The longest idle gaps, [[host op running at its middle, s], ...]."""
    _, gaps = union_us([(e.start_us, e.end_us) for e in trace.device],
                       trace.start_us, trace.stop_us)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(trace.host, key=lambda e: e.start_us)
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = None
        for h in host:
            if h.start_us > mid:
                break
            if h.end_us >= mid and (inner is None or h.dur_us < inner.dur_us):
                inner = h
        out.append([inner.name if inner is not None else "python (no op)",
                    (e - s) / 1e6])
    return out


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    """The device operations that took most time, [[name, s], ...]."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for e in trace.device:
        tot[clean_name(e.name)] += e.dur_us
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e6] for k, v in rows]


def family_us(trace: Trace, prefixes: Tuple[str, ...]) -> Tuple[int, float]:
    """(launches, device microseconds) of the kernels whose cleaned name
    starts with one of ``prefixes``."""
    n, us = 0, 0.0
    for e in trace.kernels():
        if clean_name(e.name).startswith(prefixes):
            n += 1
            us += e.dur_us
    return n, us


class Tracer:
    """Starts and stops the profiler on the driver's call; ``trace`` holds
    the events once stopped.  A tracer made with ``enabled=False`` does
    nothing (the untraced runs)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None
        self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    def prepare(self) -> None:
        """Start and stop the profiler once, so that its first start (the
        CUDA activity tracer's set-up, seconds) falls in the set-up."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.trace:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.profiler.record_function(START_MARK):
            pass

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        with torch.profiler.record_function(STOP_MARK):
            pass
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace = read_events(prof)


def _ts(e, what: str) -> float:
    ns = getattr(e, f"{what}_ns", None)
    if ns is not None:
        return ns() / 1e3
    return float(getattr(e, f"{what}_us")())


def read_events(prof) -> Trace:
    """The profiler's raw events as a :class:`Trace` (the per-op tables of
    ``key_averages`` are slow to build for a run of many launches)."""
    import torch

    out = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), _ts(e, "start"), _ts(e, "duration"),
                   e.device_type() == cuda)
        if ev.device:
            out.device.append(ev)
        elif ev.name == START_MARK:
            out.start_us = ev.start_us
        elif ev.name == STOP_MARK:
            out.stop_us = ev.end_us
        elif ev.name not in PROFILER_EVENTS:
            out.host.append(ev)
    return out
