"""Tracing (port of ``chattts_tpu/utils/profiling.py``).

* :func:`span` marks a region of the program at a layer boundary (the
  facade, the Generator loop, the decode-step wrapper, the audio back end,
  the Engine scheduler, the service).  It records only while a
  ``torch.profiler`` session runs anywhere in the process (the profiler's
  module flag ``torch.autograd.profiler._is_profiler_enabled``, which every
  thread sees); otherwise it returns one shared no-op object and costs one
  attribute read.  A recorded span keeps its name, its thread, its start
  and end on ``time.time_ns()`` (the clock the profiler stamps its host
  and device events on, so spans from any thread land on the device
  trace's timeline), the index of the enclosing span in the same thread,
  the request ids it served and a few integer attributes.  In the thread
  that runs the profiler it also enters a host range of the same name, so
  the profiler's own events carry it; the profiler records no other
  thread's ranges.  The range is the fast one of compiled graphs
  (``_RecordFunctionFast``, an operator's scope): a ``record_function``
  range would cost several times more and would add a device-side
  annotation over the kernels launched inside it, which the device's busy
  time would count.  :func:`spans` returns what was recorded, at most ``MAX_SPANS`` records;
  :func:`dropped_spans` counts those past it.
* :func:`trace` wraps ``torch.profiler`` (the reference wraps
  ``jax.profiler``): a region's host and device timelines, and the spans
  every thread recorded in it, are written as one Chrome trace file into
  ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

# the profiler's host range of an operator's scope; None where this torch
# has none (spans are then recorded without a range)
_HostRange = getattr(torch._C._profiler, "_RecordFunctionFast", None)

# records kept at once; a traced stretch of the benchmark's busiest cell
# makes a few thousand a second
MAX_SPANS = 1 << 18


class Span(NamedTuple):
    """One recorded span; times are ``time.time_ns()`` readings."""

    index: int                # its place in the recording
    name: str
    tid: int                  # the thread's native id
    start_ns: int
    end_ns: int
    parent: int               # index of the enclosing span, -1 for none
    rids: Tuple[str, ...]     # request ids it served
    attrs: Dict[str, int]


_lock = threading.Lock()
_records: List[Optional[Span]] = []   # None: entered, not yet left
_dropped = 0
_generation = 0                       # bumped by clear_spans
_thread_names: Dict[int, str] = {}
_local = threading.local()


class _Off:
    """What :func:`span` returns while no profiler runs: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, rids=None, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "rids", "attrs", "_index", "_gen", "_parent",
                 "_tid", "_rf", "_start")

    def __init__(self, name: str, rids, attrs: dict):
        self.name = name
        self.rids = tuple(rids)
        self.attrs = attrs
        self._rf = None

    def set(self, rids=None, **attrs) -> None:
        """Name the request ids or attributes known only inside the span."""
        if rids is not None:
            self.rids = tuple(rids)
        self.attrs.update(attrs)

    def __enter__(self):
        global _dropped
        try:
            tid, stack = _local.tid, _local.stack
        except AttributeError:
            # once a thread: reading the native id is a system call, which
            # costs microseconds on some hosts
            tid = _local.tid = threading.get_native_id()
            stack = _local.stack = []
            _thread_names[tid] = threading.current_thread().name
        self._tid = tid
        self._parent = stack[-1] if stack else -1
        with _lock:
            self._gen = _generation
            if len(_records) < MAX_SPANS:
                self._index = len(_records)
                _records.append(None)
            else:
                self._index = -1
                _dropped += 1
        stack.append(self._index)
        if _HostRange is not None and torch.autograd._profiler_enabled():
            self._rf = _HostRange(self.name)  # the profiling thread
            self._rf.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.stack.pop()
        if self._index >= 0:
            rec = Span(self._index, self.name, self._tid, self._start, end,
                       self._parent, self.rids, self.attrs)
            with _lock:
                if self._gen == _generation:
                    _records[self._index] = rec
        return None


def span(name: str, rids=(), **attrs):
    """``with span("engine.prefill", rids=ids, rows=4): ...`` records the
    region while a profiler runs (integer ``attrs``; ``set`` on the
    returned object adds what is known only inside)."""
    if not getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return _OFF
    return _On(name, rids, attrs)


def spans() -> List[Span]:
    """The spans recorded since the last :func:`clear_spans` and left by
    now, in the order they were entered."""
    with _lock:
        return [r for r in _records if r is not None]


def dropped_spans() -> int:
    """Spans not recorded because ``MAX_SPANS`` were held."""
    return _dropped


def thread_names() -> Dict[int, str]:
    """Native thread id -> thread name, of every thread that recorded."""
    return dict(_thread_names)


def clear_spans() -> None:
    """Forget every record and the dropped count; a span open across the
    call is not recorded."""
    global _dropped, _generation
    with _lock:
        _records.clear()
        _dropped = 0
        _generation += 1


def _chrome_events(recorded: List[Span], base_ns: int = 0) -> List[dict]:
    """``recorded`` as Chrome-trace complete events of this process, with
    times in microseconds after ``base_ns``, and the recording threads'
    names."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}
           for tid, name in thread_names().items()
           if any(s.tid == tid for s in recorded)]
    for s in recorded:
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                    "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"index": s.index, "parent": s.parent,
                             "rids": list(s.rids), **s.attrs}})
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``with trace(d): chat.infer(...)`` writes ``d/trace_<pid>_<ns>.json``
    (Chrome trace format; CUDA activity too where a card is present) when
    the region ends, also when it raises, with the spans every thread
    recorded in the region beside the profiler's own events (which hold
    the profiling thread's alone).  ``log_dir`` defaults to
    ``chattts_trace`` in the temporary directory.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "chattts_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    clear_spans()
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"].extend(_chrome_events(
            spans(), int(doc.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as f:
            json.dump(doc, f)
