"""Tracing and serving metrics (port of ``chattts_tpu/utils/profiling.py``).

* :func:`trace` wraps ``torch.profiler`` (the reference wraps
  ``jax.profiler``): a region's host and device timelines are written as one
  Chrome trace file into ``log_dir``;
* :class:`Metrics` keeps the serving counters: speech token-steps/s, RTF
  and time-to-first-audio percentiles (framework-neutral, copied).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SAMPLES_PER_STEP = 512  # 1 code step -> 512 samples @ 24 kHz
SAMPLE_RATE = 24000


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``with trace(d): chat.infer(...)`` writes ``d/trace_<pid>_<ns>.json``
    (Chrome trace format; CUDA activity too where a card is present) when
    the region ends, also when it raises.  ``log_dir`` defaults to
    ``chattts_trace`` in the temporary directory.  Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "chattts_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


@dataclass
class Metrics:
    """Rolling serving metrics (tokens/s, RTF, TTFA)."""

    started: float = field(default_factory=time.monotonic)
    steps: int = 0
    sequences: int = 0
    audio_samples: int = 0
    busy_seconds: float = 0.0
    ttfa_seconds: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def timed(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.busy_seconds += time.monotonic() - t0

    def record_steps(self, n_steps: int, batch: int = 1):
        self.steps += n_steps * batch
        self.audio_samples += n_steps * batch * SAMPLES_PER_STEP

    def record_ttfa(self, seconds: float):
        self.ttfa_seconds.append(seconds)

    def record_sequences(self, n: int):
        self.sequences += n

    def snapshot(self) -> Dict[str, float]:
        wall = max(time.monotonic() - self.started, 1e-9)
        busy = max(self.busy_seconds, 1e-9)
        ttfa = sorted(self.ttfa_seconds)
        return {
            "steps_per_sec": self.steps / busy,
            "speech_tokens_per_sec": self.steps * 4 / busy,
            "rtf": (self.audio_samples / SAMPLE_RATE) / busy,
            "sequences": float(self.sequences),
            "wall_seconds": wall,
            "busy_seconds": busy,
            "ttfa_p50": _percentile(ttfa, 0.50),
            "ttfa_p90": _percentile(ttfa, 0.90),
        }
