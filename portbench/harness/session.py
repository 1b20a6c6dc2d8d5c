"""One run's state, shared by ``run.py``, the drivers and the readers."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import program, trace


@dataclass
class Record:
    """One call or request of the window, on the host's clock (seconds
    since the window's start)."""

    key: Any
    due: float
    start: float
    end: Optional[float] = None     # None: never finished
    first: Optional[float] = None   # first non-empty audio (streams)
    chunks: List[float] = field(default_factory=list)
    audio_s: float = 0.0
    ok: bool = False
    items: List[Any] = field(default_factory=list)  # the traffic items


@dataclass
class Session:
    """Everything a run knows: its arguments, configuration and mix, the
    weights, the program's outputs, the window's records and counters,
    and the trace."""

    name: str
    seed: int
    seconds: float
    traced: bool
    device: Any
    config: dict
    workload: dict
    weights: dict = field(default_factory=dict)
    outputs: program.Outputs = field(default_factory=program.Outputs)
    records: List[Record] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    tracer: trace.Tracer = None
    setup_s: float = 0.0
    window_s: float = 0.0
    state: Dict[str, Any] = field(default_factory=dict)  # the driver's

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = trace.Tracer(self.traced)
        self.t0 = None

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def open_window(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    def now(self) -> float:
        """Seconds since the window opened."""
        return time.perf_counter() - self.t0

    def say(self, line: str) -> None:
        """A line for standard output, before the result."""
        print(line, flush=True)

    @property
    def samples_per_step(self) -> int:
        return 2 * self.config["vocos"]["hop_length"]

    @property
    def sample_rate(self) -> int:
        return self.config["vocos"]["sample_rate"]

    def audio_seconds(self, steps: int) -> float:
        return steps * self.samples_per_step / self.sample_rate
