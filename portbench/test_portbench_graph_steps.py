"""The reader of the share of decode steps replayed from a CUDA graph
(``metrics/graph_steps_pct.batch.py``) on hand-made spans
(``fixtures/spans-graphed.json``): the ``graphed`` attribute of the
``generator.steps`` spans in the traced stretch over their ``steps``, and
nothing to read without a trace, without spans, or where the program's
spans carry no ``graphed`` (a program that captures no graph)."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from chattts_tpu_torch.utils import profiling
from harness import trace

HERE = os.path.dirname(os.path.abspath(__file__))


def read(s):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(HERE, "metrics", "graph_steps_pct.batch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(s)


def session(monkeypatch, fixture="spans-graphed.json", kind=None):
    with open(os.path.join(HERE, "fixtures", fixture)) as f:
        fx = json.load(f)
    fx = fx[kind] if kind else fx
    rows = [profiling.Span(i, n, t, int(a * 1e3), int(b * 1e3), p,
                           tuple(r), at)
            for i, n, t, a, b, p, r, at in fx["spans"]]
    monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    tr = trace.Trace(start_us=fx["start_us"], stop_us=fx["stop_us"])
    return SimpleNamespace(tracer=SimpleNamespace(trace=tr), counters={},
                           state={})


def test_share_of_the_stretches_inside_the_trace(monkeypatch):
    # inside: 8 of 8, 4 of 4 and 0 of 4 steps graphed; the stretches
    # whose midpoints lie before and after the traced stretch count for
    # nothing, and the capture is no stretch
    assert read(session(monkeypatch)) == pytest.approx(100 * 12 / 16)


def test_nothing_to_read(monkeypatch):
    s = session(monkeypatch)
    traced, s.tracer.trace = s.tracer.trace, None
    assert read(s) is None  # a run without a trace
    s.tracer.trace = traced
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(s) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(s) is None  # a program that records no spans


def test_spans_without_the_attribute_read_nothing(monkeypatch):
    # a program whose stretches have no ``graphed`` (one that replays no
    # graph) and the serving cell's stretch, which has no Generator steps
    assert read(session(monkeypatch, "spans-small.json", "batch")) is None
    assert read(session(monkeypatch, "spans-small.json", "sat")) is None
