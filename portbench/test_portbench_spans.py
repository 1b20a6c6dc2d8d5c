"""The span arithmetic (``harness/spans.py``) and the six readers of the
program's spans, on hand-made spans (``fixtures/spans-small.json``) with
values worked out by hand: self time under nested children, spans cut by
the traced stretch's edges (a span counts whole where its midpoint lies
inside), the device's idle intervals against the engine thread's busy
ones, and nothing to read."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from chattts_tpu_torch.utils import profiling
from harness import spans, trace

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = ("loop_host_ms_per_step.batch", "wrapper_host_ms_per_step.batch",
         "audio_decode_ms_per_audio_s.batch", "facade_self_pct.batch")
SAT = ("idle_engine_busy_pct.sat", "recompute_prefill_pct.sat")
CONFIG = {"vocos": {"hop_length": 256, "sample_rate": 24000}}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def recorded(kind, monkeypatch):
    """A session of the fixture's ``kind`` whose program gives its spans."""
    with open(os.path.join(HERE, "fixtures", "spans-small.json")) as f:
        fx = json.load(f)[kind]
    rows = [profiling.Span(i, n, t, int(a * 1e3), int(b * 1e3), p,
                           tuple(r), at)
            for i, n, t, a, b, p, r, at in fx["spans"]]
    monkeypatch.setattr(profiling, "spans", lambda: list(rows))
    tr = trace.Trace(start_us=fx["start_us"], stop_us=fx["stop_us"])
    tr.device = [trace.Event(n, s, d, True) for n, s, d in fx["device"]]
    return SimpleNamespace(tracer=SimpleNamespace(trace=tr), config=CONFIG,
                           counters={}, state={})


def test_merge_intersect_and_minus():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6)]) == [
        (0, 4), (5, 7)]
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == [
        (5, 10), (20, 25), (28, 30)]
    assert spans.minus([(0, 10), (20, 30)], [(2, 4), (8, 22), (25, 26)]) \
        == [(0, 2), (4, 8), (22, 25), (26, 30)]
    assert spans.length([(0, 4), (2, 6), (10, 11)]) == 7


def test_self_time_with_nested_children():
    def sp(a, b):
        return profiling.Span(0, "x", 1, a * 1000, b * 1000, -1, (), {})

    # children overlap each other and stick out of the parent
    assert spans.self_us(sp(0, 100), [sp(10, 30), sp(20, 40), sp(90, 120)]
                         ) == pytest.approx(100 - 30 - 10)
    assert spans.self_us(sp(0, 100), []) == pytest.approx(100)


def test_spans_cut_by_the_edges_count_by_their_midpoint(monkeypatch):
    s = recorded("batch", monkeypatch)
    # [900, 1900] starts before the stretch: its midpoint is inside;
    # [1950, 2600] ends after it and [700, 1010] starts before: outside
    assert [sp.index for sp in spans.inside(s, "chat.infer")] == [0]
    assert [sp.index for sp in spans.inside(s, "generator.steps")] == [3, 7]
    # a step of the next call, whose stretch lies outside, is inside
    assert [sp.index for sp in spans.inside(s, "decode_step")] == [
        4, 5, 8, 16]


def test_batch_readers_on_the_recorded_spans(monkeypatch):
    s = recorded("batch", monkeypatch)
    # two stretches of 200 and 120 us over their three steps
    assert reader("loop_host_ms_per_step.batch")(s) == pytest.approx(
        0.320 / 3)
    # 60 + 50 + 40 + 30 us over four calls
    assert reader("wrapper_host_ms_per_step.batch")(s) == pytest.approx(
        0.045)
    # 0.2 ms over 150 frames of 512 samples at 24 kHz (3.2 s)
    assert reader("audio_decode_ms_per_audio_s.batch")(s) == pytest.approx(
        0.0625)
    # 1000 us, its children cover 550 + 200: 250 of its own; the other
    # thread's span over the same time is no child
    assert reader("facade_self_pct.batch")(s) == pytest.approx(25.0)


def test_engine_thread_busy_in_the_device_idle_time(monkeypatch):
    s = recorded("sat", monkeypatch)
    idle = spans.device_idle(s)
    assert idle == [(0.0, 100.0), (300.0, 500.0), (600.0, 950.0)]
    # the engine thread (7): steps [-100, 30], [50, 400], [420, 980]
    # less its ingests [250, 350], [700, 900]; in the idle intervals
    # 30 + 50, 50 + 80, 100 + 50 of 650 (the request thread's spans and
    # ingest count for nothing)
    assert reader("idle_engine_busy_pct.sat")(s) == pytest.approx(
        100 * 360 / 650)


def test_recompute_share_of_the_prefills(monkeypatch):
    s = recorded("sat", monkeypatch)
    # waves inside: 120 resumed of 300, 0 of 80; the waves before and
    # after the stretch count for nothing
    assert reader("recompute_prefill_pct.sat")(s) == pytest.approx(
        100 * 120 / 380)


@pytest.mark.parametrize("name", BATCH + SAT)
def test_no_spans_read_nothing(name, monkeypatch):
    s = recorded("sat" if name in SAT else "batch", monkeypatch)
    trace_of_run, s.tracer.trace = s.tracer.trace, None
    assert reader(name)(s) is None  # a run without a trace
    s.tracer.trace = trace_of_run
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name)(s) is None
    # a program that records no spans
    monkeypatch.delattr(profiling, "spans")
    assert spans.program_spans() is None
    assert reader(name)(s) is None


@pytest.mark.parametrize("name", BATCH)
def test_batch_readers_read_nothing_in_the_serving_stretch(name,
                                                           monkeypatch):
    assert reader(name)(recorded("sat", monkeypatch)) is None

