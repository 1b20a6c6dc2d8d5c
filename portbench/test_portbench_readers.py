"""The trace arithmetic and every metric reader on small recorded inputs:
a cut-down trace (``fixtures/trace-small.json``) and hand-made records."""

import importlib.util
import json
import os
from types import SimpleNamespace

import pytest

from harness import readers, roofline, trace
from harness.session import Record
from harness.traffic import Item

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def tiny_config():
    with open(os.path.join(HERE, "fixtures", "tiny-config.json")) as f:
        return json.load(f)


def recorded():
    with open(os.path.join(HERE, "fixtures", "trace-small.json")) as f:
        fx = json.load(f)
    tr = trace.Trace(start_us=fx["start_us"], stop_us=fx["stop_us"])
    tr.device = [trace.Event(n, s, d, True) for n, s, d in fx["device"]]
    tr.host = [trace.Event(n, s, d, False) for n, s, d in fx["host"]
               if n not in trace.PROFILER_EVENTS]
    calls = [[Item("x" * (n - 4), c["steps"], True, i)
              for i, n in enumerate(c["prompt_tokens"])]
             for c in fx["traced_calls"]]
    return SimpleNamespace(
        tracer=SimpleNamespace(trace=tr), config=dict(
            tiny_config(), kv_bits=8, weight_bits=0),
        counters={"decode_steps": fx["decode_steps"]},
        state={"traced_batches": calls})


def test_union_of_overlapping_intervals():
    covered, gaps = trace.union_us(
        [(0, 10), (5, 15), (20, 30), (25, 26), (40, 60), (-5, 2)], 0, 50)
    assert covered == 15 + 10 + 10
    assert gaps == [(15, 20), (30, 40)]


def test_union_of_nothing_is_one_gap():
    assert trace.union_us([], 3, 7) == (0.0, [(3, 7)])


def test_busy_and_idle_of_the_recorded_trace():
    s = recorded()
    # inside [1000, 2000]: 10 + 80 (gemv and the pair overlap) + 10 + 50
    assert trace.busy_s(s.tracer.trace) == pytest.approx(150e-6)
    assert s.tracer.trace.window_s == pytest.approx(1e-3)
    for name in ("device_idle_pct.batch", "device_idle_pct.stream",
                 "device_idle_pct.sat"):
        assert reader(name)(s) == pytest.approx(85.0)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    gaps = trace.idle_gaps(recorded().tracer.trace)
    assert [g[0] for g in gaps] == ["cudaStreamSynchronize", "aten::mul",
                                    "python (no op)"]
    assert [g[1] for g in gaps] == pytest.approx([440e-6, 320e-6, 90e-6])


def test_device_ops_by_time():
    ops = trace.device_ops(recorded().tracer.trace)
    assert ops[0] == ["gemv_kernel<2, true, 16, 0>", pytest.approx(110e-6)]
    assert len(ops) == 6


def test_kernels_and_step_device_time():
    s = recorded()
    assert reader("kernels_per_step.batch")(s) == 5 / 2  # copies excluded
    # two gemvs (110 + 50 us) and the pair (20 + 20 us) over two steps
    assert reader("step_device_ms.batch")(s) == pytest.approx(0.1)


def test_rooflines_of_the_recorded_trace():
    s = recorded()
    gpt = s.config["gpt"]
    L = gpt["num_hidden_layers"]
    want_gemv = want_attn = 0.0
    for k in range(2):
        b = roofline.kernel_bounds(gpt, [10 + k + 1, 20 + k + 1], 8, 0)
        want_gemv += L * sum(b[r][0] for r in readers.GEMVS)
        want_attn += L * b["attention pair"][0]
    assert reader("gemv_roofline_pct.batch")(s) == pytest.approx(
        100 * want_gemv / 0.160)
    assert reader("attention_roofline_pct.batch")(s) == pytest.approx(
        100 * want_attn / 0.040)


def test_step_mfu_of_the_recorded_trace():
    s = recorded()
    gpt = s.config["gpt"]
    P = 4 * 256 * 256 + 3 * 256 * 512
    L, D = 2, 256
    heads = 2 * D * 626 * 4
    flops = (2 * L * P * 30 + L * 4 * D * (10 * 11 + 20 * 21) / 2
             + 2 * (2 * L * P + heads) + L * 4 * D * (11 + 21)
             + 2 * (2 * L * P + heads) + L * 4 * D * (12 + 22))
    assert roofline.layer_params(gpt) == P
    assert reader("step_mfu_pct.batch")(s) == pytest.approx(
        100 * flops / (1e-3 * 989e12))


def test_readers_find_nothing_to_read_without_a_trace():
    s = SimpleNamespace(tracer=SimpleNamespace(trace=None), counters={},
                        state={}, config={})
    for name in ("kernels_per_step.batch", "step_device_ms.batch",
                 "gemv_roofline_pct.batch", "attention_roofline_pct.batch",
                 "step_mfu_pct.batch", "device_idle_pct.batch",
                 "engine_step_ms.stream", "slot_fill_pct.sat",
                 "queue_delay_p90_ms.stream"):
        assert reader(name)(s) is None, name


def records_session():
    recs = [Record(key=0, due=0.0, start=0.0, end=2.0, first=0.5,
                   chunks=[0.5, 1.0, 1.75], audio_s=4.0, ok=True),
            Record(key=1, due=1.0, start=1.0, end=3.0, first=2.0,
                   chunks=[2.0, 2.25], audio_s=2.0, ok=True),
            Record(key=2, due=2.0, start=2.0, end=None, first=None,
                   chunks=[], ok=False),
            Record(key=3, due=3.0, start=3.0, end=None, first=3.5,
                   chunks=[3.5], ok=True)]
    return SimpleNamespace(records=recs, seconds=3.5, window_s=5.0,
                           setup_s=12.5, counters={
                               "queue_delay_p90_s": 0.25,
                               "engine_step_s": 3.0, "decode_steps": 600,
                               "steps": 100, "tokens_generated": 1200,
                               "slots": 16})


def test_end_to_end_readers_on_records():
    s = records_session()
    # records that started before the deadline and finished: 4 + 2 + 0
    # audio seconds (the last has audio but no end: it counts as ok with
    # no audio seconds of its own here)
    assert reader("audio_s_per_s")(s) == pytest.approx(6.0 / 5.0)
    # first audio 0.5, 1.0, never (window 5.0 - 2.0), 0.5 s after due
    ttfa = sorted([500.0, 1000.0, 3000.0, 500.0])
    import numpy as np
    assert reader("ttfa_p95_ms")(s) == pytest.approx(np.percentile(ttfa, 95))
    gaps = [500.0, 750.0, 250.0, 1500.0]   # the cut stream: to 5.0 s
    assert reader("chunk_gap_p95_ms")(s) == pytest.approx(
        np.percentile(gaps, 95))
    assert reader("setup_s")(s) == 12.5


def test_counter_and_span_readers():
    s = records_session()
    assert reader("queue_delay_p90_ms.stream")(s) == pytest.approx(250.0)
    assert reader("engine_step_ms.stream")(s) == pytest.approx(5.0)
    assert reader("slot_fill_pct.sat")(s) == pytest.approx(75.0)
