"""The port's span recorder (``chattts_tpu_torch/utils/profiling.py``) and
the spans its layers record, on the CPU.

* With no profiler running, ``span`` returns one shared no-op object and
  records nothing; without the profiler's module flag it stays off.
* Under ``torch.profiler.profile`` spans of the profiling thread and of a
  second thread are recorded with their thread, parent, request ids and
  attributes; the profiling thread's spans agree with their
  host ranges in the profiler's events within 1 ms, and the second
  thread's have none.
* Threads recording at once lose no span and mix no parent.
* The bound keeps ``MAX_SPANS`` records and counts the rest as dropped.
* A Generator call records one ``decode_step`` span per step (per call of
  the step's plain version on the CPU, where no kernel launches and
  ``decode_step.launches`` stays put), each inside a ``generator.steps``
  span, whose ``steps`` add up to the call's steps.
* An Engine that preempts records ``engine.prefill`` spans whose resumed
  tokens add up to the change of ``Engine.stats["recomputed_tokens"]``.
* ``Chat.infer`` and ``TTSService.synthesize`` record the facade's, the
  audio back end's, the Engine's and the service's spans, nested as
  documented.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chattts_tpu_torch import Chat
from chattts_tpu_torch.engine import batching as tb
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.models import embed as te
from chattts_tpu_torch.models import llama as tl
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.serving import TTSService
from chattts_tpu_torch.utils import profiling
from torch_port_utils import port_config


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(recorded, name):
    return [s for s in recorded if s.name == name]


def test_off_without_a_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a = profiling.span("a", rids=("r",), n=1)
    assert a is profiling.span("b")
    with a as entered:
        entered.set(rids=("x",), k=2)
        with profiling.span("c"):
            pass
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_off_when_the_profiler_flag_is_missing(monkeypatch):
    # a torch whose profiler module has no such flag
    monkeypatch.setattr(profiling, "_autograd_profiler", types.ModuleType(
        "torch.autograd.profiler"))
    with traced():
        with profiling.span("a"):
            pass
    assert profiling.spans() == []


def test_spans_of_two_threads_with_parents_ids_and_attributes():
    def worker():
        with profiling.span("w.outer", rids=("r2",)) as sp:
            with profiling.span("w.inner", k=7):
                pass
            sp.set(rids=("r2", "r3"), done=1)

    with traced():
        with profiling.span("m.outer", rows=2):
            with profiling.span("m.inner", rids=["r1"], steps=3):
                t = threading.Thread(target=worker, name="span-test-worker")
                t.start()
                t.join()
    rec = profiling.spans()
    assert sorted(s.name for s in rec) == ["m.inner", "m.outer", "w.inner",
                                           "w.outer"]
    assert [s.index for s in rec] == sorted(s.index for s in rec)
    (mo,), (mi,) = by_name(rec, "m.outer"), by_name(rec, "m.inner")
    (wo,), (wi,) = by_name(rec, "w.outer"), by_name(rec, "w.inner")
    assert mo.tid == mi.tid == threading.get_native_id()
    assert wo.tid == wi.tid == t.native_id != mo.tid
    assert (mo.parent, mi.parent) == (-1, mo.index)
    # the worker's first span has no parent in its own thread
    assert (wo.parent, wi.parent) == (-1, wo.index)
    assert mo.attrs == {"rows": 2} and mi.attrs == {"steps": 3}
    assert mi.rids == ("r1",) and mo.rids == ()
    assert wo.rids == ("r2", "r3") and wo.attrs == {"done": 1}
    assert wi.attrs == {"k": 7}
    for outer, inner in ((mo, mi), (wo, wi), (mi, wo)):
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    assert profiling.thread_names()[t.native_id] == "span-test-worker"


def test_profiling_thread_spans_match_their_host_ranges():
    def worker():
        with profiling.span("other.thread"):
            pass

    with traced() as prof:
        for i in range(40):
            with profiling.span(f"s{i}"):
                torch.ones(16) + i
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    assert "other.thread" not in events  # the profiler sees one thread
    rec = profiling.spans()
    assert len(rec) == 41
    for s in rec:
        if s.name == "other.thread":
            continue
        (e,) = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000, s.name
        assert abs(e.end_ns() - s.end_ns) < 1_000_000, s.name


def test_threads_recording_at_once_lose_no_span():
    threads, each = 16, 100
    errors = []

    def worker():
        try:
            for i in range(each):
                with profiling.span("outer", n=i):
                    with profiling.span("inner"):
                        pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with traced():
            ts = [threading.Thread(target=worker) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in ts)
    rec = profiling.spans()
    assert len(rec) == 2 * threads * each
    assert sorted(s.index for s in rec) == list(range(len(rec)))
    index = {s.index: s for s in rec}
    for s in rec:
        if s.name == "inner":
            outer = index[s.parent]
            assert outer.name == "outer" and outer.tid == s.tid
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        else:
            assert s.parent == -1
    assert len({s.tid for s in rec}) == threads


def test_the_bound_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with traced():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


@pytest.fixture(scope="module")
def model(tiny_config):
    cfg = port_config(tiny_config.gpt)
    gen = torch.Generator().manual_seed(0)
    return cfg, tl.init_params(gen, cfg), te.init_params(gen, cfg)


def test_generator_records_a_decode_step_span_per_step(model, monkeypatch):
    cfg, gp, ep = model
    calls = [0]
    plain = ds.decode_step_plain

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(ds, "decode_step_plain", counted)
    rng = np.random.default_rng(0)
    B, T0 = 2, 9
    req = tg.GenerateRequest(
        ids=rng.integers(1, 600, (B, T0, cfg.num_vq)).astype(np.int32),
        attn_mask=np.ones((B, T0), bool), text_mask=np.ones((B, T0), bool),
        infer_text=False, eos_token=cfg.num_audio_tokens - 1,
        temperature=np.full((cfg.num_vq,), 0.3, np.float32),
        max_new=20, min_new=20, seed=5, return_hidden=True)
    launches = ds.decode_step.launches
    with traced():
        out = list(tg.Generator(cfg, gp, ep, kv_bits=8).generate(req))[-1]
    assert ds.decode_step.launches == launches  # the CPU launches nothing
    rec = profiling.spans()
    index = {s.index: s for s in rec}
    steps = by_name(rec, "decode_step")
    stretches = by_name(rec, "generator.steps")
    assert len(steps) == out.steps == calls[0] == 20
    assert all(index[s.parent].name == "generator.steps" for s in steps)
    assert [s.attrs["steps"] for s in stretches] == [8, 8, 4]
    for st in stretches:
        inside = [s for s in steps if s.parent == st.index]
        assert len(inside) == st.attrs["steps"]
    # a host read between stretches, one prefill, one read of the outputs
    assert len(by_name(rec, "generator.sync")) == 2
    assert len(by_name(rec, "generator.prefill")) == 1
    assert len(by_name(rec, "generator.materialize")) == 1


def _req(cfg, rid, n, **kw):
    rng = np.random.default_rng(sum(map(ord, rid)))
    return tb.EngineRequest(
        request_id=rid, ids=rng.integers(5, 50, (n, cfg.num_vq)
                                         ).astype(np.int32),
        text_mask=np.ones((n,), bool),
        temperature=np.full((cfg.num_vq,), 0.7, np.float32), **kw)


def test_engine_prefill_spans_count_the_recomputed_tokens(model):
    cfg, gp, ep = model
    eng = tb.Engine(cfg, tb.EngineConfig(
        max_num_seqs=2, max_prompt_len=16, max_new_tokens=16, chunk_steps=2,
        preempt_after_chunks=1), gp, ep, kv_bits=8)
    for i, name in enumerate("AB"):
        eng.add_request(_req(cfg, name, 4, min_new=12, max_new=12, seed=i))
    before = eng.stats["recomputed_tokens"]
    with traced():
        eng.step()
        eng.add_request(_req(cfg, "short", 4, min_new=2, max_new=2, seed=9))
        while eng.has_unfinished():
            eng.step()
    assert eng.stats["preemptions"] > 0
    recomputed = eng.stats["recomputed_tokens"] - before
    rec = profiling.spans()
    index = {s.index: s for s in rec}
    prefills = by_name(rec, "engine.prefill")
    resumed = sum(s.attrs["resumed_tokens"] for s in prefills)
    assert resumed == recomputed > 0
    # a resume prefills the prompt (4) and the tokens made so far
    assert recomputed > 4 * sum(s.attrs["resumed_rows"] for s in prefills)
    assert sum(s.attrs["rows"] for s in prefills) == eng.stats["prefills"]
    assert {r for s in prefills for r in s.rids} == {"A", "B", "short"}
    for s in prefills:
        assert index[s.parent].name == "engine.admit"
        assert index[index[s.parent].parent].name == "engine.step"
    finished = [r for s in by_name(rec, "engine.harvest") for r in s.rids]
    assert sorted(finished) == ["A", "B", "short"]
    ran = sum(s.attrs["steps"] for s in by_name(rec, "engine.dispatch"))
    assert ran == eng.stats["steps_launched"]
    assert len(by_name(rec, "decode_step")) == ran
    eng.reset_stats()
    assert eng.stats["recomputed_tokens"] == 0


@pytest.fixture(scope="module")
def chat(tiny_config):
    c = Chat(config=port_config(tiny_config))
    c.load(source="random", seed=0, device="cpu", use_engine=True)
    return c


def _code(**kw):
    return Chat.InferCodeParams(max_new_token=12, min_new_token=12,
                                manual_seed=3, show_tqdm=False, **kw)


def test_chat_infer_records_the_facade_and_the_audio_back_end(chat):
    chat.use_engine = False
    try:
        with traced():
            wavs = chat.infer(["one text", "two"], skip_refine_text=True,
                              split_text=False,
                              params_infer_code=_code())
    finally:
        chat.use_engine = True
    rec = profiling.spans()
    index = {s.index: s for s in rec}
    (top,) = by_name(rec, "chat.infer")
    assert top.attrs == {"rows": 2} and len(wavs) == 2
    (code,) = by_name(rec, "chat.code_pass")
    (dec,) = by_name(rec, "chat.decode_to_wavs")
    assert code.parent == dec.parent == top.index
    assert dec.attrs == {"rows": 2, "frames": 24}
    assert [s.name for s in rec if s.parent == dec.index] == [
        "audio.decoder", "audio.vocos", "audio.to_host"]
    assert index[by_name(rec, "generator.prefill")[0].parent] == code
    assert len(by_name(rec, "decode_step")) == 12


def test_service_records_its_threads(chat):
    svc = TTSService(chat, timeout=60.0)
    got = []
    try:
        with traced():
            t = threading.Thread(target=lambda: got.append(svc.synthesize(
                "hello", params_code=_code(), skip_refine_text=True)))
            t.start()
            t.join(timeout=120)
    finally:
        svc.interrupt()
        svc.close()
    assert len(got) == 1
    rec = profiling.spans()
    index = {s.index: s for s in rec}
    (syn,) = by_name(rec, "service.synthesize")
    assert syn.tid == t.native_id and len(syn.rids) == 1
    children = [s for s in rec if s.parent == syn.index]
    assert [s.name for s in children] == ["service.wait",
                                          "chat.decode_to_wavs"]
    assert children[0].rids == syn.rids
    steps = by_name(rec, "service.step")
    assert steps and {s.tid for s in steps} == {svc._thread.native_id}
    assert {s.tid for s in by_name(rec, "service.lock")} == {
        svc._thread.native_id}
    engine_steps = by_name(rec, "engine.step")
    assert engine_steps and all(index[s.parent].name == "service.step"
                                for s in engine_steps)
    (prefill,) = [s for s in by_name(rec, "engine.prefill")
                  if s.rids == syn.rids]
    assert prefill.attrs["resumed_rows"] == 0
    assert syn.rids[0] in {r for s in by_name(rec, "engine.harvest")
                           for r in s.rids}
