"""The port's continuous-batching Engine: against the JAX Engine, and the
behaviours of tests/test_engine.py that this slice covers (CPU).

Parity.  The JAX Engine runs its fused path (``CHATTTS_PALLAS_STEP=1``: the
Pallas whole-step kernel in interpret mode, per-slot ``cur``, int8 KV cache);
the port's runs the plain version of K2+K3 with its own threefry noise, which
reproduces the reference's (tests/test_torch_sampling_rows.py).  Both get the
same bridged weights and the same seeded requests, more requests than slots.
Logits of the two differ by a few bf16 ulps, and the draw adds its noise in
sorted space, so a free-running comparison may swap two near-equal scores;
the port is therefore teacher-forced with the reference's tokens (its own
draw is still made at every step and must agree on at least 0.8 of them;
measured: 18 of 20 slot-steps).  Then admission order, finish order, lengths, finish
reasons, prefill and step counts are equal, and the kept hiddens agree
within atol 0.05 (O(1) values; the repository's kernel tolerance, which
also covers the int8 cache's rounding).

Behaviours run on the tiny config with the port's own seeded weights.
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.engine import batching as jb
from chattts_tpu.models import embed as je
from chattts_tpu.models import llama as jl
from chattts_tpu_torch.engine import batching as tb
from chattts_tpu_torch.engine.generate import Interrupt
from chattts_tpu_torch.models import embed as te
from chattts_tpu_torch.models import llama as tl
from chattts_tpu_torch.ops import decode_step as ds
from torch_port_utils import bridge, port_config

HIDDEN_ATOL = 0.05
EOS_SCALE = 8.0


# ---------------------------------------------------------------------------
# parity with the JAX Engine
# ---------------------------------------------------------------------------

FUSED_CFG = GPTConfig(hidden_size=128, intermediate_size=256,
                      num_attention_heads=2, num_hidden_layers=2,
                      max_position_embeddings=128, num_audio_tokens=626,
                      num_text_tokens=300, num_vq=4)


def _parity_requests(cls, cfg, n=5):
    rng = np.random.default_rng(3)
    return [cls(
        request_id=f"f{i}",
        ids=rng.integers(5, 50, (5 + 2 * (i % 5), cfg.num_vq)
                         ).astype(np.int32),
        text_mask=np.ones((5 + 2 * (i % 5),), bool),
        temperature=np.full((cfg.num_vq,), 0.7, np.float32),
        top_p=0.8, top_k=15, repetition_penalty=1.05,
        # request 1 cannot stop on EOS: a length finish among EOS finishes
        min_new=6 if i == 1 else 2 + (i % 2), max_new=5 + i % 8,
        seed=40 + i)
        for i in range(n)]


def _drain(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    outs, order = {}, []
    while eng.has_unfinished():
        for o in eng.step(long_chunk=True):
            outs[o.request_id] = o
            order.append(o.request_id)
    return outs, order


def _teacher_forced_parity(monkeypatch, n_requests, min_agree=0.8,
                           **geom):
    """The JAX Engine (``CHATTTS_PALLAS_STEP=1``, int8 cache asked for) and
    the port's Engine (the int8 cache asked for) of one geometry on the same
    weights and seeded requests, the port teacher-forced with the
    reference's tokens.  Holds admission and finish order, ids, finish
    reasons, hiddens and the engine counters equal, and the port's own
    draws equal to the reference's on at least ``min_agree`` of the
    slot-steps; returns (the JAX engine, the port's)."""
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "1")
    monkeypatch.delenv("CHATTTS_KV_INT8", raising=False)
    cfg = FUSED_CFG
    gp = jl.init_params(jax.random.PRNGKey(0), cfg)
    ep = je.init_params(jax.random.PRNGKey(1), cfg)
    ep["head_code"] = ep["head_code"].at[
        :, :, cfg.num_audio_tokens - 1].multiply(EOS_SCALE)
    geom = dict(max_prompt_len=16, max_new_tokens=12, prompt_buckets=(8, 16),
                **geom)
    jb._build_kernels.cache_clear()
    try:
        jeng = jb.Engine(cfg, jb.EngineConfig(**geom), gp, ep)
        ref, ref_order = _drain(
            jeng, _parity_requests(jb.EngineRequest, cfg, n_requests))
    finally:
        jb._build_kernels.cache_clear()
    assert {o.finish_reason for o in ref.values()} == {"eos", "length"}

    pcfg = port_config(cfg)
    eng = tb.Engine(pcfg, tb.EngineConfig(**geom), bridge(gp), bridge(ep))
    eos = cfg.num_audio_tokens - 1
    nvq = cfg.num_vq
    real_sample = tb.sampling.sample
    agree = []

    def teacher(logits, *args, **kwargs):
        own = real_sample(logits, *args, **kwargs).reshape(-1, nvq)
        depth = args[3].reshape(-1, nvq)[:, 0].tolist()
        want = own.clone()
        for s, req in enumerate(eng.slots):
            if req is None:
                continue
            ids = ref[req.request_id].ids
            g = depth[s]
            if g < len(ids):
                want[s] = torch.from_numpy(ids[g].astype(np.int64))
                agree.append(bool(torch.equal(own[s], want[s])))
            elif ref[req.request_id].finish_reason == "eos":
                want[s] = eos
        return want.reshape(-1)

    monkeypatch.setattr(tb.sampling, "sample", teacher)
    got, order = _drain(eng, _parity_requests(tb.EngineRequest, pcfg,
                                              n_requests))

    assert order == ref_order
    for rid, r in ref.items():
        g = got[rid]
        np.testing.assert_array_equal(g.ids, r.ids)
        assert g.finish_reason == r.finish_reason
        assert g.ids.dtype == np.int32
        np.testing.assert_allclose(g.host_hiddens(), r.host_hiddens(),
                                   atol=HIDDEN_ATOL)
    for key in ("prefills", "steps", "requests_finished", "tokens_generated",
                "peak_slots"):
        assert eng.stats[key] == jeng.stats[key], key
    assert np.mean(agree) >= min_agree, np.mean(agree)
    print(f"own draws equal to the reference's: {np.mean(agree):.3f} "
          f"of {len(agree)}")
    return jeng, eng


@pytest.mark.parametrize("chunk_steps", [4, 3])
def test_engine_matches_jax_engine_teacher_forced(monkeypatch, chunk_steps):
    jeng, eng = _teacher_forced_parity(
        monkeypatch, 5, max_num_seqs=2, chunk_steps=chunk_steps,
        chunk_steps_max=chunk_steps)
    assert jeng._fused and jeng._kvb == 8
    assert eng.kv_bits == 8 and eng.state.kc.dtype == torch.int8


def test_engine_past_its_slot_limit_matches_jax_engine_teacher_forced(
        monkeypatch, caplog):
    """More slots than ``fused_slot_limit(8)``, the int8 cache asked for:
    the JAX Engine leaves its kernel for its XLA step on a bf16 cache, and
    the port's serves on the bf16 cache (K2 on the card) and says so;
    both take 40 requests on 33 slots, 7 of them queued.  The XLA step
    keeps its residual in bf16 where the kernel and the port keep f32, so
    near-tied draws part more often than against the fused kernel: the
    port's own draws (all four codebooks of a slot-step) equal the
    reference's on 0.762 of 244 slot-steps (against the fused kernel at 2
    slots on the same 40 requests: 0.818 of 121; with the port's seeds
    moved, so its noise is not the reference's: 0.0), hence 0.7."""
    S = tb.fused_slot_limit(8) + 1
    with caplog.at_level("WARNING", logger=tb.__name__):
        jeng, eng = _teacher_forced_parity(
            monkeypatch, 40, min_agree=0.7, max_num_seqs=S, chunk_steps=4,
            chunk_steps_max=4)
    assert not jeng._fused and jeng._kvb == 0
    assert eng.kv_bits == 0 and eng.state.kc.dtype == torch.bfloat16
    assert eng.state.kc.shape[1] == S and eng.stats["peak_slots"] == S
    assert sum("bf16 cache" in r.getMessage() for r in caplog.records) == 1


# ---------------------------------------------------------------------------
# behaviours (tiny config, the port's own weights)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model(tiny_config):
    cfg = port_config(tiny_config.gpt)
    gen = torch.Generator().manual_seed(0)
    return cfg, tl.init_params(gen, cfg), te.init_params(gen, cfg)


def _mk_engine(model, **kw):
    cfg, gp, ep = model
    kv_bits = kw.pop("kv_bits", 8)
    defaults = dict(max_num_seqs=4, max_prompt_len=16, max_new_tokens=12,
                    chunk_steps=4, infer_text=False, collect_hidden=True)
    defaults.update(kw)
    return tb.Engine(cfg, tb.EngineConfig(**defaults), gp, ep,
                     kv_bits=kv_bits)


def _req(cfg, rid, n=6, **kw):
    # crc32, not hash(): the prompt must not change from run to run
    rng = np.random.default_rng(zlib.crc32(rid.encode()) % 1000)
    d = dict(
        request_id=rid,
        ids=rng.integers(5, 50, (n, cfg.num_vq)).astype(np.int32),
        text_mask=np.ones((n,), bool),
        temperature=np.full((cfg.num_vq,), 0.7, np.float32),
        min_new=2, max_new=8)
    d.update(kw)
    return tb.EngineRequest(**d)


@pytest.mark.parametrize("kv_bits", [8, 0])
def test_offline_generate_batch(model, kv_bits):
    cfg = model[0]
    eng = _mk_engine(model, kv_bits=kv_bits)
    assert eng.state.kc.dtype == (torch.int8 if kv_bits else torch.bfloat16)
    reqs = [_req(cfg, f"r{i}", n=4 + i) for i in range(6)]  # > slots
    outs = eng.generate(reqs)
    assert [o.request_id for o in outs] == [f"r{i}" for i in range(6)]
    for o in outs:
        assert o.ids.ndim == 2 and o.ids.shape[1] == cfg.num_vq
        assert 0 <= o.ids.shape[0] <= 8
        assert o.host_hiddens().shape == (o.ids.shape[0], cfg.hidden_size)
        assert np.isfinite(o.host_hiddens()).all()
        assert o.finish_reason in ("eos", "length")
        assert (o.ids < cfg.num_audio_tokens - 1).all()  # EOS is never kept
    assert not eng.has_unfinished()
    assert ds.decode_step.launches == 0  # the CPU path launches no kernel


def test_length_finish_keeps_all_tokens(model):
    eng = _mk_engine(model)
    # min_new == max_new: EOS suppressed throughout -> always a length finish
    outs = eng.generate([_req(model[0], "r0", min_new=8, max_new=8)])
    assert outs[0].finish_reason == "length"
    assert outs[0].ids.shape[0] == 8


def test_continuous_admission(model):
    """More requests than slots: later requests are admitted as slots free."""
    eng = _mk_engine(model, max_num_seqs=2)
    outs = eng.generate([_req(model[0], f"r{i}") for i in range(5)])
    assert len(outs) == 5
    assert eng.stats["prefills"] == 5
    assert eng.stats["requests_finished"] == 5
    assert eng.stats["peak_slots"] == 2


def test_streaming_callback(model):
    eng = _mk_engine(model, chunk_steps=2)
    got = []
    req = _req(model[0], "s0", min_new=6, max_new=8,
               on_tokens=lambda rid, ids, hid, fin: got.append(
                   (ids.shape[0], hid.shape, fin)))
    eng.add_request(req)
    outs = []
    while eng.has_unfinished():
        outs.extend(eng.step())  # the serving quantum: chunks of 2 steps
    assert sum(g[0] for g in got) == outs[0].ids.shape[0]
    assert all(g[1] == (g[0], model[0].hidden_size) for g in got)
    assert [g[2] for g in got][-1] is True and len(got) >= 3
    # a host streamer's output carries host hiddens, no device copy
    assert outs[0].dev_hiddens() is None and outs[0].hiddens is not None


def test_abort(model):
    cfg = model[0]
    eng = _mk_engine(model)
    eng.add_request(_req(cfg, "a0", max_new=8))
    eng.add_request(_req(cfg, "a1", max_new=8))
    dropped = eng.abort_request("a1")  # still waiting
    assert dropped is not None and dropped.request_id == "a1"
    eng.step()  # admits and runs a0
    assert eng.abort_request("a0")  # now running
    assert not eng.abort_request("missing")
    assert not eng.has_unfinished()
    assert not bool(eng.state.active.any())


def test_abort_notifies_streaming_consumer(model):
    cfg = model[0]
    eng = _mk_engine(model, max_num_seqs=1, chunk_steps=2)
    events = {"queued": [], "running": []}
    eng.add_request(_req(
        cfg, "run", min_new=8, max_new=12,
        on_tokens=lambda rid, ids, hid, fin: events["running"].append(
            (ids is None, fin))))
    eng.add_request(_req(
        cfg, "queue", max_new=8,
        on_tokens=lambda rid, ids, hid, fin: events["queued"].append(
            (ids is None, fin))))
    eng.step()  # admits "run" (1 slot); "queue" stays waiting
    assert eng.abort_request("run")
    assert eng.abort_request("queue")
    assert events["running"][-1] == (True, True)
    assert events["queued"][-1] == (True, True)
    assert not eng.has_unfinished()


def test_text_mode(model):
    cfg = model[0]
    eng = _mk_engine(model, infer_text=True,
                     text_eos_token=cfg.num_text_tokens - 1,
                     collect_hidden=False)
    outs = eng.generate([_req(cfg, "t0", temperature=np.asarray([0.7]))])
    assert outs[0].ids.ndim == 1
    assert outs[0].hiddens is None and outs[0].dev_hiddens() is None
    assert (outs[0].ids != cfg.num_text_tokens - 1).all()


@pytest.mark.parametrize("kv_bits", [8, 0])
def test_per_request_seed_deterministic_across_loads(model, kv_bits):
    """The same seed gives the same tokens and hiddens whatever the
    co-resident requests, the slot and the engine's history."""
    cfg = model[0]
    mk = lambda: _req(cfg, "det", n=6, min_new=4, max_new=8, seed=1234)
    out_alone = _mk_engine(model, kv_bits=kv_bits).generate([mk()])[0]
    eng2 = _mk_engine(model, kv_bits=kv_bits)
    others = [_req(cfg, f"o{i}", n=4 + i, min_new=2, max_new=6)
              for i in range(3)]
    outs = eng2.generate(others + [mk()])
    out_busy = next(o for o in outs if o.request_id == "det")
    np.testing.assert_array_equal(out_alone.ids, out_busy.ids)
    # after the engine has history: other slot, other neighbours
    again = eng2.generate([_req(cfg, "pre", max_new=3), mk()])[1]
    np.testing.assert_array_equal(out_alone.ids, again.ids)
    np.testing.assert_allclose(out_alone.host_hiddens(),
                               again.host_hiddens(), atol=1e-4)


def test_unseeded_requests_differ(model):
    cfg = model[0]
    eng = _mk_engine(model)
    a, b = eng.generate([_req(cfg, "same", min_new=8, max_new=8),
                         _req(cfg, "same", min_new=8, max_new=8)])
    assert (a.ids != b.ids).any()


def test_per_request_eos_token(model):
    cfg = model[0]
    eng = _mk_engine(model, infer_text=True,
                     text_eos_token=cfg.num_text_tokens - 1,
                     collect_hidden=False)
    custom_eos = 7
    out = eng.generate([_req(cfg, "e0", temperature=np.asarray([0.7]),
                             min_new=0, max_new=10, seed=5,
                             eos_token=custom_eos,
                             ensure_non_empty=False)])[0]
    assert (out.ids != custom_eos).all()


def test_ensure_non_empty_retries(model):
    """An immediate EOS re-dispatches the request with the attempt folded
    into its key; attempts are bounded; a streaming consumer sees exactly
    one finished=True."""
    cfg, gp, ep = model
    eos = cfg.num_audio_tokens - 1
    pids = np.full((6, cfg.num_vq), 7, np.int32)
    tmask = np.ones((6,), bool)
    # an EOS head column aligned with the prompt's last hidden, so that the
    # EOS logit dominates whatever the weights
    emb = te.embed_prompt(ep, torch.from_numpy(pids).long()[None],
                          torch.from_numpy(tmask)[None])
    h_all, _ = tl.prefill(gp, emb, torch.ones((1, 6), dtype=torch.bool),
                          torch.arange(6)[None], tl.KVCache.create(cfg, 1, 6),
                          cfg)
    head = torch.zeros_like(ep["head_code"], dtype=torch.float32)
    head[:, :, eos] = 50.0 * torch.sign(h_all[0, -1])[None, :]
    eparams = dict(ep, head_code=head.to(ep["head_code"].dtype))

    def req(rid, ensure):
        return tb.EngineRequest(
            request_id=rid, ids=pids, text_mask=tmask,
            temperature=np.full((cfg.num_vq,), 0.7, np.float32),
            top_k=1, min_new=0, max_new=8, ensure_non_empty=ensure)

    ecfg = tb.EngineConfig(max_num_seqs=2, max_prompt_len=16,
                           max_new_tokens=8, chunk_steps=4)
    eng = tb.Engine(cfg, ecfg, gp, eparams)
    keys = []
    prefill = eng._prefill_wave
    eng._prefill_wave = lambda Tpb, group: (prefill(Tpb, group), keys.append(
        eng.state.rng[group[0][0]].tolist()))[0]
    out = eng.generate([req("r0", True)])[0]
    assert out.ids.shape[0] == 0
    assert eng.stats.get("retries") == 3
    assert len(keys) == 4 and len({tuple(k) for k in keys}) == 4

    eng2 = tb.Engine(cfg, ecfg, gp, eparams)
    eng2.generate([req("r1", False)])
    assert not eng2.stats.get("retries")

    eng3 = tb.Engine(cfg, ecfg, gp, eparams)
    notes = []
    r = req("r2", True)
    r.on_tokens = lambda rid, ids, hid, fin: notes.append(fin)
    eng3.generate([r])
    assert eng3.stats.get("retries") == 3
    assert [f for f in notes if f] == [True] and notes[-1] is True


def test_preemption_admits_short_request_and_resume_is_token_exact(model):
    """With every slot held by long requests a short one still gets in
    (preemption by recompute), no generated work is lost, and the resumed
    request returns the tokens of an undisturbed run.

    A resume recomputes the prefix with the prefill, whose roundings are not
    the decode step's (hiddens move by about 0.015), so the tokens are equal
    only while no draw after the resume sits on a margin that thin.  The
    requests sample among 3 candidates at temperature 3, which keeps the
    scores' shift small against the Gumbel noise, and their prompts are
    pinned: of 8 such pairs 7 resume token-exact, in both cache tiers."""
    cfg = model[0]
    wide = dict(temperature=np.full((cfg.num_vq,), 3.0, np.float32),
                top_k=3, top_p=1.0)
    longs = lambda: [_req(cfg, name, n=4, min_new=12, max_new=12, seed=i,
                          **wide) for i, name in enumerate("AB")]
    calm = {o.request_id: o for o in _mk_engine(
        model, max_num_seqs=2, chunk_steps=2,
        max_new_tokens=16).generate(longs())}

    eng = _mk_engine(model, max_num_seqs=2, chunk_steps=2,
                     max_new_tokens=16, preempt_after_chunks=1)
    for r in longs():
        eng.add_request(r)
    outs, finished_order = list(eng.step()), []
    eng.add_request(_req(cfg, "short", n=4, min_new=2, max_new=2, seed=9))
    while eng.has_unfinished():
        for o in eng.step():
            finished_order.append(o.request_id)
            outs.append(o)
    assert eng.stats.get("preemptions", 0) > 0
    assert finished_order[0] == "short"
    by_id = {o.request_id: o for o in outs}
    assert by_id["short"].ids.shape[0] == 2
    for name in "AB":
        o = by_id[name]
        assert o.ids.shape[0] == 12  # resumed and new tokens, none lost
        assert o.host_hiddens().shape == (12, cfg.hidden_size)
        np.testing.assert_array_equal(o.ids, calm[name].ids)
        np.testing.assert_allclose(o.host_hiddens(),
                                   calm[name].host_hiddens(), atol=0.05)


def test_engine_interrupt_drains(model):
    cfg = model[0]
    eng = _mk_engine(model)
    ctx = Interrupt()
    eng.add_request(_req(cfg, "i0", min_new=8, max_new=8))
    eng.step()
    ctx.set(True)
    outs = eng.generate([_req(cfg, "i1", min_new=8, max_new=8)], context=ctx)
    assert outs == []
    assert not eng.has_unfinished()
    # reusable afterwards
    assert len(eng.generate([_req(cfg, "i2", max_new=4)])) == 1


def test_prompt_too_long_rejected(model):
    eng = _mk_engine(model)
    with pytest.raises(ValueError, match="prompt length"):
        eng.add_request(_req(model[0], "x", n=20))


def test_prompt_buckets(model):
    """Short prompts prefill in a small bucket, long ones in a larger one;
    the bucket does not change a seeded request's tokens."""
    cfg = model[0]
    eng = _mk_engine(model, prompt_buckets=(8, 16))
    seen = []
    prefill = eng._prefill_wave
    eng._prefill_wave = lambda Tpb, group: (seen.append((Tpb, len(group))),
                                            prefill(Tpb, group))[1]
    mk = lambda: [_req(cfg, "b0", n=5, min_new=3, max_new=6, seed=1),
                  _req(cfg, "b1", n=12, min_new=3, max_new=6, seed=2)]
    outs = eng.generate(mk())
    assert sorted(seen) == [(8, 1), (16, 1)]
    for o in outs:
        assert 3 <= o.ids.shape[0] <= 6
    one = _mk_engine(model).generate(mk())  # a single 16-wide bucket
    for a, b in zip(outs, one):
        np.testing.assert_array_equal(a.ids, b.ids)


def test_prompt_bucket_validation(model):
    cfg, gp, ep = model
    ecfg = tb.EngineConfig(max_num_seqs=2, max_prompt_len=16,
                           max_new_tokens=8, prompt_buckets=(8, 32))
    with pytest.raises(ValueError, match="bucket"):
        tb.Engine(cfg, ecfg, gp, ep)


def test_slot_limit_follows_the_cache(model):
    """Up to its tier's limit an engine keeps the cache it was asked for;
    past it, it serves as the reference does: the bf16 cache and bf16
    weights (the reference's XLA step), whatever tier was asked for."""
    cfg, gp, ep = model
    assert (tb.fused_slot_limit(8), tb.fused_slot_limit(0),
            tb.fused_slot_limit(4)) == (32, 16, 64)
    wide = tb.EngineConfig(max_num_seqs=32, max_prompt_len=8,
                           max_new_tokens=8)
    eng = tb.Engine(cfg, wide, gp, ep)
    assert eng.kv_bits == 8 and eng.state.kc.shape[1] == 32
    assert eng.state.kc.dtype == torch.int8
    eng = tb.Engine(cfg, wide, gp, ep, kv_bits=0)
    assert eng.kv_bits == 0 and eng.state.kc.dtype == torch.bfloat16
    past = tb.EngineConfig(max_num_seqs=33, max_prompt_len=8,
                           max_new_tokens=8)
    qcfg = port_config(FUSED_CFG)  # a geometry that takes int8 weights
    gen = torch.Generator().manual_seed(0)
    qgp, qep = tl.init_params(gen, qcfg), te.init_params(gen, qcfg)
    eng = tb.Engine(qcfg, past, qgp, qep,
                    packed=ds.pack_weights(qgp, qcfg, weight_bits=8))
    assert eng.kv_bits == 0 and eng.state.kc.dtype == torch.bfloat16
    assert tuple(eng.state.kc.shape[1:3]) == (33, 16)
    assert ds.weight_bits_of(eng.packed, qcfg) == 0
    assert len(eng.generate([_req(qcfg, "p0", n=5, max_new=4, seed=1)])) == 1
    with pytest.raises(ValueError, match="kv_bits"):
        tb.Engine(cfg, tb.EngineConfig(max_num_seqs=2), gp, ep, kv_bits=4)


def test_long_chunks_match_short_chunks(model):
    cfg = model[0]
    mk = lambda: _mk_engine(model, max_num_seqs=4, chunk_steps=2,
                            max_new_tokens=16)
    reqs = lambda: [_req(cfg, f"c{i}", min_new=4, max_new=10, seed=i)
                    for i in range(3)]
    eng_long = mk()
    assert eng_long.ecfg.chunk_steps_max >= 16
    outs_long = eng_long.generate(reqs())  # generate() opts into long chunks
    eng_short = mk()
    for r in reqs():
        eng_short.add_request(r)
    outs_short = []
    while eng_short.has_unfinished():
        outs_short.extend(eng_short.step())  # the serving quantum
    by_id = {o.request_id: o for o in outs_short}
    for o in outs_long:
        np.testing.assert_array_equal(o.ids, by_id[o.request_id].ids)
    longest = max(o.ids.shape[0] for o in outs_long)
    # a chunk is bounded by the most steps a slot can still take, and the
    # steps statistic counts the steps in which a slot was live
    assert eng_long.stats["steps_launched"] <= 10
    assert longest <= eng_long.stats["steps"] <= eng_long.stats["steps_launched"]
    assert eng_short.stats["steps"] == eng_long.stats["steps"]


def test_speculation_equivalence(model):
    cfg = model[0]
    outs = {}
    for spec in (True, False):
        eng = _mk_engine(model, chunk_steps=2, speculate=spec)
        rs = [_req(cfg, f"q{i}", min_new=3, max_new=9, seed=100 + i)
              for i in range(3)]
        outs[spec] = eng.generate(rs)
        assert not eng.has_unfinished()
    for a, b in zip(outs[True], outs[False]):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.host_hiddens(), b.host_hiddens())


def test_engine_chaos_invariants(model):
    """Interleaved admissions, aborts, long and short requests and a mid-run
    interrupt never strand work: every request finishes within its bounds
    or is accounted for as dropped, and the engine ends drained."""
    cfg = model[0]
    eng = _mk_engine(model, max_num_seqs=2, chunk_steps=2,
                     max_new_tokens=16, preempt_after_chunks=2)
    rng = np.random.default_rng(0)
    submitted, finished, aborted = {}, {}, set()
    k = 0
    for it in range(60):
        if rng.random() < 0.5 and len(submitted) < 20:
            n = int(rng.integers(2, 12))
            r = _req(cfg, f"x{k}", min_new=min(2, n), max_new=n, seed=k)
            submitted[r.request_id] = n
            eng.add_request(r)
            k += 1
        if rng.random() < 0.15 and submitted:
            rid = rng.choice([r for r in submitted
                              if r not in finished and r not in aborted] or
                             list(submitted))
            if eng.abort_request(rid):
                aborted.add(rid)
        for o in eng.step():
            finished[o.request_id] = o
    dropped = {r.request_id for r in eng.interrupt()}
    assert not eng.has_unfinished()
    for rid, max_n in submitted.items():
        if rid in finished:
            o = finished[rid]
            assert 0 <= o.ids.shape[0] <= max_n
            assert o.host_hiddens().shape[0] == o.ids.shape[0]
            assert o.finish_reason in ("eos", "length")
        else:
            assert rid in aborted or rid in dropped, rid
    assert finished
    outs = eng.generate([_req(cfg, "post", min_new=2, max_new=4, seed=1)])
    assert len(outs) == 1 and outs[0].ids.shape[0] >= 2


def test_outputs_to_generation_on_device(model):
    cfg = model[0]
    # (a) equal lengths: all finish in one chunk and share one gather
    eng = _mk_engine(model)
    outs = eng.generate([_req(cfg, f"d{i}", min_new=6, max_new=6, seed=i)
                         for i in range(3)])
    assert all(o._hb is not None and o._hb is outs[0]._hb for o in outs)
    g = tb.outputs_to_generation(outs)
    assert g.hiddens_dev.shape == (3, 6, cfg.hidden_size)
    ends = g.end_dev.numpy()
    for i, o in enumerate(outs):
        n = o.host_hiddens().shape[0]
        assert ends[i] == n == o.ids.shape[0]
        np.testing.assert_array_equal(g.hiddens_dev[i, :n].numpy(),
                                      o.host_hiddens())
    # (b) mixed lengths finish in different chunks: pad and stack
    eng = _mk_engine(model)
    outs = eng.generate([_req(cfg, f"m{i}", min_new=3, max_new=3 + 4 * i,
                              seed=i) for i in range(3)])
    g = tb.outputs_to_generation(outs)
    ends = g.end_dev.numpy()
    assert g.hiddens_dev.shape == (3, int(ends.max()), cfg.hidden_size)
    for i, o in enumerate(outs):
        n = o.host_hiddens().shape[0]
        assert ends[i] == n
        np.testing.assert_array_equal(g.hiddens_dev[i, :n].numpy(),
                                      o.host_hiddens())
        if len({int(e) for e in ends}) > 1:
            assert not g.hiddens_dev[i, n:].any()
    # (c) a host streamer's hiddens come back as host copies
    req = _req(cfg, "s", min_new=3, max_new=6, on_tokens=lambda *a: None)
    g = tb.outputs_to_generation(_mk_engine(model).generate([req]))
    assert g.hiddens_dev is None and len(g.hiddens) == 1


def test_device_streaming_hiddens_and_stream_cap(model):
    """Device streamers get the slot's whole hiddens row; at most
    max_stream_slots of them run at once while other work admits past."""
    cfg = model[0]
    eng = _mk_engine(model, max_num_seqs=3, chunk_steps=2,
                     max_stream_slots=1)
    rows, live_streams = [], []

    def on_tokens(rid, ids, hid, fin):
        rows.append((rid, hid.shape))
        live_streams.append(sum(1 for r in eng.slots if r is not None
                                and r.stream_hiddens_dev))

    reqs = [_req(cfg, f"v{i}", min_new=4, max_new=6, seed=i,
                 on_tokens=on_tokens, stream_hiddens_dev=True)
            for i in range(2)] + [_req(cfg, "plain", max_new=6, seed=5)]
    outs = eng.generate(reqs)
    assert len(outs) == 3 and max(live_streams) == 1
    assert all(shape == (12, cfg.hidden_size) for _, shape in rows)
    assert all(o.dev_hiddens() is not None for o in outs)


def test_engine_latency_stats(model):
    cfg = model[0]
    eng = _mk_engine(model, max_num_seqs=1, chunk_steps=2)
    outs = eng.generate([_req(cfg, "a", min_new=6, max_new=6, seed=1),
                         _req(cfg, "b", min_new=6, max_new=6, seed=2)])
    assert len(outs) == 2
    lat = eng.latency_stats()
    assert lat["queue_delay_n"] == 2 and lat["first_emission_n"] == 2
    delays = sorted(eng._lat_queue)
    assert delays[1] > delays[0] + 1e-4
    assert lat["queue_delay_max_s"] == delays[1]
    assert lat["first_emission_max_s"] > 0.0
    eng.reset_stats()
    assert eng.latency_stats() == {} and eng.stats["steps"] == 0


def test_noise_blocks_do_not_change_the_draws(model, monkeypatch):
    """The noise of a chunk is drawn in blocks of steps; the block length
    is not visible in the tokens."""
    cfg = model[0]
    mk = lambda: [_req(cfg, f"n{i}", n=4 + i, min_new=3, max_new=11,
                       seed=50 + i) for i in range(5)]
    ref = _mk_engine(model, max_num_seqs=2).generate(mk())
    for block in (1, 3):
        monkeypatch.setattr(tb, "NOISE_BLOCK", block)
        got = _mk_engine(model, max_num_seqs=2).generate(mk())
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.ids, b.ids)


def test_chunk_steps_exceeding_max_rejected():
    with pytest.raises(ValueError, match="chunk_steps"):
        tb.EngineConfig(chunk_steps=256, chunk_steps_max=128)


def test_warmup_leaves_the_engine_clean(model):
    cfg = model[0]
    eng = _mk_engine(model, prompt_buckets=(8, 16))
    eng.warmup()
    assert not eng.has_unfinished()
    assert eng.stats["prefills"] == 0 and "peak_slots" not in eng.stats
    cold = _mk_engine(model, prompt_buckets=(8, 16))
    mk = lambda: _req(cfg, "w", min_new=4, max_new=8, seed=3)
    np.testing.assert_array_equal(eng.generate([mk()])[0].ids,
                                  cold.generate([mk()])[0].ids)


def test_no_host_read_inside_a_chunk(model, monkeypatch):
    """The steps of a chunk never read the device back: Tensor.item, tolist,
    cpu, numpy and bool() are made to raise while a chunk's steps run."""
    cfg = model[0]
    eng = _mk_engine(model, chunk_steps=3, speculate=False)
    eng.add_request(_req(cfg, "h", min_new=6, max_new=8, seed=2))
    def guard(fn):
        def guarded(*args):
            with monkeypatch.context() as m:
                def boom(*a, **k):
                    raise AssertionError("host read inside a decode chunk")
                for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                             "__int__", "__float__"):
                    m.setattr(torch.Tensor, name, boom)
                return fn(*args)
        return guarded

    eng._decode_step = guard(eng._decode_step)
    eng._noise_block = guard(eng._noise_block)
    outs = []
    while eng.has_unfinished():
        outs.extend(eng.step())
    assert len(outs) == 1 and outs[0].ids.shape[0] >= 6
