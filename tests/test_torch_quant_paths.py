"""The quantized tiers end to end (CPU): the port's Generator, Engine and
``Chat`` on ``weight_bits`` 8 and 4 and ``kv_bits`` 4, against the JAX
package under the matching environment variables.

The reference runs its fused path (``CHATTTS_PALLAS_STEP=1``: the Pallas
whole-step kernel in interpret mode) with ``CHATTTS_STEP_INT8``,
``CHATTTS_STEP_INT4`` or ``CHATTTS_KV_INT4`` set; the port takes the tier as
arguments and runs the plain versions of K4, K5 and K6.  The geometry is
tests/test_pallas_step.py's CFG4 (kv4 needs HD % 256 == 0).  As in
tests/test_torch_generate.py and tests/test_torch_engine.py the comparison
is teacher-forced: the port's own draw is made at every step, and the loop
is handed the reference's token.  Then ids, lengths, finish reasons and
counts are equal.  Both sides hold the same integers and scales
(tests/test_torch_weight_pack.py, tests/test_torch_kv_quant.py) and differ
by the order of f32 sums and by the prefill's roundings (XLA and torch
round bf16 at other places, so prompt k and v differ by an ulp here and
there before they are quantized).  On the int8 cache the kept hiddens agree
within atol 0.05, the repository's kernel tolerance (measured: 0.016), and
the port's own draw equals the reference's on at least 0.7 of the steps
(measured: 0.88 and 0.90).  On the int4 cache a value that such an ulp
moves across a rounding tie moves by a whole step, 1/7 of its head's
absmax, so the same prompts give caches a few nibbles apart: the hiddens
are held to 0.15 (measured: 0.054; the reference holds its own kv4 step to
0.6 of the XLA step) and the draws to 0.25 (measured: 0.33 to 0.75).  The
step itself is held to 0.05 on equal caches in
tests/test_torch_decode_step_tiers.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chattts_tpu.config import GPTConfig
from chattts_tpu.engine import batching as jb
from chattts_tpu.engine import generate as jg
from chattts_tpu.models import embed as je
from chattts_tpu.models import llama as jl
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import batching as tb
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.ops import kv_quant
from torch_port_utils import JaxGumbel, bridge, forced_tokens, port_config

CFG4 = GPTConfig(hidden_size=256, intermediate_size=512,
                 num_attention_heads=2, num_hidden_layers=2,
                 max_position_embeddings=128, num_audio_tokens=626,
                 num_text_tokens=300, num_vq=4)
PCFG4 = port_config(CFG4)
HD = CFG4.num_attention_heads * CFG4.head_dim
HIDDEN_ATOL = {8: 0.05, 4: 0.15}   # by kv_bits
DRAWS_AGREE = {8: 0.7, 4: 0.25}
EOS_SCALE = 6.0
# (weight_bits, kv_bits): K6 alone, K4 on the default cache, K5 on K6
TIERS = [(0, 4), (8, 8), (4, 4)]


def _set_tier(monkeypatch, weight_bits, kv_bits):
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "1")
    monkeypatch.delenv("CHATTTS_KV_INT8", raising=False)
    for name, on in (("CHATTTS_STEP_INT8", weight_bits == 8),
                     ("CHATTTS_STEP_INT4", weight_bits == 4),
                     ("CHATTTS_KV_INT4", kv_bits == 4)):
        monkeypatch.setenv(name, "1" if on else "0")
    assert jg.kv_quant_bits(CFG4) == kv_bits
    assert (jg.step_int8(), jg.step_int4()) == (weight_bits == 8,
                                               weight_bits == 4)


@pytest.fixture(scope="module")
def models():
    gp = jl.init_params(jax.random.PRNGKey(0), CFG4)
    ep = je.init_params(jax.random.PRNGKey(1), CFG4)
    ep["head_code"] = ep["head_code"].at[
        :, :, CFG4.num_audio_tokens - 1].multiply(EOS_SCALE)
    return gp, ep, bridge(gp), bridge(ep)


@pytest.mark.parametrize("weight_bits,kv_bits", TIERS)
def test_generator_teacher_forced_on_quantized_tiers(models, monkeypatch,
                                                     weight_bits, kv_bits):
    _set_tier(monkeypatch, weight_bits, kv_bits)
    gp, ep, tgp, tep = models
    rng = np.random.default_rng(3)
    B, T0, max_new, seed = 2, 9, 8, 11
    attn = np.ones((B, T0), bool)
    attn[1, :3] = False
    ids = rng.integers(5, 50, (B, T0, CFG4.num_vq)).astype(np.int32)
    ids[~attn] = 0
    eos = CFG4.num_audio_tokens - 1
    kw = dict(ids=ids, attn_mask=attn, text_mask=attn.copy(),
              infer_text=False, eos_token=eos,
              temperature=np.full((CFG4.num_vq,), 0.7, np.float32),
              max_new=max_new, min_new=3, seed=seed, return_hidden=True)
    jg._build_fns.cache_clear()
    try:
        jgen = jg.Generator(CFG4, gp, ep, prefill_bucket=16)
        assert (jgen._packed["W"].dtype == np.int8) == bool(weight_bits)
        ref = next(jgen.generate(jg.GenerateRequest(**kw)))
    finally:
        jg._build_fns.cache_clear()
    ref_hid, end = np.asarray(ref.hiddens_dev), np.asarray(ref.end_dev)
    forced = forced_tokens(CFG4.num_vq, False, eos, max_new, ref.ids)
    real_sample = tg.sampling.sample
    agree, widths = [], set()

    def teacher(logits, *args, **kwargs):
        step = args[3]
        own = real_sample(logits, *args, **kwargs).reshape(B, -1)
        want = torch.from_numpy(forced[step])
        agree.extend(bool(torch.equal(own[b], want[b])) for b in range(B)
                     if step < end[b])
        return want.reshape(-1)

    real_step = ds.decode_step

    def spy(packed, emb, kc, vc, cur, *rest):
        widths.add((kc.dtype, kc.shape[-1], ds.variant_of(kc, cur, packed,
                                                          PCFG4)))
        return real_step(packed, emb, kc, vc, cur, *rest)

    monkeypatch.setattr(tg.sampling, "sample", teacher)
    monkeypatch.setattr(tg.k1, "decode_step", spy)
    packed = ds.pack_weights(tgp, PCFG4, weight_bits=weight_bits)
    gen = tg.Generator(PCFG4, tgp, tep, prefill_bucket=16, kv_bits=kv_bits,
                       packed=packed)
    got = next(gen.generate(tg.GenerateRequest(
        **kw, noise=JaxGumbel(seed, (B * CFG4.num_vq,
                                     CFG4.num_audio_tokens)))))
    name = {0: "k1", 8: "k3", 4: "k6"}[kv_bits] + {0: "", 8: "k4",
                                                   4: "k5"}[weight_bits]
    assert widths == {(torch.int8, kv_quant.row_width(kv_bits, PCFG4), name)}
    assert sum(len(r) for r in ref.ids) > 0
    for g, r in zip(got.ids, ref.ids):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got.finished, ref.finished)
    np.testing.assert_array_equal(got.end_dev.numpy(), end)
    hid = got.hiddens_dev.numpy()
    assert hid.shape == ref_hid.shape
    worst = 0.0
    for s in range(ref_hid.shape[1]):
        rows = end > s
        np.testing.assert_allclose(hid[rows, s], ref_hid[rows, s],
                                   atol=HIDDEN_ATOL[kv_bits])
        if rows.any():
            worst = max(worst, float(np.abs(hid[rows, s]
                                            - ref_hid[rows, s]).max()))
    print(f"w{weight_bits} kv{kv_bits}: hidden max-abs {worst:.4f}, own "
          f"draws equal to the reference's {np.mean(agree):.2f}")
    assert np.mean(agree) >= DRAWS_AGREE[kv_bits], agree


def _engine_requests(cls, n=5):
    rng = np.random.default_rng(3)
    return [cls(
        request_id=f"q{i}",
        ids=rng.integers(5, 50, (5 + 2 * i, CFG4.num_vq)).astype(np.int32),
        text_mask=np.ones((5 + 2 * i,), bool),
        temperature=np.full((CFG4.num_vq,), 0.7, np.float32),
        top_p=0.8, top_k=15, repetition_penalty=1.05,
        min_new=6 if i == 1 else 2 + (i % 2), max_new=5 + i, seed=40 + i)
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


@pytest.mark.parametrize("weight_bits,kv_bits", [(0, 4), (8, 8)])
def test_engine_teacher_forced_on_quantized_tiers(models, monkeypatch,
                                                  weight_bits, kv_bits):
    _set_tier(monkeypatch, weight_bits, kv_bits)
    gp, ep, tgp, tep = models
    geom = dict(max_num_seqs=2, max_prompt_len=16, max_new_tokens=12,
                chunk_steps=4, chunk_steps_max=4, prompt_buckets=(8, 16))
    jb._build_kernels.cache_clear()
    try:
        jeng = jb.Engine(CFG4, jb.EngineConfig(**geom), gp, ep)
        assert jeng._fused and jeng._kvb == kv_bits
        assert (jeng._packed["W"].dtype == np.int8) == bool(weight_bits)
        ref, ref_order = _drain(jeng, _engine_requests(jb.EngineRequest))
    finally:
        jb._build_kernels.cache_clear()

    eng = tb.Engine(PCFG4, tb.EngineConfig(**geom), tgp, tep,
                    packed=ds.pack_weights(tgp, PCFG4, weight_bits),
                    kv_bits=kv_bits)
    assert eng.state.kc.dtype == torch.int8
    assert eng.state.kc.shape[-1] == kv_quant.row_width(kv_bits, PCFG4)
    eos, nvq = CFG4.num_audio_tokens - 1, CFG4.num_vq
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
            if depth[s] < len(ids):
                want[s] = torch.from_numpy(ids[depth[s]].astype(np.int64))
                agree.append(bool(torch.equal(own[s], want[s])))
            elif ref[req.request_id].finish_reason == "eos":
                want[s] = eos
        return want.reshape(-1)

    monkeypatch.setattr(tb.sampling, "sample", teacher)
    got, order = _drain(eng, _engine_requests(tb.EngineRequest))
    assert order == ref_order
    worst = 0.0
    for rid, r in ref.items():
        np.testing.assert_array_equal(got[rid].ids, r.ids)
        assert got[rid].finish_reason == r.finish_reason
        np.testing.assert_allclose(got[rid].host_hiddens(), r.host_hiddens(),
                                   atol=HIDDEN_ATOL[kv_bits])
        worst = max(worst, float(np.abs(
            got[rid].host_hiddens() - r.host_hiddens()).max(initial=0.0)))
    for key in ("prefills", "steps", "requests_finished", "tokens_generated",
                "peak_slots"):
        assert eng.stats[key] == jeng.stats[key], key
    print(f"w{weight_bits} kv{kv_bits}: hidden max-abs {worst:.4f}, own "
          f"draws equal to the reference's {np.mean(agree):.2f} of "
          f"{len(agree)}")
    assert np.mean(agree) >= DRAWS_AGREE[kv_bits], np.mean(agree)


def test_engine_64_slots_on_the_int4_cache(models):
    """The port's counterpart of test_engine_64_slot_kv4_config: 64 slots
    keep a quantized cache only with ``kv_bits=4`` (asked for kv8 or bf16,
    they serve on the bf16 cache, as the reference's engine past its slot
    limit does); 40 requests occupy more than 32 of them at once and every
    one finishes at its length."""
    _, _, tgp, tep = models
    assert [tb.fused_slot_limit(b) for b in (0, 8, 4)] == [16, 32, 64]
    ecfg = tb.EngineConfig(max_num_seqs=64, max_prompt_len=16,
                           max_new_tokens=8, chunk_steps=4)
    for kv_bits in (8, 0):
        past = tb.Engine(PCFG4, ecfg, tgp, tep, kv_bits=kv_bits)
        assert past.kv_bits == 0 and past.state.kc.dtype == torch.bfloat16
    eng = tb.Engine(PCFG4, ecfg, tgp, tep, kv_bits=4,
                    packed=ds.pack_weights(tgp, PCFG4, weight_bits=8))
    assert eng.state.kc.shape == (2, 64, 24, HD // 2 + kv_quant.KV_PAD)
    rng = np.random.default_rng(9)
    reqs = [tb.EngineRequest(
        request_id=f"w{i}",
        ids=rng.integers(5, 50, (4, CFG4.num_vq)).astype(np.int32),
        text_mask=np.ones((4,), bool),
        temperature=np.full((CFG4.num_vq,), 0.7, np.float32),
        min_new=4, max_new=4, seed=100 + i) for i in range(40)]
    outs = eng.generate(reqs)
    assert len(outs) == 40 and eng.stats["peak_slots"] == 40
    for o in outs:
        assert o.ids.shape[0] == 4 and np.isfinite(o.host_hiddens()).all()
    # the same request alone gives the same tokens: 64 rows change no row
    alone = tb.Engine(PCFG4, ecfg, tgp, tep, kv_bits=4,
                      packed=eng.packed).generate([reqs[37]])[0]
    np.testing.assert_array_equal(alone.ids, outs[37].ids)


def test_kv_bits_4_needs_a_packable_geometry(tiny_config):
    cfg = port_config(tiny_config.gpt)      # HD 64
    gen = torch.Generator().manual_seed(0)
    from chattts_tpu_torch.models import embed as te
    from chattts_tpu_torch.models import llama as tl

    gp, ep = tl.init_params(gen, cfg), te.init_params(gen, cfg)
    with pytest.raises(ValueError, match="kv_bits=4"):
        tg.Generator(cfg, gp, ep, kv_bits=4)
    with pytest.raises(ValueError, match="kv_bits must be"):
        tg.Generator(cfg, gp, ep, kv_bits=2)
    with pytest.raises(ValueError, match="kv_bits=4"):
        tb.Engine(cfg, tb.EngineConfig(max_num_seqs=2), gp, ep, kv_bits=4)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

TEXTS = ["hello world.", "speech on a card"]


@pytest.fixture(scope="module")
def quant_config(tiny_config):
    """The tiny config with CFG4's decoder widths (and the mel decoder's
    input to match)."""
    cfg = port_config(tiny_config)
    gpt = dataclasses.replace(cfg.gpt, hidden_size=256, intermediate_size=512,
                              num_attention_heads=2)
    stack = dataclasses.replace(cfg.decoder.stack, idim=gpt.hidden_size // 2)
    return dataclasses.replace(
        cfg, gpt=gpt, decoder=dataclasses.replace(cfg.decoder, stack=stack))


def _infer(chat):
    return chat.infer(
        TEXTS, split_text=False,
        params_refine_text=TChat.RefineTextParams(
            max_new_token=8, min_new_token=2, manual_seed=5, show_tqdm=False),
        params_infer_code=TChat.InferCodeParams(
            max_new_token=16, min_new_token=4, manual_seed=7,
            show_tqdm=False))


@pytest.mark.parametrize("weight_bits,kv_bits,use_engine", [
    (8, 8, False), (4, 4, False), (8, 4, True), (4, 0, True)])
def test_chat_infers_on_every_tier(quant_config, monkeypatch, weight_bits,
                                   kv_bits, use_engine):
    chat = TChat(config=quant_config)
    assert chat.load(source="random", seed=0, device="cpu",
                     use_engine=use_engine, weight_bits=weight_bits,
                     kv_bits=kv_bits)
    gcfg = quant_config.gpt
    D, I, L = gcfg.hidden_size, gcfg.intermediate_size, gcfg.num_hidden_layers
    assert (chat.weight_bits, chat.kv_bits) == (weight_bits, kv_bits)
    assert chat.packed["wd"].dtype == torch.int8
    assert chat.packed["wd"].shape == (L, D, I // (2 if weight_bits == 4 else 1))
    assert chat.packed["sd"].shape == (L, D, I // (D if weight_bits == 8
                                                   else 128))
    assert chat.generator.packed is chat.packed
    assert chat.generator.kv_bits == kv_bits
    seen = set()
    real = ds.decode_step

    def spy(packed, emb, kc, vc, cur, *rest):
        assert packed is chat.packed
        seen.add(ds.variant_of(kc, cur, packed, gcfg))
        return real(packed, emb, kc, vc, cur, *rest)

    monkeypatch.setattr(tg.k1, "decode_step", spy)
    wavs = _infer(chat)
    base = {(0, False): "k1", (8, False): "k3", (4, False): "k6",
            (0, True): "k2", (8, True): "k2k3", (4, True): "k2k6"}
    assert seen == {base[kv_bits, use_engine]
                    + {8: "k4", 4: "k5"}[weight_bits]}
    assert len(wavs) == 2
    for w in wavs:
        assert w.dtype == np.float32 and w.size > 0 and np.isfinite(w).all()
    if use_engine:
        engines = [chat._text_engine, *chat._code_engines.values()]
        assert len(engines) == 2
        for e in engines:
            assert e.packed is chat.packed and e.kv_bits == kv_bits
            assert e.state.kc.shape[-1] == kv_quant.row_width(kv_bits, gcfg)
    again = _infer(chat)   # seeded: the same audio again
    for a, b in zip(wavs, again):
        np.testing.assert_array_equal(a, b)


def test_packed_weights_are_shared_and_repacked_on_a_new_tier(quant_config):
    chat = TChat(config=quant_config)
    chat.load(source="random", seed=0, device="cpu", weight_bits=8)
    first = chat.packed
    trees = dict(gpt=chat.gpt_params, embed=chat.embed_params,
                 decoder=chat.decoder_params, vocos=chat.vocos_params)
    # the same tensors, the same tier: kept, whatever the cache tier
    chat.load_params(**trees, device="cpu", weight_bits=8, kv_bits=4)
    assert chat.packed is first and chat.generator.packed is first
    assert chat.generator.kv_bits == 4
    # a new tier: packed anew
    chat.load_params(**trees, device="cpu", weight_bits=4)
    assert chat.packed is not first
    assert ds.weight_bits_of(chat.packed, quant_config.gpt) == 4
    chat.load_params(**trees, device="cpu")
    assert chat.weight_bits == 0 and chat.packed["wd"].dtype == torch.bfloat16
    bf16 = chat.packed
    # new parameter tensors, the same tier: packed anew, from the new values
    changed = {**chat.gpt_params, "layers": [
        {**lp, "mlp": {**lp["mlp"], "down": lp["mlp"]["down"] * 2}}
        for lp in chat.gpt_params["layers"]]}
    chat.load_params(**{**trees, "gpt": changed}, device="cpu")
    assert chat.packed is not bf16
    assert torch.equal(chat.packed["wd"], bf16["wd"] * 2)
    with pytest.raises(ValueError, match="weight_bits"):
        chat.load_params(**trees, device="cpu", weight_bits=16)


def test_wide_tier_and_slot_limits_follow_kv_bits(quant_config):
    chat = TChat(config=quant_config)
    chat.load(source="random", seed=0, device="cpu", kv_bits=4)
    max_new = chat._code_engine_geometry("fast").max_new_tokens
    # the tier choice is unchanged: 17 requests go to the 32-slot tier on
    # any quantized cache
    assert chat._code_tier_for(17, max_new, 40) == "wide"
    assert chat._code_tier_for(4, max_new, 40) == "fast"
    assert chat._engine_for_code("wide").ecfg.max_num_seqs == 32
