"""``chattts_tpu_torch.Chat.infer`` end to end against ``chattts_tpu.Chat``.

Both facades run at the tiny config on the CPU with the same weights: the
reference draws them (``load(source="random")``) and the port takes them
through the bridge (``load_params``).  As in test_torch_generate.py, the
logits of the two differ by a few bf16 ulps, so the comparison is
teacher-forced: the reference's tokens of each pass are recorded and the
port's sampler is handed them step by step.  Then

* the prompts of both passes are token-exact (normalizer, refine-text
  filter ``ids < break_0``, tokenizer);
* the waveforms agree within 2e-2 of their peak before the |x| < 1e-5
  strip (measured: 0.8%): the decoder hiddens differ by up to ~0.05 (a few
  bf16 ulps) and pass the mel decoder, exp() in Vocos' head and an inverse
  FFT.  After the strip they are not compared sample by sample: a sample
  near the threshold that one side drops and the other keeps shifts every
  later sample.  The port's output is held to its own strip instead.

Several segments (``split_text=True``, the default, on a text of two
sentences or a list of two texts) take the auto-clone branch: segment 0 is
synthesized and its wav encoded to the clone prompt.  The two encoders'
codes are held to each other on one wav; the teacher-forced run hands the
port the reference's clone prompt, so every pass stays token-exact, and a
run without that patch is held to shape and finiteness.
``use_decoder=False`` decodes equal ids through the DVAE: its waveforms
agree within 1e-4 of the peak.

The engine route (``use_engine=True``) is held to the Generator route's
shapes and to the reference's tier routing.  ``kv_bits=0`` is held to the
results the bf16-cache Generator gave before the int8 cache became the
default: the integer ids of both passes of a seeded run, as CRC-32s recorded
from that tree on the CPU.  Its waveforms are float32 and follow the BLAS
build, so they are held (atol 1e-5 of the peak, before the strip) to a
second facade that is given the same weights through ``load_params``.
"""

import zlib


import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.models.speaker import Speaker
from torch_port_utils import bridge, forced_tokens, port_config

WAV_RTOL_OF_PEAK = 2e-2
TEXTS = ["hello world.", "speech on a card"]


def _params(chat_cls):
    return (chat_cls.RefineTextParams(max_new_token=8, min_new_token=2,
                                      manual_seed=5, show_tqdm=False),
            chat_cls.InferCodeParams(max_new_token=16, min_new_token=4,
                                     manual_seed=7, show_tqdm=False))


@pytest.fixture(scope="module")
def chats(tiny_config):
    jchat = JChat(config=tiny_config)
    jchat.load(source="random", seed=0)
    tchat = TChat(config=port_config(tiny_config))
    tchat.load_params(gpt=bridge(jchat.gpt_params),
                      embed=bridge(jchat.embed_params),
                      decoder=bridge(jchat.decoder_params),
                      vocos=bridge(jchat.vocos_params),
                      dvae=bridge(jchat.dvae_params), device="cpu")
    return jchat, tchat


def _record(generator, log):
    """Wrap generator.generate to log [request, output ids] per pass; a
    pass is logged when it starts, its ids copied before the facade
    destroys the output."""
    inner = generator.generate

    def generate(req, context=None):
        log.append([req, None])
        for out in inner(req, context):
            log[-1][1] = [np.array(i) for i in out.ids]
            yield out

    generator.generate = generate


def _record_wavs(chat, log):
    """Wrap chat._decode_to_wavs to log each batch's waveforms before the
    |x| < 1e-5 strip."""
    inner = chat._decode_to_wavs

    def decode(*args, **kwargs):
        wavs = inner(*args, **kwargs)
        log.append(np.array(wavs))
        return wavs

    chat._decode_to_wavs = decode


def _teacher_forced(jchat, tchat, monkeypatch, text, wav_atol_of_peak,
                    **kw):
    """The same ``infer(text, **kw)`` on both facades, the port's sampler
    handed the reference's tokens of every pass (its own draw still runs).
    Checks that both ran the same passes on token-exact prompts and gave
    the same ids, and each batch's waveform before the strip within
    ``wav_atol_of_peak`` of its peak; returns (reference output, port
    output, the port's raw waveforms, the port's [request, ids] per
    pass)."""
    monkeypatch.delenv("CHATTTS_PIPELINED_DECODE", raising=False)
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "0")
    ref_log, port_log, ref_raw, port_raw = [], [], [], []
    _record(jchat.generator, ref_log)
    _record_wavs(jchat, ref_raw)
    ref = jchat.infer(text, params_refine_text=_params(JChat)[0],
                      params_infer_code=_params(JChat)[1], **kw)

    real_sample = tg.sampling.sample

    def teacher(logits, *args, **kwargs):
        req, ids = ref_log[len(port_log) - 1]
        real_sample(logits, *args, **kwargs)  # the port's own draw runs too
        forced = forced_tokens(tchat.config.gpt.num_vq, req.infer_text,
                               req.eos_token, req.max_new, ids)
        want = torch.from_numpy(forced[args[3]])
        return (want[:, 0] if req.infer_text else want).reshape(-1)

    monkeypatch.setattr(tg.sampling, "sample", teacher)
    _record(tchat.generator, port_log)
    _record_wavs(tchat, port_raw)
    got = tchat.infer(text, params_refine_text=_params(TChat)[0],
                      params_infer_code=_params(TChat)[1], **kw)

    assert len(port_log) == len(ref_log)
    for (rq, r_ids), (pq, p_ids) in zip(ref_log, port_log):
        np.testing.assert_array_equal(pq.ids, rq.ids)
        np.testing.assert_array_equal(pq.attn_mask, rq.attn_mask)
        np.testing.assert_array_equal(pq.text_mask, rq.text_mask)
        assert len(p_ids) == len(r_ids)
        for g, r in zip(p_ids, r_ids):
            np.testing.assert_array_equal(g, r)
    assert len(port_raw) == len(ref_raw)
    for raw_got, raw_ref in zip(port_raw, ref_raw):
        assert raw_got.shape == raw_ref.shape and raw_ref.shape[1] > 0
        np.testing.assert_allclose(
            raw_got, raw_ref, atol=wav_atol_of_peak * np.abs(raw_ref).max())
    return ref, got, port_raw, port_log


def test_infer_matches_reference(chats, monkeypatch):
    jchat, tchat = chats
    ref, got, (raw_got,), port_log = _teacher_forced(
        jchat, tchat, monkeypatch, TEXTS, WAV_RTOL_OF_PEAK, split_text=False)
    assert len(port_log) == 2  # refine pass, code pass
    assert all(len(ids) == len(TEXTS) for _, ids in port_log)
    assert len(got) == len(ref) == len(TEXTS)
    for g, raw in zip(got, raw_got):
        assert g.dtype == np.float32 and g.size > 0
        np.testing.assert_array_equal(g, raw[np.abs(raw) > 1e-5])


# ---------------------------------------------------------------------------
# batches wider than 64 rows, the decode step's limit before any batch width
# ---------------------------------------------------------------------------

WIDE = 65
WORDS = ["hello", "world", "speech", "card", "quick", "fox", "brown", "port"]


def _wide_texts(n):
    return [f"{WORDS[i % 8]} {WORDS[i // 8 % 8]} line." for i in range(n)]


def test_refine_pass_of_65_sentences_matches_reference(chats, monkeypatch):
    """A text of 65 sentences with ``refine_text_only=True``: the refine
    pass takes every sentence at once, 65 rows, teacher-forced; its prompts
    are token-exact, its ids and the refined text equal the reference's."""
    jchat, tchat = chats
    text = " ".join(_wide_texts(WIDE))
    ref, got, raws, port_log = _teacher_forced(
        jchat, tchat, monkeypatch, text, WAV_RTOL_OF_PEAK,
        refine_text_only=True)
    assert len(port_log) == 1 and not raws
    assert port_log[0][0].infer_text and len(port_log[0][1]) == WIDE
    assert isinstance(got, str) and got == ref
    assert len(got.split("\n")) == WIDE


def test_code_pass_of_65_texts_matches_reference(chats, monkeypatch):
    """65 texts, ``skip_refine_text=True, split_text=False``: one code pass
    of 65 rows, teacher-forced; prompts token-exact, codes equal, and the
    65 waveforms within 2e-2 of the batch's peak before the strip."""
    jchat, tchat = chats
    texts = _wide_texts(WIDE)
    ref, got, (raw_got,), port_log = _teacher_forced(
        jchat, tchat, monkeypatch, texts, WAV_RTOL_OF_PEAK,
        skip_refine_text=True, split_text=False)
    assert len(port_log) == 1 and not port_log[0][0].infer_text
    assert len(port_log[0][1]) == WIDE and raw_got.shape[0] == WIDE
    assert len(got) == len(ref) == WIDE
    for g, raw in zip(got, raw_got):
        np.testing.assert_array_equal(g, raw[np.abs(raw) > 1e-5])


# ---------------------------------------------------------------------------
# several segments: the auto-clone branch (segment 0 synthesized, encoded to
# codes by the DVAE and used as every segment's prompt), use_decoder=False
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", ["First one. Second one. ",
                                  ["hello world.", "speech on a card"]],
                         ids=["sentences", "list"])
def test_split_text_auto_clone_matches_reference(chats, monkeypatch, text):
    """Default ``split_text=True`` on two segments, teacher-forced.  The
    clone prompt is the reference's own ``spk_smp`` (the port's encoder is
    held to it in test_sample_audio_speaker_matches_reference: segment 0's
    wav differs within 2e-2 of its peak, so its codes may differ), so the
    prompts of the second pass are token-exact; both batches' waveforms
    agree before the strip, and the port returns one wav, the stripped
    batches joined."""
    jchat, tchat = chats
    smp = []
    real_speaker = jchat.sample_audio_speaker

    def record(wav):
        smp.append(real_speaker(wav))
        return smp[-1]

    monkeypatch.setattr(jchat, "sample_audio_speaker", record)
    monkeypatch.setattr(tchat, "sample_audio_speaker",
                        lambda wav: smp[-1])
    ref, got, raws, _ = _teacher_forced(jchat, tchat, monkeypatch, text,
                                        WAV_RTOL_OF_PEAK)
    assert len(smp) == 1 and len(raws) == 2  # segment 0, then both
    assert raws[0].shape[0] == 1 and raws[1].shape[0] == 2
    assert len(got) == len(ref) == 1
    assert got[0].dtype == np.float32 and np.isfinite(got[0]).all()
    want = np.concatenate([w[np.abs(w) > 1e-5] for w in raws[1]])
    np.testing.assert_array_equal(got[0], want)


def test_split_text_auto_clone_with_the_ports_own_encoder(chats):
    """The same default call without any patch: the port clones with its
    own encoder and returns one finite float32 wav; the caller's params
    carry the clone prompt (as the reference's do)."""
    _, tchat = chats
    refine, code = _params(TChat)
    wavs = tchat.infer("First one. Second one. ",
                       params_refine_text=refine, params_infer_code=code)
    assert len(wavs) == 1 and wavs[0].ndim == 1 and wavs[0].size > 0
    assert wavs[0].dtype == np.float32 and np.isfinite(wavs[0]).all()
    assert code.spk_smp is not None and isinstance(code.txt_smp, str)
    codes = Speaker.decode_prompt(code.spk_smp)
    assert codes.shape[0] == tchat.config.gpt.num_vq and codes.shape[1] > 0


def test_use_decoder_false_matches_reference(chats, monkeypatch):
    """Codes -> GFSQ embed -> the DVAE's decoder -> Vocos, teacher-forced:
    the ids are equal, so the waveforms differ only by float32 sums in
    another order (held to 1e-4 of the peak before the strip), and each
    row's bucket-padding tail is zero."""
    jchat, tchat = chats
    ref, got, (raw_got,), log = _teacher_forced(
        jchat, tchat, monkeypatch, TEXTS, 1e-4, split_text=False,
        use_decoder=False)
    assert len(got) == len(ref) == len(TEXTS)
    spc = 2 * tchat.config.vocos.hop_length
    for g, raw, ids in zip(got, raw_got, log[-1][1]):
        assert g.dtype == np.float32 and g.size > 0 and np.isfinite(g).all()
        assert ids.shape[0] > 0
        assert not raw[ids.shape[0] * spc:].any()
        np.testing.assert_array_equal(g, raw[np.abs(raw) > 1e-5])


def test_sample_audio_speaker_matches_reference(chats):
    """The same wav through both encoders: the (num_vq, T) codes of the
    spk_smp strings agree on at least 99% (a code may flip only on a
    rounding boundary: tests/test_torch_dvae_encode.py)."""
    jchat, tchat = chats
    rng = np.random.default_rng(0)
    t = np.arange(12288) / 24000.0
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    want = Speaker.decode_prompt(jchat.sample_audio_speaker(wav))
    got = Speaker.decode_prompt(tchat.sample_audio_speaker(wav))
    assert got.shape == want.shape == (4, (1 + 12288 // 256) // 2)
    assert (got == want).mean() >= 0.99


def test_clone_paths_need_the_dvae(chats):
    jchat, tchat = chats
    bare = TChat(config=tchat.config)
    bare.load_params(gpt=tchat.gpt_params, embed=tchat.embed_params,
                     decoder=tchat.decoder_params, vocos=tchat.vocos_params,
                     device="cpu")
    with pytest.raises(ValueError, match="dvae="):
        bare.sample_audio_speaker(np.zeros(4096, np.float32))
    with pytest.raises(ValueError, match="dvae="):
        bare.infer("First one. Second one. ", skip_refine_text=True,
                   params_infer_code=_params(TChat)[1])
    with pytest.raises(ValueError, match="dvae="):
        bare.infer("hi", use_decoder=False, skip_refine_text=True,
                   params_infer_code=_params(TChat)[1])
    # one segment, or a clone prompt given, takes no clone
    assert len(bare.infer("hi", skip_refine_text=True,
                          params_infer_code=_params(TChat)[1])) == 1


def test_split_text_concatenates_one_wav(chats):
    _, tchat = chats
    wavs = tchat.infer("one segment only", split_text=True,
                       params_refine_text=_params(TChat)[0],
                       params_infer_code=_params(TChat)[1])
    assert len(wavs) == 1 and wavs[0].ndim == 1


def test_refine_text_only_and_empty_input(chats):
    _, tchat = chats
    txt = tchat.infer(["hello world"], split_text=False,
                      refine_text_only=True,
                      params_refine_text=_params(TChat)[0])
    assert isinstance(txt, list) and isinstance(txt[0], str)
    assert tchat.infer([]) == []


def test_later_slices_raise(chats, tmp_path, monkeypatch, caplog):
    """Reference-name weight loading, a later slice until it was ported,
    now finds no tree in an empty directory and falls back, as the
    reference does, to random weights with a warning; streaming, which
    raised here until it was ported, returns a generator of audio
    chunks."""
    _, tchat = chats
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CHATTTS_ASSETS", raising=False)
    chat = TChat(config=tchat.config)
    with caplog.at_level("WARNING"):
        assert chat.load(source="local", device="cpu")
    assert "falling back to random init" in caplog.text
    assert chat.has_loaded()
    chunks = list(tchat.infer("hi", stream=True, skip_refine_text=True,
                              params_infer_code=_params(TChat)[1]))
    assert chunks and all(c.dtype == np.float32 and c.ndim == 2
                          and np.isfinite(c).all() for c in chunks)


def test_speaker_embedding_conditions_the_code_pass(chats):
    _, tchat = chats
    spk = tchat.sample_random_speaker()
    assert isinstance(spk, str) and spk
    code = _params(TChat)[1]
    code.spk_emb = spk
    wavs = tchat.infer("hi", split_text=False, skip_refine_text=True,
                       params_infer_code=code)
    assert len(wavs) == 1 and np.isfinite(wavs[0]).all()


# ---------------------------------------------------------------------------
# the engine route and the KV cache tiers
# ---------------------------------------------------------------------------


def _port_chat(tiny_config, **kw):
    chat = TChat(config=port_config(tiny_config))
    chat.load(source="random", seed=0, device="cpu", **kw)
    return chat


def _infer(chat):
    return chat.infer(TEXTS, split_text=False,
                      params_refine_text=_params(TChat)[0],
                      params_infer_code=_params(TChat)[1])


def test_kv_bits_0_reproduces_the_bf16_generator_bit_for_bit(tiny_config):
    chat = _port_chat(tiny_config, kv_bits=0)
    log, raw = [], []
    _record(chat.generator, log)
    _record_wavs(chat, raw)
    wavs = _infer(chat)

    def crc(a):
        return zlib.crc32(np.ascontiguousarray(a.astype(np.int64)).tobytes())

    (_, refine_ids), (_, code_ids) = log
    assert [(i.shape, crc(i)) for i in refine_ids] == [
        ((8,), 1369787028), ((8,), 112212425)]
    assert [(i.shape, crc(i)) for i in code_ids] == [
        ((16, 4), 3554064973), ((16, 4), 2832529802)]

    # the same weights in a second facade, which builds its own generator
    twin = TChat(config=chat.config)
    twin.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                     decoder=chat.decoder_params, vocos=chat.vocos_params,
                     device="cpu", kv_bits=0)
    assert twin.generator is not chat.generator and twin.kv_bits == 0
    twin_log, twin_raw = [], []
    _record(twin.generator, twin_log)
    _record_wavs(twin, twin_raw)
    _infer(twin)
    for (_, ids), (_, twin_ids) in zip(log, twin_log):
        for a, b in zip(ids, twin_ids):
            np.testing.assert_array_equal(a, b)
    (got,), (want,) = raw, twin_raw
    assert got.shape == want.shape and got.shape[0] == len(TEXTS)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert len(wavs) == len(TEXTS)
    assert all(w.size > 0 and np.isfinite(w).all() for w in wavs)


def test_kv_bits_default_is_the_int8_cache(tiny_config, monkeypatch):
    from chattts_tpu_torch.ops import decode_step as ds

    chat = _port_chat(tiny_config)
    assert chat.kv_bits == 8 and chat.generator.kv_bits == 8
    seen = []
    real = ds.decode_step

    def spy(packed, emb, kc, vc, cur, *rest):
        seen.append((kc.dtype, ds.variant_of(kc, cur)))
        return real(packed, emb, kc, vc, cur, *rest)

    monkeypatch.setattr(tg.k1, "decode_step", spy)
    wavs = _infer(chat)
    assert len(wavs) == 2 and all(np.isfinite(w).all() for w in wavs)
    assert seen and set(seen) == {(torch.int8, "k3")}
    with pytest.raises(ValueError, match="kv_bits"):
        _port_chat(tiny_config, kv_bits=4)


@pytest.mark.parametrize("kv_bits", [8, 0])
def test_use_engine_infer_matches_generator_route_shapes(tiny_config,
                                                         monkeypatch, kv_bits):
    from chattts_tpu_torch.engine import batching as tb
    from chattts_tpu_torch.ops import decode_step as ds

    plain = _infer(_port_chat(tiny_config, kv_bits=kv_bits))
    chat = _port_chat(tiny_config, use_engine=True, kv_bits=kv_bits)
    seen = set()
    real = ds.decode_step

    def spy(packed, emb, kc, vc, cur, *rest):
        seen.add(ds.variant_of(kc, cur))
        return real(packed, emb, kc, vc, cur, *rest)

    monkeypatch.setattr(tb.step_mod, "decode_step", spy)
    monkeypatch.setattr(chat.generator, "generate", None)  # must not be used
    wavs = _infer(chat)
    assert seen == {"k2k3" if kv_bits else "k2"}
    assert len(wavs) == len(plain) == len(TEXTS)
    for w, p in zip(wavs, plain):
        assert w.dtype == p.dtype == np.float32 and w.ndim == 1
        assert w.size > 0 and np.isfinite(w).all()
        # both routes keep 4..16 code steps of 512 samples before the strip
        assert 0.2 * p.size <= w.size <= 5 * p.size
    # both passes ran on engines that share the generator's packed weights
    assert chat._text_engine is not None and list(chat._code_engines) == ["fast"]
    eng = chat._code_engines["fast"]
    assert eng.packed is chat.packed is chat.generator.packed
    assert eng.stats["requests_finished"] == len(TEXTS)
    # a seeded request returns the same audio again, and the text alone too
    again = _infer(chat)
    for a, b in zip(wavs, again):
        np.testing.assert_array_equal(a, b)
    txt = chat.infer(TEXTS, split_text=False, refine_text_only=True,
                     params_refine_text=_params(TChat)[0])
    assert isinstance(txt, list) and len(txt) == 2
    # the engine route streams too (it raised here until streaming was
    # ported)
    chunks = list(chat.infer("hi", stream=True,
                             params_refine_text=_params(TChat)[0],
                             params_infer_code=_params(TChat)[1]))
    assert chunks and all(c.dtype == np.float32 and c.ndim == 2
                          and np.isfinite(c).all() for c in chunks)


def test_use_engine_split_text_auto_clone_shapes(tiny_config, monkeypatch):
    """Two segments through default ``split_text=True`` on the engine
    route: segment 0 and then both segments run on the code engine (the
    clone prompt fits its buckets here), the refine pass on the text
    engine, and one finite float32 wav comes back, of the Generator
    route's length to within the code steps kept."""
    text = "First one. Second one. "
    plain = _port_chat(tiny_config)
    want = plain.infer(text, params_refine_text=_params(TChat)[0],
                       params_infer_code=_params(TChat)[1])
    chat = _port_chat(tiny_config, use_engine=True)
    monkeypatch.setattr(chat.generator, "generate", None)  # must not be used
    code = _params(TChat)[1]
    wavs = chat.infer(text, params_refine_text=_params(TChat)[0],
                      params_infer_code=code)
    assert len(wavs) == len(want) == 1
    w, p = wavs[0], want[0]
    assert w.dtype == p.dtype == np.float32 and w.ndim == 1
    assert w.size > 0 and np.isfinite(w).all()
    # three segments' worth of 4..16 code steps of 512 samples on both
    assert 0.2 * p.size <= w.size <= 5 * p.size
    assert code.spk_smp is not None
    eng = chat._code_engines["fast"]
    assert eng.stats["requests_finished"] == 3  # segment 0, then both


def test_code_tier_routing(tiny_config):
    """``_code_tier_for`` as chattts_tpu/core.py routes: by width and prompt
    length, never by max_new alone; wide only with the int8 cache."""
    from chattts_tpu.core import Chat as JChat

    chat = _port_chat(tiny_config)
    bf16 = _port_chat(tiny_config, kv_bits=0)
    jchat = JChat(config=tiny_config)
    for tier in ("fast", "capacity", "wide"):
        g, r = chat._code_engine_geometry(tier), jchat._code_engine_geometry(tier)
        for f in ("max_num_seqs", "max_prompt_len", "max_new_tokens",
                  "chunk_steps", "prompt_buckets", "preempt_after_chunks",
                  "max_stream_slots", "collect_hidden", "infer_text"):
            assert getattr(g, f) == getattr(r, f), (tier, f)
    max_new = chat._code_engine_geometry("fast").max_new_tokens
    assert chat._code_tier_for(4, max_new, 40) == "fast"
    assert chat._code_tier_for(8, max_new, 256) == "fast"
    assert chat._code_tier_for(8, max_new, 300) == "capacity"  # long prompt
    assert chat._code_tier_for(9, 16, 40) == "capacity"        # too wide
    assert chat._code_tier_for(16, max_new, 40) == "capacity"
    assert chat._code_tier_for(17, max_new, 40) == "wide"
    assert chat._code_tier_for(64, 16, 200) == "wide"
    # past every tier's prompt buckets (256 here: 512 positions less 256 new)
    assert chat._code_tier_for(64, 16, 500) == "capacity"
    assert chat._code_tier_for(4, max_new + 1, 40) == "capacity"
    # the bf16 cache has no 32-slot tier: it time-slices on 16 slots
    assert bf16._code_tier_for(17, max_new, 40) == "capacity"
    assert bf16._engine_for_code("wide").ecfg.max_num_seqs == 16
    assert chat._engine_for_code("wide").ecfg.max_num_seqs == 32
