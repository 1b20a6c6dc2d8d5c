"""``chattts_tpu_torch.Chat.infer(stream=True)`` and the Generator's
streaming form, against the port's own non-streamed runs and against
``chattts_tpu``.

Free runs of the two packages diverge by bf16 ulps (ROADMAP Queue 3), so
the facades are compared the reference's own way: both ``_stream_batch``
are driven by one stubbed partial schedule built from the same hiddens
(bridged), on the Generator's shape of partials (hiddens up to the kept
max, the window decoded ahead at dispatch), the engine's (whole rows, a
valid prefix bounded by the slowest unfinished row) and the ids route;
chunk shapes must be equal and values within 1e-4.  The Generator's
partial yields are held to the reference Generator's on the same request,
teacher-forced: their count, the kept lengths, ids and finished flags at
every yield, for ``stream_batch`` a multiple of ``SYNC_EVERY`` and not,
with and without dispatch-ahead.

Within the port, a real stream on each route (and with
``use_decoder=False``) has the codes of the non-streamed ``infer`` with the
same seed, its length, and its samples within the windowing tolerance of
tests/test_streaming.py (2e-4 past the first emitted window, at least 60 dB
over it); ``stream_window_ahead`` on and off give the same samples; a
stream whose first attempt ended empty restarts cleanly; ``interrupt()``
mid-stream ends the stream and leaves the engine empty.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu.engine import generate as jg
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.models import dvae as dvae_mod
from chattts_tpu_torch.models import vocos as vocos_mod
from torch_port_utils import bridge, forced_tokens, port_config

TEXTS = ["hello world.", "speech on a card"]
STREAM_TOL = 2e-4
EOS_SCALE = 1.5  # some rows end early, none in the first chunk
FIRST_WINDOW_SNR_DB = 60.0


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


@pytest.fixture(scope="module")
def engine_chat(chats):
    _, tchat = chats
    chat = TChat(config=tchat.config)
    chat.load_params(gpt=tchat.gpt_params, embed=tchat.embed_params,
                     decoder=tchat.decoder_params, vocos=tchat.vocos_params,
                     dvae=tchat.dvae_params, device="cpu", use_engine=True)
    return chat


def _code(chat_cls, **kw):
    p = dict(max_new_token=64, min_new_token=40, manual_seed=3,
             stream_batch=8, pass_first_n_batches=1, stream_speed=4096,
             show_tqdm=False)
    p.update(kw)
    return chat_cls.InferCodeParams(**p)


def _stream(chat, use_decoder=True, **kw):
    return list(chat.infer(TEXTS, stream=True, split_text=False,
                           skip_refine_text=True, use_decoder=use_decoder,
                           params_infer_code=_code(TChat, **kw)))


# ---------------------------------------------------------------------------
# a real stream in the port against its own non-streamed run
# ---------------------------------------------------------------------------


def _recorded(chat, run):
    """run() with the code pass's last ids, the hiddens handed to the
    one-shot decode, and the stream decoders' ``emitted`` after each
    update recorded."""
    rec = {"emitted": []}
    infer_code, decode = chat._infer_code, chat._decode_to_wavs
    mk_sd = chat._device_stream_decoder

    def rec_infer_code(*a, **k):
        for out in infer_code(*a, **k):
            rec["codes"] = [np.array(i) for i in out.ids]
            yield out

    def rec_decode(result, use_decoder):
        rec["hid"], rec["end"] = result.hiddens_dev, result.end_dev
        return decode(result, use_decoder)

    def rec_sd(*a, **k):
        sd = mk_sd(*a, **k)
        update = sd.update_dev

        def update_dev(*a2, **k2):
            out = update(*a2, **k2)
            rec["emitted"].append(sd.emitted)
            return out

        sd.update_dev = update_dev
        return sd

    chat._infer_code, chat._decode_to_wavs = rec_infer_code, rec_decode
    chat._device_stream_decoder = rec_sd
    try:
        out = run()
    finally:
        del chat._infer_code, chat._decode_to_wavs
        del chat._device_stream_decoder
    return out, rec


@pytest.mark.parametrize("route", ["generator", "engine"])
def test_stream_matches_the_ports_one_shot(chats, engine_chat, route):
    chat = chats[1] if route == "generator" else engine_chat
    chunks, srec = _recorded(chat, lambda: _stream(chat))
    wavs, rec = _recorded(chat, lambda: chat.infer(
        TEXTS, split_text=False, skip_refine_text=True,
        params_infer_code=_code(TChat)))
    assert len(srec["codes"]) == len(rec["codes"]) == len(TEXTS)
    for a, b in zip(srec["codes"], rec["codes"]):
        np.testing.assert_array_equal(a, b)
    assert len(chunks) >= 3
    for ch in chunks:
        assert ch.dtype == np.float32 and ch.ndim == 2
        assert ch.shape[0] == len(TEXTS) and np.isfinite(ch).all()
    for ch in chunks[:-1]:
        assert 0 < ch.shape[1] <= 4096
    # the one-shot decode of exactly the kept positions (no bucket pad,
    # no tail zeroed), which the windows reassemble
    n = max(len(c) for c in rec["codes"])
    hid, end = rec["hid"][:, :n], rec["end"]
    t = torch.arange(n)
    mel = dvae_mod.decode_from_hidden(
        chat.decoder_params, hid * (t[None, :] < end[:, None])[..., None],
        chat.config.decoder)
    exact = vocos_mod.decode(chat.vocos_params, mel,
                             chat.config.vocos).numpy()
    assert exact.shape[1] == (2 * n - 1) * 256
    got = np.concatenate(chunks, axis=1)
    m = got.shape[1] - chunks[-1].shape[1]
    rest = exact[:, m:]
    want = np.concatenate([exact[:, :m],
                           rest[:, (np.abs(rest) > 1e-5).any(0)]], axis=1)
    assert got.shape == want.shape
    # the first window, emitted under first_guard 8, ends at the first
    # nonzero emission (8 positions after the Generator's second chunk of
    # 8 steps; 16 after the engine's first chunk of 24)
    e1 = next(e for e in srec["emitted"] if e) * 512
    assert e1 == (8 if route == "generator" else 16) * 512
    err = ((got[:, :e1] - want[:, :e1]) ** 2).sum()
    snr = 10 * np.log10((want[:, :e1] ** 2).sum() / max(err, 1e-30))
    assert snr >= FIRST_WINDOW_SNR_DB
    np.testing.assert_allclose(got[:, e1:], want[:, e1:], atol=STREAM_TOL)
    # and the one-shot infer's stripped rows are the same audio's
    for w in wavs:
        assert w.size > 0 and np.isfinite(w).all()


@pytest.mark.parametrize("route", ["generator", "engine"])
def test_use_decoder_false_stream_matches_one_shot_codes(chats, engine_chat,
                                                         route):
    chat = chats[1] if route == "generator" else engine_chat
    chunks, srec = _recorded(chat, lambda: _stream(chat, use_decoder=False))
    _, rec = _recorded(chat, lambda: chat.infer(
        TEXTS, split_text=False, skip_refine_text=True, use_decoder=False,
        params_infer_code=_code(TChat)))
    for a, b in zip(srec["codes"], rec["codes"]):
        np.testing.assert_array_equal(a, b)
    n = max(len(c) for c in rec["codes"])
    total = sum(ch.shape[1] for ch in chunks)
    assert (2 * n - 1) * 256 - 512 <= total <= (2 * n - 1) * 256
    assert all(np.isfinite(ch).all() and ch.dtype == np.float32
               for ch in chunks)


@pytest.mark.parametrize("route", ["generator", "engine"])
def test_stream_window_ahead_on_and_off_give_the_same_samples(
        chats, engine_chat, route):
    chat = chats[1] if route == "generator" else engine_chat
    off = TChat(config=chat.config.with_runtime(stream_window_ahead=False))
    off.load_params(gpt=chat.gpt_params, embed=chat.embed_params,
                    decoder=chat.decoder_params, vocos=chat.vocos_params,
                    dvae=chat.dvae_params, device="cpu",
                    use_engine=route == "engine")
    a = np.concatenate(_stream(chat), axis=1)
    b = np.concatenate(_stream(off), axis=1)
    assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("route", ["generator", "engine"])
def test_interrupt_mid_stream(chats, engine_chat, route):
    chat = chats[1] if route == "generator" else engine_chat
    full = sum(c.shape[1] for c in _stream(chat, min_new_token=64,
                                           pass_first_n_batches=0,
                                           stream_speed=1024))
    gen = chat.infer(TEXTS, stream=True, split_text=False,
                     skip_refine_text=True, params_infer_code=_code(
                         TChat, min_new_token=64, pass_first_n_batches=0,
                         stream_speed=1024))
    first = next(gen)
    chat.interrupt()
    rest = list(gen)
    got = first.shape[1] + sum(c.shape[1] for c in rest)
    assert 0 < got < full
    if route == "engine":
        assert not any(eng.has_unfinished()
                       for eng in chat._code_engines.values())
    # the next call runs normally
    again = sum(c.shape[1] for c in _stream(chat, min_new_token=64,
                                            pass_first_n_batches=0,
                                            stream_speed=1024))
    assert again == full


def test_stream_restarts_after_an_empty_attempt(chats, monkeypatch):
    """An unseeded stream whose first attempt ends every row at step 0 is
    retried (ensure_non_empty); the consumer drops the empty attempt and
    its chunks equal those of a run that draws the retry's tokens first."""
    _, chat = chats
    cfg = chat.config.gpt
    eos = cfg.num_audio_tokens - 1
    rng = np.random.default_rng(5)
    max_new = 40
    ids = [rng.integers(0, eos, (n, cfg.num_vq)) for n in (max_new, 31)]
    forced = forced_tokens(cfg.num_vq, False, eos, max_new, ids)
    real = tg.sampling.sample

    def run(empty_first):
        attempts = []

        def teacher(logits, *args, **kwargs):
            step = args[3]
            real(logits, *args, **kwargs)
            if step == 0:
                attempts.append(step)
            if empty_first and len(attempts) == 1:
                return torch.full((logits.shape[0],), eos)
            return torch.from_numpy(forced[step]).reshape(-1)

        monkeypatch.setattr(tg.sampling, "sample", teacher)
        chunks = _stream(chat, manual_seed=None, max_new_token=max_new,
                         min_new_token=0)
        monkeypatch.setattr(tg.sampling, "sample", real)
        return chunks, attempts

    restarted, att_r = run(True)
    clean, att_c = run(False)
    assert len(att_r) == 2 and len(att_c) == 1
    assert [c.shape for c in restarted] == [c.shape for c in clean]
    for a, b in zip(restarted, clean):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the Generator's yields against the reference Generator's
# ---------------------------------------------------------------------------


def _request(cfg, seed, stream_batch, speculate, B=3, T0=11, max_new=40):
    rng = np.random.default_rng(seed)
    hi = cfg.num_audio_tokens - 1
    ids = rng.integers(1, hi, (B, T0, cfg.num_vq)).astype(np.int32)
    attn = np.ones((B, T0), bool)
    attn[1, :4] = False
    ids[~attn] = 0
    return dict(ids=ids, attn_mask=attn, text_mask=attn.copy(),
                infer_text=False, eos_token=hi,
                temperature=np.full((cfg.num_vq,), 0.3, np.float32),
                top_p=0.7, top_k=20, repetition_penalty=1.05,
                max_new=max_new, min_new=3, seed=seed, return_hidden=True,
                stream_batch=stream_batch, speculate=speculate,
                speculate_from=2 if speculate else 0)


def _yields(outs):
    return [(o.partial, [len(i) for i in o.ids],
             [np.array(i) for i in o.ids], np.array(o.finished),
             o.hiddens_dev.shape[1]) for o in outs]


@pytest.mark.parametrize("speculate", [False, True])
@pytest.mark.parametrize("stream_batch", [8, 6, 20])
def test_generator_partial_yields_match_reference(chats, monkeypatch,
                                                  stream_batch, speculate):
    """Teacher-forced with the reference's final ids (rows end at other
    steps: the code head's EOS column is scaled up), the port yields
    partials at the reference's step counts, with its kept lengths, ids
    and finished flags, for stream_batch 8 (= SYNC_EVERY), 6 and 20."""
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "0")
    jchat, tchat = chats
    cfg = jchat.config.gpt
    jemb = dict(jchat.embed_params)
    jemb["head_code"] = jemb["head_code"].at[
        :, :, cfg.num_audio_tokens - 1].multiply(EOS_SCALE)
    kw = _request(cfg, 4, stream_batch, speculate)
    dispatched = {"ref": [], "port": []}
    ref_gen = jg.Generator(cfg, jchat.gpt_params, jemb, prefill_bucket=16)
    ref = list(ref_gen.generate(jg.GenerateRequest(
        **kw, on_dispatch=lambda st, hi: dispatched["ref"].append(hi))))
    final = ref[-1]
    assert not final.partial and any(len(i) < kw["max_new"]
                                     for i in final.ids)
    forced = forced_tokens(cfg.num_vq, False, kw["eos_token"],
                           kw["max_new"], final.ids)
    monkeypatch.setattr(
        tg.sampling, "sample",
        lambda logits, *a, **k: torch.from_numpy(forced[a[3]]).reshape(-1))
    gen = tg.Generator(tchat.config.gpt, tchat.gpt_params, bridge(jemb),
                       prefill_bucket=16, kv_bits=0)
    got = list(gen.generate(tg.GenerateRequest(
        **kw, on_dispatch=lambda st, hi: dispatched["port"].append(hi))))
    want_y, got_y = _yields(ref), _yields(got)
    assert len(got_y) == len(want_y) >= 2
    for g, w in zip(got_y, want_y):
        assert g[0] == w[0] and g[1] == w[1] and g[4] == w[4]
        for a, b in zip(g[2], w[2]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g[3], w[3])
    assert dispatched["port"] == dispatched["ref"]


# ---------------------------------------------------------------------------
# both facades' _stream_batch on one stubbed schedule
# ---------------------------------------------------------------------------


class _St:
    def __init__(self, hiddens, end_idx):
        self.hiddens, self.end_idx = hiddens, end_idx


def _schedule(kind, buf, ends, ids, ns, jax_side):
    """The partials a route would yield for kept ends ``ends`` at chunk
    counts ``ns``: ``kind`` "generator" (hiddens up to the kept max,
    on_dispatch before each yield), "engine" (whole rows, ``n_valid`` the
    slowest unfinished row's count) or "ids" (codes only)."""
    arr = (lambda a: jnp.asarray(a)) if jax_side else (
        lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    GO = jg.GenerationOutputs if jax_side else tg.GenerationOutputs

    def gen(on_dispatch):
        for k, n in enumerate(ns):
            lens = np.minimum(n, ends)
            fin = lens == ends if k < len(ns) - 1 else np.ones_like(
                ends, bool)
            partial = not fin.all()
            out_ids = [ids[b, :lens[b]] for b in range(len(ends))]
            end = arr(lens.astype(np.int32 if jax_side else np.int64))
            extra = {"hiddens": []} if jax_side else {}
            if kind == "ids":
                out = GO(ids=out_ids, finished=fin, partial=partial, **extra)
            elif kind == "generator":
                if on_dispatch is not None:
                    on_dispatch(_St(arr(buf), end), n)
                out = GO(ids=out_ids, finished=fin, partial=partial,
                         hiddens_dev=arr(buf[:, :lens.max()]), end_dev=end,
                         **extra)
            else:
                unfinished = [x for x, f in zip(lens, fin) if not f]
                out = GO(ids=out_ids, finished=fin, partial=partial,
                         hiddens_dev=arr(buf), end_dev=end,
                         n_valid=int(min(unfinished, default=lens.max())),
                         **extra)
            yield out
    return gen


@pytest.mark.parametrize("kind", ["generator", "engine", "ids"])
@pytest.mark.parametrize("wire", [False, True])
def test_stream_batch_matches_reference_on_one_schedule(chats, rng, kind,
                                                        wire):
    jchat0, tchat0 = chats
    # copies with the wire flag (the reference caches its window jits by
    # window only, so its copy starts an empty cache)
    jchat, tchat = copy.copy(jchat0), copy.copy(tchat0)
    jchat.config = jchat0.config.with_runtime(wire_int16=wire)
    jchat._device_window_jits = {}
    tchat.config = tchat0.config.with_runtime(wire_int16=wire)
    cfg = tchat.config.gpt
    B, Tbuf = 2, 64
    buf = rng.standard_normal((B, Tbuf, cfg.hidden_size)).astype(np.float32)
    ends = np.array([57, 33])
    ids = rng.integers(0, cfg.num_audio_tokens - 1,  # GFSQ indices
                       (B, Tbuf, cfg.num_vq)).astype(np.int32)
    ns = [8, 16, 24, 32, 40, 48, 57]
    params = {}
    for side, chat in (("ref", jchat), ("port", tchat)):
        sched = _schedule(kind, buf, ends, ids, ns, side == "ref")

        def stub(batch, stream, use_decoder, p, speculate=False,
                 speculate_from=0, on_dispatch=None, **_):
            return sched(on_dispatch)

        chat._infer_code = stub
        p = (JChat if side == "ref" else TChat).InferCodeParams(
            max_new_token=57, stream_batch=8, pass_first_n_batches=1,
            stream_speed=3000)
        params[side] = list(chat._stream_batch(TEXTS, kind != "ids", p))
    ref, got = params["ref"], params["port"]
    assert [g.shape for g in got] == [np.asarray(r).shape for r in ref]
    assert len(got) >= 4
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=1e-4)
