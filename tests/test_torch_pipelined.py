"""The pipelined one-shot decode of ``chattts_tpu_torch`` against
``chattts_tpu``.

The conv-state stream functions (``models/convnext.py``, ``dvae.py``,
``vocos.py``, ``ops/stft.py``) are held to the JAX functions on the same
inputs and states, chunk by chunk, within 1e-5 (float32 sums in another
order), with a layer scale of 0.3 so that a head-mask fault cannot hide
behind the default 1e-6; the chain of them is held to the port's own full
decode within 1e-5, as ``tests/test_streaming.py`` holds the reference's.

``Chat._pipelined_wavs`` is held to the reference's ``_pipelined_wavs``
within 3e-4 of the peak (``tests/test_core.py``'s tolerance), both facades
on the same decoder and Vocos params (drawn by JAX, bridged) and driven by
one stubbed partial schedule of the same hiddens (numpy, from a seed): a
teacher-forced generation would hand the two decoders hiddens a few bf16
ulps apart (``tests/test_torch_core.py``), 2e-2 of the peak, so the
decode pipeline is compared on equal hiddens instead.  The schedules are
the Generator's (hiddens up to the kept max, the flush speculated at
dispatch) and the engine's (whole rows, the slowest unfinished row's
count); each on both branches.  At the tiny config every chunk takes the
incremental chain (``max(16, chunk)`` frames cover its mel offset of 24),
so the windowed branch runs on a decoder stack of 4 layers (offset 36).

Within the port, a real generation's pipelined wav equals the one-shot
decode of its hiddens within 3e-4 of the peak on both routes and both
branches; an
utterance shorter than the flush window takes the one-shot decode and is
identical; the empty-generation retry drops the discarded attempt's
audio.  ``CHATTTS_PIPELINED_DECODE`` overrides ``pipelined_decode`` both
ways, and None is off.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu.engine import generate as jg
from chattts_tpu.models import convnext as jconv
from chattts_tpu.models import dvae as jdvae
from chattts_tpu.models import vocos as jvocos
from chattts_tpu.ops import stft as jstft
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.engine import batching as tbatch
from chattts_tpu_torch.engine import generate as tg
from chattts_tpu_torch.engine.streaming import plan_windows
from chattts_tpu_torch.models import convnext as tconv
from chattts_tpu_torch.models import dvae as tdvae
from chattts_tpu_torch.models import vocos as tvocos
from chattts_tpu_torch.ops import stft as tstft
from torch_port_utils import bridge, port_config, to_np

STREAM_ATOL = 1e-5      # a stream function against the JAX one / the chain
PIPE_ATOL_OF_PEAK = 3e-4  # pipelined wav against one-shot / the reference
GAMMA = 0.3             # layer scale that makes head-mask faults visible
TEXTS = ["hello world.", "speech on a card"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and
    under the tier-1 command's six workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chains(chat):
    """The (B, chunk) pairs ``chat`` built the incremental chain for."""
    return [key[:2] for key in chat._incr_fns]


def _windowed(cfg):
    """``cfg`` with a 4-layer decoder stack: its mel offset (36) is above
    2 * 16 frames, so a 16-step chunk takes the windowed branch."""
    stack = dataclasses.replace(cfg.decoder.stack, n_layer=4)
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, stack=stack))


def _with_gamma(dp, vp):
    """Copies of decoder and Vocos params with layer scale GAMMA, and their
    bridge."""
    def blocks(bs):
        return [{**b, "gamma": jnp.full_like(b["gamma"], GAMMA)} for b in bs]

    dp = {**dp, "decoder": {**dp["decoder"],
                            "blocks": blocks(dp["decoder"]["blocks"])}}
    vp = {**vp, "blocks": blocks(vp["blocks"])}
    return (dp, vp), (bridge(dp), bridge(vp))


def _decoder_pair(cfg, seed):
    """Decoder and Vocos params of ``cfg`` drawn by JAX, as _with_gamma."""
    return _with_gamma(
        jdvae.init_decoder_params(jax.random.PRNGKey(seed), cfg.decoder),
        jvocos.init_params(jax.random.PRNGKey(seed + 1), cfg.vocos))


@pytest.fixture(scope="module")
def chats(tiny_config):
    """The reference facade holding only what its pipelined decode reads
    with the code pass stubbed (decoder and Vocos params drawn by JAX, the
    window and chain caches), and the port's facade on the bridge of those
    params and seeded random weights of its own for the rest."""
    dp = jdvae.init_decoder_params(jax.random.PRNGKey(0),
                                   tiny_config.decoder)
    vp = jvocos.init_params(jax.random.PRNGKey(1), tiny_config.vocos)
    jchat = JChat(config=tiny_config)
    jchat.decoder_params, jchat.vocos_params = dp, vp
    jchat._device_window_jits, jchat._incr_jits = {}, {}
    own = TChat(config=port_config(tiny_config))
    own.load(source="random", seed=0, device="cpu")
    tchat = TChat(config=own.config)
    tchat.load_params(gpt=own.gpt_params, embed=own.embed_params,
                      decoder=bridge(dp), vocos=bridge(vp),
                      dvae=own.dvae_params, device="cpu")
    return jchat, tchat


@pytest.fixture(scope="module")
def pair(chats):
    """The reference chat's decoder and Vocos params with layer scale
    GAMMA (JAX, and bridged)."""
    return _with_gamma(chats[0].decoder_params, chats[0].vocos_params)


def _close(got, want, what, atol=STREAM_ATOL):
    np.testing.assert_allclose(to_np(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), atol=atol,
                               rtol=atol, err_msg=what)


def _close_tree(got, want, what):
    got_l = jax.tree_util.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert tuple(g.shape) == tuple(w.shape), f"{what} leaf {i}"
        _close(g, w, f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# the stream functions against the JAX ones
# ---------------------------------------------------------------------------


def test_stream_offsets_match_jax(tiny_config):
    for cfg in (tiny_config, _windowed(tiny_config), type(tiny_config)()):
        pcfg = port_config(cfg)
        assert (tconv.stack_stream_offset(pcfg.decoder.stack)
                == jconv.stack_stream_offset(cfg.decoder.stack))
        assert (tdvae.decoder_stream_offset(pcfg.decoder)
                == jdvae.decoder_stream_offset(cfg.decoder))
        assert (tvocos.stream_offset(pcfg.vocos)
                == jvocos.stream_offset(cfg.vocos))
    # the full config's mel offset: 75 + 27 frames (ROADMAP)
    full = type(tiny_config)()
    assert (jdvae.decoder_stream_offset(full.decoder)
            + jvocos.stream_offset(full.vocos)) == 102


@pytest.mark.parametrize("t0,m,cum_off", [(0, 6, 0), (0, 12, 7), (16, 6, 9),
                                          (32, 6, 9), (48, 2, 40)])
def test_mask_head_matches_jax(rng, t0, m, cum_off):
    ext = rng.standard_normal((2, m + 16, 5)).astype(np.float32)
    want = jconv._mask_head(jnp.asarray(ext), jnp.int32(t0), m, cum_off)
    got = tconv._mask_head(torch.from_numpy(ext), t0, m, cum_off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t0", [None, 0, 32])
def test_conv_and_block_stream_match_jax(tiny_config, pair, rng, t0):
    """conv1d_stream and apply_block_stream (dilation 2), one chunk from a
    nonzero cache, against the JAX functions: outputs and new caches."""
    (dp, _), (tdp, _) = pair
    st = tiny_config.decoder.stack
    x = rng.standard_normal((2, 12, st.hidden)).astype(np.float32)
    cache = rng.standard_normal((2, (st.kernel - 1) * st.dilation,
                                 st.hidden)).astype(np.float32)
    kw = dict(kernel=st.kernel, dilation=st.dilation, cum_off=5)
    jt0 = None if t0 is None else jnp.int32(t0)
    # jitted: one compile instead of one per eager op
    want = jax.jit(functools.partial(jconv.apply_block_stream, **kw))(
        dp["decoder"]["blocks"][0], jnp.asarray(x), jnp.asarray(cache),
        t0=jt0)
    got = tconv.apply_block_stream(tdp["decoder"]["blocks"][0],
                                   torch.from_numpy(x),
                                   torch.from_numpy(cache), t0=t0, **kw)
    _close_tree(got, want, "apply_block_stream")
    c3 = cache[:, :2, :]
    w = dp["decoder"]["conv_in1"]["w"][:, :st.hidden, :8]
    want = jax.jit(functools.partial(jconv.conv1d_stream, cum_off=1))(
        jnp.asarray(x), jnp.asarray(c3), w, None, t0=jt0)
    got = tconv.conv1d_stream(torch.from_numpy(x), torch.from_numpy(c3),
                              torch.from_numpy(np.array(w)), None, t0=t0,
                              cum_off=1)
    _close_tree(got, want, "conv1d_stream")


def test_stream_chunks_match_jax(tiny_config, pair, rng):
    """Two chunks through decode_from_hidden_stream -> features_stream ->
    istft_stream (the second consumes the two spec chunks at the mel
    offset), from the init states: every output and state leaf."""
    cfg, pcfg = tiny_config, port_config(tiny_config)
    (dp, vp), (tdp, tvp) = pair
    B, Fh = 2, 16
    F = 2 * Fh
    Dc = jdvae.decoder_stream_offset(cfg.decoder) + jvocos.stream_offset(
        cfg.vocos)
    n_fft, hop = cfg.vocos.n_fft, cfg.vocos.hop_length
    hid = rng.standard_normal((B, 2 * Fh, cfg.decoder.stack.idim * 2)
                              ).astype(np.float32)
    jstate = (jdvae.decoder_stream_init(B, cfg.decoder),
              jvocos.stream_init(B, cfg.vocos),
              jstft.istft_stream_init(B, n_fft, hop))
    tstate = (tdvae.decoder_stream_init(B, pcfg.decoder),
              tvocos.stream_init(B, pcfg.vocos),
              tstft.istft_stream_init(B, n_fft, hop))
    _close_tree(tstate, jstate, "init states")
    jspec = tspec = None
    # jitted once for both chunks (t0 traced), not op by op
    j_dec = jax.jit(functools.partial(jdvae.decode_from_hidden_stream,
                                      cfg=cfg.decoder))
    j_voc = jax.jit(functools.partial(jvocos.features_stream, cfg=cfg.vocos),
                    static_argnames="cum_off")
    j_istft = jax.jit(functools.partial(jstft.istft_stream, n_fft=n_fft,
                                        hop=hop))
    for c in range(2):
        h = hid[:, c * Fh:(c + 1) * Fh]
        jmel, jd, jcum = j_dec(dp, jnp.asarray(h), jstate[0],
                               t0=jnp.int32(c * F))
        jcum = int(jcum)
        tmel, td, tcum = tdvae.decode_from_hidden_stream(
            tdp, torch.from_numpy(h), tstate[0], pcfg.decoder, t0=c * F)
        assert tcum == jcum
        _close(tmel, jmel, f"chunk {c} mel")
        _close_tree(td, jd, f"chunk {c} decoder state")
        js, jv = j_voc(vp, jmel, jstate[1], t0=jnp.int32(c * F),
                       cum_off=jcum)
        ts, tv = tvocos.features_stream(tvp, tmel, tstate[1], pcfg.vocos,
                                        t0=c * F, cum_off=tcum)
        # the spec is exp() of the head: within 1e-5 of its peak
        assert ts.dtype == torch.complex64 and ts.shape == js.shape
        peak = float(np.abs(np.asarray(js)).max())
        _close(ts.real / peak, np.real(js) / peak, f"chunk {c} spec (real)")
        _close(ts.imag / peak, np.imag(js) / peak, f"chunk {c} spec (imag)")
        _close_tree(tv, jv, f"chunk {c} vocos state")
        jcarry, tcarry = jstate[2], tstate[2]
        if c:
            jraw, jcarry = j_istft(
                jnp.concatenate([jspec, js], axis=1)[:, Dc:Dc + F], jcarry)
            traw, tcarry = tstft.istft_stream(
                torch.cat([tspec, ts], dim=1)[:, Dc:Dc + F], tcarry, n_fft,
                hop)
            # past the centre padding the caller drops (where the window
            # sum is tiny), within 1e-5 of the peak
            assert traw.shape == (B, F * hop)
            kept, jkept = traw[:, n_fft // 2:], np.asarray(jraw)[:, n_fft // 2:]
            peak = float(np.abs(jkept).max())
            _close(kept / peak, jkept / peak, "istft_stream samples")
            _close_tree(tcarry, jcarry, "istft_stream carry")
        jstate, tstate = (jd, jv, jcarry), (td, tv, tcarry)
        jspec, tspec = js, ts


def test_istft_stream_makes_dc_and_nyquist_real(monkeypatch, rng):
    """cuFFT does not ignore the imaginary parts of the DC and Nyquist bins
    as pocketfft does, so istft_stream drops them before the inverse FFT,
    as istft does; on the CPU the samples are the same either way (held
    to the JAX function in test_stream_chunks_match_jax)."""
    n_fft, hop = 64, 16
    spec = torch.complex(torch.from_numpy(rng.standard_normal((2, 5, 33))),
                         torch.from_numpy(rng.standard_normal((2, 5, 33)))
                         ).to(torch.complex64)
    seen = []
    irfft = torch.fft.irfft

    def spy(x, *a, **k):
        seen.append(x.clone())
        return irfft(x, *a, **k)

    monkeypatch.setattr(torch.fft, "irfft", spy)
    raw, _ = tstft.istft_stream(spec, tstft.istft_stream_init(2, n_fft, hop),
                                n_fft, hop)
    assert len(seen) == 1
    assert not seen[0][..., 0].imag.any()
    assert not seen[0][..., n_fft // 2].imag.any()
    np.testing.assert_array_equal(seen[0].real.numpy(), spec.real.numpy())
    assert raw.shape == (2, 5 * hop) and torch.isfinite(raw).all()


@pytest.mark.parametrize("Fh", [12, 16])
def test_incremental_chain_matches_full(tiny_config, pair, rng, Fh):
    """The port's conv-state chain (decoder stream -> features_stream ->
    istft_stream, one chunk delayed) reproduces its full hidden -> wav
    decode in the emitted region, as the reference's chain does
    (tests/test_streaming.py); Fh 12 puts the mel offset (24) at exactly
    one chunk's frames."""
    cfg = port_config(tiny_config)
    _, (dp, vp) = pair
    B, n = 2, 5 * Fh
    hid = torch.from_numpy(rng.standard_normal(
        (B, n, cfg.decoder.stack.idim * 2)).astype(np.float32))
    wav_full = tvocos.decode(
        vp, tdvae.decode_from_hidden(dp, hid, cfg.decoder), cfg.vocos)
    F = 2 * Fh
    Dc = (tdvae.decoder_stream_offset(cfg.decoder)
          + tvocos.stream_offset(cfg.vocos))
    assert Dc <= F
    n_fft, hop = cfg.vocos.n_fft, cfg.vocos.hop_length
    dstate = tdvae.decoder_stream_init(B, cfg.decoder)
    vstate = tvocos.stream_init(B, cfg.vocos)
    carry = tstft.istft_stream_init(B, n_fft, hop)
    prev, emitted = None, []
    for c in range(n // Fh):
        mel, dstate, cum = tdvae.decode_from_hidden_stream(
            dp, hid[:, c * Fh:(c + 1) * Fh], dstate, cfg.decoder, t0=c * F)
        spec, vstate = tvocos.features_stream(vp, mel, vstate, cfg.vocos,
                                              t0=c * F, cum_off=cum)
        if prev is not None:
            raw, carry = tstft.istft_stream(
                torch.cat([prev, spec], dim=1)[:, Dc:Dc + F], carry, n_fft,
                hop)
            emitted.append(raw)
        prev = spec
    stream = torch.cat(emitted, dim=1)[:, n_fft // 2:]
    valid = ((n // Fh - 1) * F * hop - n_fft // 2 - (n_fft - hop))
    assert valid > n * hop  # most of the utterance
    _close(stream[:, :valid], to_np(wav_full[:, :valid]), "chain vs full")


# ---------------------------------------------------------------------------
# the facades' pipelined decode on one stubbed schedule
# ---------------------------------------------------------------------------


def _variant(jchat, tchat, branch, chunk):
    """Shallow copies of both facades with ``pipeline_chunk``, caches of
    their own, and for the windowed branch the 4-layer decoder stack (its
    params drawn by JAX, bridged)."""
    cfg = jchat.config.with_runtime(pipeline_chunk=chunk)
    if branch == "windowed":
        cfg = _windowed(cfg)
    j, t = copy.copy(jchat), copy.copy(tchat)
    j.config, t.config = cfg, port_config(cfg)
    j._device_window_jits, j._incr_jits, t._incr_fns = {}, {}, {}
    if branch == "windowed":
        (dp, _), (tdp, _) = _decoder_pair(cfg, seed=3)
        j.decoder_params, t.decoder_params = dp, tdp
    return j, t


class _St:
    def __init__(self, hiddens, end_idx):
        self.hiddens, self.end_idx = hiddens, end_idx


def _schedule(route, buf, ends, ids, ns, jax_side):
    """The code pass a route would run for kept ends ``ends``, yielding at
    step counts ``ns``: "generator" (hiddens up to the kept max, the
    dispatch hook before each yield), "engine" (whole rows, ``n_valid``
    the slowest unfinished row's count)."""
    def arr(a):
        return jnp.asarray(a) if jax_side else torch.from_numpy(
            np.ascontiguousarray(a))

    GO = jg.GenerationOutputs if jax_side else tg.GenerationOutputs

    def gen(on_dispatch):
        for k, n in enumerate(ns):
            lens = np.minimum(n, ends)
            fin = lens == ends if k < len(ns) - 1 else np.ones_like(
                ends, bool)
            end = arr(lens.astype(np.int32 if jax_side else np.int64))
            kw = dict(ids=[ids[b, :lens[b]] for b in range(len(ends))],
                      finished=fin, partial=not fin.all())
            if jax_side:
                kw["hiddens"] = []
            if route == "generator":
                if on_dispatch is not None:
                    on_dispatch(_St(arr(buf), end), n)
                yield GO(hiddens_dev=arr(buf[:, :lens.max()]), end_dev=end,
                         **kw)
            else:
                unfinished = [x for x, f in zip(lens, fin) if not f]
                yield GO(hiddens_dev=arr(buf), end_dev=end,
                         n_valid=int(min(unfinished, default=lens.max())),
                         **kw)
    return gen


def _stub_code_pass(chat, sched, calls=None):
    def stub(batch, stream, return_hidden, params, on_dispatch=None, **kw):
        if calls is not None:
            calls.append(kw)
        return sched(on_dispatch)

    chat._infer_code = stub


def _held(got, want, what):
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale,
                               atol=PIPE_ATOL_OF_PEAK, err_msg=what)


@pytest.mark.parametrize("route", ["generator", "engine"])
@pytest.mark.parametrize("branch", ["incremental", "windowed"])
def test_pipelined_matches_reference_on_one_schedule(chats, rng, monkeypatch,
                                                     route, branch):
    """Both facades' pipelined decode of the same partials: shapes equal,
    samples within 3e-4 of the peak; rows end at 100 and 87 steps (the
    shorter one's buffer past its end random, as a finished row's is), so
    the last chunk is ragged, the flush speculated at dispatch is taken
    (Generator schedule) and the per-row tail is cut."""
    monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", "1")
    monkeypatch.setenv("CHATTTS_PALLAS_STEP", "0")
    chunk = 16
    jchat, tchat = _variant(*chats, branch, chunk)
    cfg = tchat.config.gpt
    # the windowed branch at the flush window (80), fewer window shapes for
    # the reference to compile
    B, n = 2, (100 if branch == "incremental" else 80)
    buf = rng.standard_normal((B, 112, cfg.hidden_size)).astype(np.float32)
    ends = np.array([n, n - 13])
    ids = rng.integers(0, cfg.num_audio_tokens - 1,
                       (B, 112, cfg.num_vq)).astype(np.int32)
    ns = list(range(chunk, n, chunk)) + [n]
    wavs, calls = {}, []
    for side, chat in (("ref", jchat), ("port", tchat)):
        _stub_code_pass(chat, _schedule(route, buf, ends, ids, ns,
                                        side == "ref"), calls)
        p = type(chat).InferCodeParams(max_new_token=n, min_new_token=n,
                                       show_tqdm=False)
        wavs[side] = np.asarray(chat._generate_wavs(TEXTS, True, p))
    assert calls[1]["stream_batch_override"] == chunk
    if branch == "incremental":
        assert (B, chunk) in _chains(tchat)
    else:
        assert tchat._incremental_fns(B, chunk) is None
    hop = tchat.config.vocos.hop_length
    assert wavs["port"].shape == (B, (2 * n - 1) * hop)  # the full decode's
    assert not wavs["port"][1, ends[1] * 2 * hop:].any()
    _held(wavs["port"], wavs["ref"], f"{route}, {branch}")


# ---------------------------------------------------------------------------
# within the port: a real generation, pipelined against one-shot
# ---------------------------------------------------------------------------


def _port_variant(tchat, branch, chunk, use_engine=False):
    cfg = tchat.config.with_runtime(pipeline_chunk=chunk)
    dec = tchat.decoder_params
    if branch == "windowed":
        cfg = _windowed(cfg)
        dec = tdvae.init_decoder_params(torch.Generator().manual_seed(5),
                                        cfg.decoder)
    c = TChat(config=cfg)
    c.load_params(gpt=tchat.gpt_params, embed=tchat.embed_params,
                  decoder=dec, vocos=tchat.vocos_params,
                  dvae=tchat.dvae_params, device="cpu", use_engine=use_engine)
    return c


def _code_params(n, **kw):
    return TChat.InferCodeParams(max_new_token=n, min_new_token=n,
                                 manual_seed=11, show_tqdm=False, **kw)


@pytest.mark.parametrize("route", ["generator", "engine"])
@pytest.mark.parametrize("branch", ["incremental", "windowed"])
def test_pipelined_matches_the_ports_one_shot(chats, monkeypatch, route,
                                              branch):
    """A real generation through ``_generate_wavs`` with the pipeline on:
    its wav within 3e-4 of the peak of the one-shot decode
    (``_decode_to_wavs``) of the same call's hiddens, rows and length
    alike.  The branch that ran is read from ``_incr_fns`` and the widths
    ``_device_window_fn`` was asked for.  On the engine route the pipeline
    steps long chunks, and a live stream of the same chat does not."""
    chunk = 16
    c = _port_variant(chats[1], branch, chunk, use_engine=route == "engine")
    _, guard, window = plan_windows(c.config.decoder.stack, c.config.vocos,
                                    chunk)
    flush_w = window if branch == "windowed" else (
        -(-(2 * chunk + guard + 8) // 16) * 16)
    # past the flush window, a ragged last chunk, no decode-bucket padding
    n = flush_w + 8
    assert n % chunk and not n % (c.config.runtime.decode_bucket // 4)
    widths, final = [], []
    window_fn, infer_code = c._device_window_fn, c._infer_code

    def spy_window(width):
        widths.append(width)
        return window_fn(width)

    def spy_code_pass(*a, **k):
        for out in infer_code(*a, **k):
            final[:] = [out.hiddens_dev, out.end_dev, out.hid_n]
            yield out

    long_chunks = []
    engine_step = tbatch.Engine.step

    def spy_step(self, long_chunk=False):
        long_chunks.append(long_chunk)
        return engine_step(self, long_chunk=long_chunk)

    monkeypatch.setattr(c, "_device_window_fn", spy_window)
    monkeypatch.setattr(c, "_infer_code", spy_code_pass)
    monkeypatch.setattr(tbatch.Engine, "step", spy_step)
    monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", "1")
    got = c._generate_wavs(TEXTS, True, _code_params(n))
    if branch == "incremental":
        assert _chains(c) == [(2, chunk)] and set(widths) == {flush_w}
    else:
        assert not c._incr_fns and set(widths) == {window}
    if route == "engine":
        assert long_chunks and all(long_chunks)
        long_chunks.clear()
        for _ in infer_code(TEXTS, True, True, _code_params(16)):
            pass
        assert long_chunks and not any(long_chunks)
    else:
        assert not long_chunks
    hid, end, hid_n = final
    assert hid_n == n
    ref = c._decode_to_wavs(tg.GenerationOutputs(
        ids=[], finished=np.ones(2, bool), hiddens_dev=hid, end_dev=end,
        n_valid=hid_n), True)
    _held(got, ref, f"{route}, {branch}")


def test_pipelined_short_utterance_is_the_one_shot_decode(chats, monkeypatch):
    """Shorter than one flush window: the pipelined path decodes one-shot,
    and its wav is the non-pipelined path's bit for bit."""
    c = _port_variant(chats[1], "incremental", 16)
    monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", "0")
    ref = c._generate_wavs(["short one"], True, _code_params(16))
    monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", "1")
    got = c._generate_wavs(["short one"], True, _code_params(16))
    assert ref.shape[1] > 0
    np.testing.assert_array_equal(got, ref)


def test_pipelined_resets_on_empty_retry(chats, monkeypatch):
    """A yield after an attempt's final output (the empty-generation retry
    restarted) drops the discarded attempt's audio: the wav is the
    one-shot decode of the kept attempt's hiddens
    (tests/test_core.py::test_pipelined_resets_on_empty_retry's fake
    outputs)."""
    chunk = 16
    c = _port_variant(chats[1], "incremental", chunk)
    _, guard, _ = plan_windows(c.config.decoder.stack, c.config.vocos, chunk)
    flush_w = -(-(2 * chunk + guard + 8) // 16) * 16
    n = -(-(flush_w + chunk) // chunk) * chunk
    D = c.config.gpt.hidden_size
    rng = np.random.default_rng(5)
    hid_a = torch.from_numpy(rng.standard_normal((1, n, D)).astype(
        np.float32))
    hid_b = torch.from_numpy(rng.standard_normal((1, n, D)).astype(
        np.float32))
    end = torch.full((1,), n, dtype=torch.long)

    def outs(hid, partial, upto):
        return tg.GenerationOutputs(
            ids=[np.zeros((upto, c.config.gpt.num_vq), np.int32)],
            finished=np.asarray([not partial]), hiddens_dev=hid[:, :upto],
            end_dev=end, partial=partial)

    def fake_infer_code(batch, stream, return_hidden, params, **kw):
        for hid in (hid_a, hid_b):  # attempt 1 is discarded
            for k in range(1, n // chunk):
                yield outs(hid, True, k * chunk)
            yield outs(hid, False, n)

    monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", "1")
    monkeypatch.setattr(c, "_infer_code", fake_infer_code)
    got = c._generate_wavs(["x"], True, _code_params(n))
    assert (1, chunk) in _chains(c)
    ref = to_np(c._device_decode(hid_b, end))
    _held(got, ref, "after the retry")


def test_incremental_fns_follow_the_config(chats):
    """The chain's steps are rebuilt when what they capture changes: with
    ``wire_int16`` turned on for the same chat and (B, chunk), the step
    emits int16 PCM equal to the float PCM made before, scaled (a stale
    step would hand float PCM to a caller that divides by 32767)."""
    chunk = 16
    c = _port_variant(chats[1], "incremental", chunk)
    hid = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 2 * chunk, c.config.gpt.hidden_size)).astype(np.float32))
    end = torch.full((1,), 2 * chunk, dtype=torch.long)

    def second_chunk():
        init_state, first_fn, step_fn = c._incremental_fns(1, chunk)
        args = (c.decoder_params, c.vocos_params)
        state = first_fn(*args, init_state(), hid[:, :chunk], end)
        return step_fn(*args, state, hid[:, chunk:], 1, end)[0]

    pcm = second_chunk()
    assert pcm.dtype == torch.float32
    c.config = c.config.with_runtime(wire_int16=True)
    wire = second_chunk()
    assert wire.dtype == torch.int16 and len(c._incr_fns) == 2
    np.testing.assert_array_equal(
        wire.numpy(), torch.clamp(pcm * 32767.0, -32767, 32767).to(
            torch.int16).numpy())


@pytest.mark.parametrize("setting,env,on", [
    (None, None, False), (True, None, True), (False, None, False),
    (None, "1", True), (True, "0", False), (False, "1", True)])
def test_pipelined_decode_setting_and_environment(chats, monkeypatch,
                                                  setting, env, on):
    """``runtime.pipelined_decode`` (None is off in the port) and
    ``CHATTTS_PIPELINED_DECODE``, which overrides it both ways; the choice
    reaches ``_pipelined_wavs`` only with the decoder."""
    c = copy.copy(chats[1])
    c.config = c.config.with_runtime(pipelined_decode=setting)
    if env is None:
        monkeypatch.delenv("CHATTTS_PIPELINED_DECODE", raising=False)
    else:
        monkeypatch.setenv("CHATTTS_PIPELINED_DECODE", env)
    seen = []
    monkeypatch.setattr(c, "_pipelined_wavs",
                        lambda batch, params: seen.append(1) or "piped")
    monkeypatch.setattr(c, "_infer_code",
                        lambda *a, **k: iter([tg.GenerationOutputs(
                            ids=[], finished=np.zeros(0, bool))]))
    monkeypatch.setattr(c, "_decode_to_wavs", lambda r, u: "one-shot")
    p = _code_params(8)
    assert c._generate_wavs(["x"], True, p) == ("piped" if on
                                                else "one-shot")
    assert c._generate_wavs(["x"], False, p) == "one-shot"
    assert len(seen) == int(on)
