"""``chattts_tpu_torch.engine.streaming`` against
``chattts_tpu.engine.streaming``.

The numpy pieces are copies: ``plan_windows``, ``conv_stack_receptive``,
``StreamingDecoder`` and ``EmissionPacer`` must give the reference's
results bit for bit on the same numpy windows.  The device pieces are
ports: ``DeviceStreamingDecoder`` (and ``AsyncDeviceWindows``) on the
port's window decode (``Chat._device_window_fn``, bridged weights) against
the reference's on its own, on the same hiddens, per-row ends and first
guard, with and without the int16 wire, within atol/rtol 1e-4 (the
tolerance of tests/test_torch_decoder.py: float32 sums in another order).
Inside the port, speculated, final-speculated and mispredicted windows
must equal the inline ones bit for bit, with no window decoded twice; the
emission plan's invariants are the reference's (tests/test_streaming.py).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chattts_tpu.core import Chat as JChat
from chattts_tpu.engine import streaming as jstream
from chattts_tpu_torch import Chat as TChat
from chattts_tpu_torch.config import Config, DecoderConfig, VocosConfig
from chattts_tpu_torch.engine import streaming as tstream
from torch_port_utils import bridge, port_config

ATOL = RTOL = 1e-4


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


def _with_runtime(jchat, tchat, **rt):
    """Shallow copies of both facades with other runtime knobs (the
    reference caches its window jits by window only, so its copy starts
    an empty cache)."""
    j, t = copy.copy(jchat), copy.copy(tchat)
    j.config = jchat.config.with_runtime(**rt)
    j._device_window_jits = {}
    t.config = tchat.config.with_runtime(**rt)
    return j, t


# ---------------------------------------------------------------------------
# the numpy copies: bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream_batch", [4, 16, 24, 30])
@pytest.mark.parametrize("which", ["tiny decoder", "tiny dvae", "full"])
def test_plan_windows_equal_reference(tiny_config, which, stream_batch):
    cfg = tiny_config if which != "full" else type(tiny_config)()
    stack = cfg.dvae.decoder if which == "tiny dvae" else cfg.decoder.stack
    pcfg = port_config(cfg)
    pstack = (pcfg.dvae.decoder if which == "tiny dvae"
              else pcfg.decoder.stack)
    assert (tstream.plan_windows(pstack, pcfg.vocos, stream_batch)
            == jstream.plan_windows(stack, cfg.vocos, stream_batch))
    assert (tstream.conv_stack_receptive(pstack.n_layer, pstack.kernel,
                                         pstack.dilation)
            == jstream.conv_stack_receptive(stack.n_layer, stack.kernel,
                                            stack.dilation))
    # the port's default configuration is the reference's
    assert (tstream.plan_windows(Config().decoder.stack, VocosConfig(),
                                 stream_batch)
            == jstream.plan_windows(type(tiny_config)().decoder.stack,
                                    type(tiny_config)().vocos, stream_batch))
    assert DecoderConfig() == port_config(type(tiny_config)().decoder)


def _stub_decode(window):
    """A deterministic numpy 'vocoder': (B, W, C) -> (B, (2W - 1) * 256)
    samples, each hidden position's feature sum spread over its samples
    plus a ramp, so slicing errors show."""
    def decode(win):
        s = np.asarray(win, np.float32).sum(-1)                # (B, W)
        wav = np.repeat(s, 512, axis=1)[:, :(2 * window - 1) * 256]
        ramp = np.arange(wav.shape[1], dtype=np.float32) * 1e-3
        return (wav + ramp[None]).astype(np.float32)
    return decode


@pytest.mark.parametrize("first_guard", [None, 8])
@pytest.mark.parametrize("int_features", [False, True])
def test_streaming_decoder_bit_equal_to_reference(rng, first_guard,
                                                  int_features):
    B, C, window, T = 3, 4, 96, 150
    dt = np.int32 if int_features else np.float32
    feats = (rng.integers(0, 50, (B, T, C)) if int_features
             else rng.standard_normal((B, T, C))).astype(dt)
    lens = [T, 120, 77]
    kw = dict(ctx=40, guard=32, window=window, int_features=int_features,
              first_guard=first_guard)
    ref = jstream.StreamingDecoder(_stub_decode(window), B, C, **kw)
    got = tstream.StreamingDecoder(_stub_decode(window), B, C, **kw)
    hi = 0
    for step in (5, 13, 24, 7, 40, 24, 37):
        hi = min(hi + step, T)
        items = [feats[b, :min(hi, lens[b])] for b in range(B)]
        final = hi == T
        a = ref.update(items, final=final)
        b = got.update(items, final=final)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got.emitted == ref.emitted and got.available == ref.available
    assert got.emitted == T


def _push_all(pacer_cls, seq, wire):
    pacer = pacer_cls(2, 2, 3000, wire)
    out = []
    for chunk, final in seq:
        e = pacer.push(chunk, final=final)
        out.append(None if e is None else np.array(e))
    out.append(np.array(pacer.flush()))
    return out


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("deferred", [False, True])
def test_emission_pacer_bit_equal_to_reference(rng, wire, deferred):
    """The same pushes through both pacers: materialized arrays, or lists
    of parts (the reference's device slices, the port's host copies of CPU
    tensors); int16 parts on the wire."""
    sizes = [0, 700, 2048, 5000, 1, 4096, 3333]
    parts = []
    for n in sizes:
        x = rng.standard_normal((2, n)).astype(np.float32) * 0.3
        x[:, :n // 7] = 0.0  # silence that the flush strips
        parts.append((x * 32767).astype(np.int16) if wire else x)
    seq_ref, seq_port = [], []
    for i, x in enumerate(parts):
        final = i == len(parts) - 1
        if deferred:
            half = x.shape[1] // 2
            seq_ref.append(([jnp.asarray(x[:, :half]),
                             jnp.asarray(x[:, half:])], final))
            seq_port.append(([tstream.copy_to_host_async(
                torch.from_numpy(x[:, :half].copy())),
                tstream.copy_to_host_async(
                    torch.from_numpy(x[:, half:].copy()))], final))
        else:
            y = x.astype(np.float32) / 32767.0 if wire else x
            seq_ref.append((y, final))
            seq_port.append((y.copy(), final))
    got = _push_all(tstream.EmissionPacer, seq_port, wire and deferred)
    want = _push_all(jstream.EmissionPacer, seq_ref, wire and deferred)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_host_copy_of_a_cpu_tensor_is_the_tensor():
    """On the CPU the copy is a documented no-op: the host copy is the
    tensor's own memory, always ready."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    h = tstream.copy_to_host_async(t)
    assert h.ready() and h.shape == t.shape
    a = np.asarray(h)
    assert np.shares_memory(a, t.numpy())
    np.testing.assert_array_equal(np.asarray(h, np.float64), t.numpy())


# ---------------------------------------------------------------------------
# the device decoder: the port's window decode against the reference's
# ---------------------------------------------------------------------------


def _feeds(cfg, rng, B=2, T=90, extra=40):
    """A generation buffer (B, T + extra, D) with garbage past the kept
    positions, per-row ends (one row shorter), and chunk counts."""
    D = cfg.gpt.hidden_size
    buf = rng.standard_normal((B, T + extra, D)).astype(np.float32)
    end = np.array([T, T - 23][:B], np.int32)
    return buf, end, [17, 34, 51, 68, T]


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("async_windows", [False, True])
def test_device_decoder_matches_reference(chats, rng, wire, async_windows):
    """The facades' own decoders (``_device_stream_decoder``: plan_windows
    geometry, first guard 8, per-row ends masked) on the same buffer and
    chunks, through each side's EmissionPacer with no withheld yields."""
    jchat, tchat = _with_runtime(*chats, wire_int16=wire)
    buf, end, ns = _feeds(tchat.config, rng)
    B = buf.shape[0]
    jsd = jchat._device_stream_decoder(B, 16, async_windows=async_windows)
    tsd = tchat._device_stream_decoder(B, 16, async_windows=async_windows)
    assert (tsd.ctx, tsd.guard, tsd.window, tsd.first_guard) == (
        jsd.ctx, jsd.guard, jsd.window, jsd.first_guard)
    jp = jstream.EmissionPacer(B, 0, 4096, wire)
    tp = tstream.EmissionPacer(B, 0, 4096, wire)
    jbuf, tbuf = jnp.asarray(buf), torch.from_numpy(buf)
    jend, tend = jnp.asarray(end), torch.from_numpy(end).long()
    emitted = 0
    for n in ns:
        final = n == ns[-1]
        a = jp.push(jsd.update_dev(jbuf[:, :n], n, final=final,
                                   end_dev=jend), final=final)
        b = tp.push(tsd.update_dev(tbuf[:, :n], n, final=final,
                                   end_dev=tend), final=final)
        assert (a is None) == (b is None) and tsd.emitted == jsd.emitted
        if a is not None:
            assert a.shape == b.shape and b.dtype == np.float32
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)
            emitted += b.shape[1]
    a, b = jp.flush(), tp.flush()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)
    emitted += b.shape[1]
    assert emitted > (2 * ns[-1] - 1) * 256 - 4096


@pytest.mark.parametrize("lo,hi,pad_left,masked", [
    (0, 40, 0, False), (0, 90, 0, True), (10, 90, 26, True),
    (50, 130, 0, True), (0, 20, 76, False)])
def test_window_decode_matches_reference(chats, rng, lo, hi, pad_left,
                                         masked):
    """One window of ``_device_window_fn``: slice (past the buffer's end
    too), mask past ``hi`` and past each row's end, roll by ``pad_left``."""
    jchat, tchat = chats
    window = 96
    buf, end, _ = _feeds(tchat.config, rng)
    jw = jchat._device_window_fn(window)
    tw = tchat._device_window_fn(window)
    jend = jnp.asarray(end) if masked else None
    tend = torch.from_numpy(end).long() if masked else None
    a = np.asarray(jw(jnp.asarray(buf), lo, hi, pad_left, jend))
    b = tw(torch.from_numpy(buf), lo, hi, pad_left, tend).numpy()
    assert a.shape == b.shape == (buf.shape[0], (2 * window - 1) * 256)
    np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# speculation inside the port: bit-equal to the inline windows
# ---------------------------------------------------------------------------


def _counted(fn, counter):
    def call(*args):
        counter[0] += 1
        return fn(*args)
    return call


def _pair(tchat, window=96, fg=None):
    """Two port decoders on counted copies of the port's window decode."""
    na, nb = [0], [0]
    fn = tchat._device_window_fn(window)
    C = tchat.config.gpt.hidden_size
    kw = dict(ctx=40, guard=32, window=window, first_guard=fg)
    spec = tstream.DeviceStreamingDecoder(_counted(fn, na), 2, C, **kw)
    plain = tstream.DeviceStreamingDecoder(_counted(fn, nb), 2, C, **kw)
    return spec, plain, na, nb


def _buffers(tchat, rng, T, extra=48):
    C = tchat.config.gpt.hidden_size
    feats = torch.from_numpy(rng.standard_normal((2, T, C)).astype(
        np.float32))
    full = torch.cat([feats, torch.from_numpy(rng.standard_normal(
        (2, extra, C)).astype(np.float32))], dim=1)
    return feats, full, torch.full((2,), T, dtype=torch.long)


def test_speculated_windows_match_inline(chats, rng):
    """Windows speculated on the FULL buffer, consumed by chunk-slice
    updates, equal the inline ones bit for bit, and none is decoded
    twice."""
    _, tchat = chats
    T = 80
    feats, full, end = _buffers(tchat, rng, T)
    spec, plain, na, nb = _pair(tchat)
    outs_a, outs_b = [], []
    for hi in range(16, T + 16, 16):
        hi = min(hi, T)
        final = hi == T
        if not final:
            spec.speculate_window(full, hi, end)
        outs_a.append(spec.update_dev(feats[:, :hi], hi, final=final,
                                      end_dev=end))
        outs_b.append(plain.update_dev(feats[:, :hi], hi, final=final,
                                       end_dev=end))
    a, b = np.concatenate(outs_a, axis=1), np.concatenate(outs_b, axis=1)
    assert a.shape == b.shape and np.array_equal(a, b)
    assert na[0] == nb[0] and not spec._specs


def test_speculation_dispatch_ahead_order(chats, rng):
    """Chunk k+1's speculation fires BEFORE chunk k is consumed (the
    Generator's dispatch-ahead); the provably final chunk speculates the
    final flush.  Every window comes from a speculation."""
    _, tchat = chats
    T = 80
    feats, full, end = _buffers(tchat, rng, T)
    spec, plain, na, nb = _pair(tchat)
    ns = list(range(16, T + 1, 16))
    outs_a, outs_b = [], []
    spec.speculate_window(full, ns[0], end)
    for k, n in enumerate(ns):
        final = k == len(ns) - 1
        if k + 1 < len(ns):
            if ns[k + 1] < T:
                spec.speculate_window(full, ns[k + 1], end)
            else:
                spec.speculate_final(full, ns[k + 1], end)
        outs_a.append(spec.update_dev(feats[:, :n], n, final=final,
                                      end_dev=end))
        outs_b.append(plain.update_dev(feats[:, :n], n, final=final,
                                       end_dev=end))
    a, b = np.concatenate(outs_a, axis=1), np.concatenate(outs_b, axis=1)
    assert a.shape == b.shape and np.array_equal(a, b)
    assert na[0] == nb[0] and not spec._specs


def test_speculate_final_multi_window_flush(chats, rng):
    _, tchat = chats
    T = 120
    feats, _, end = _buffers(tchat, rng, T)
    spec, plain, na, nb = _pair(tchat)
    spec.speculate_final(feats, T, end)
    assert len(spec._specs) >= 2
    a = spec.update_dev(feats, T, final=True, end_dev=end)
    b = plain.update_dev(feats, T, final=True, end_dev=end)
    assert a.shape == b.shape and np.array_equal(a, b)
    assert na[0] == nb[0] and not spec._specs


def test_speculation_wrong_prediction_is_exact(chats, rng):
    """Speculated for 64 steps, generation finished at 50: the entry is
    not consumed, and the output equals the plain decoder's."""
    _, tchat = chats
    feats, _, _ = _buffers(tchat, rng, 64, extra=0)
    end = torch.full((2,), 50, dtype=torch.long)
    spec, plain, na, nb = _pair(tchat)
    spec.speculate_window(feats, 64, end)
    a = spec.update_dev(feats[:, :50], 50, final=True, end_dev=end)
    b = plain.update_dev(feats[:, :50], 50, final=True, end_dev=end)
    assert a.shape == b.shape and np.array_equal(a, b)
    assert na[0] > nb[0] and not spec._specs


def test_deferred_windows_equal_inline(chats, rng):
    """AsyncDeviceWindows (host copies read one push later, speculated
    windows sliced on the host) through the pacer equals the inline
    decoder's emission, bit for bit."""
    _, tchat = chats
    T = 96
    feats, full, end = _buffers(tchat, rng, T)
    fn = tchat._device_window_fn(96)
    C = tchat.config.gpt.hidden_size
    kw = dict(ctx=40, guard=32, window=96, first_guard=8)
    deferred = tstream.AsyncDeviceWindows(fn, 2, C, **kw)
    inline = tstream.DeviceStreamingDecoder(fn, 2, C, **kw)
    pa = tstream.EmissionPacer(2, 1, 5000, False)
    pb = tstream.EmissionPacer(2, 1, 5000, False)
    outs_a, outs_b = [], []
    for n in range(16, T + 1, 16):
        final = n == T
        if not final:
            deferred.speculate_window(full, n, end)
        a = pa.push(deferred.update_dev(feats[:, :n], n, final=final,
                                        end_dev=end), final=final)
        b = pb.push(inline.update_dev(feats[:, :n], n, final=final,
                                      end_dev=end), final=final)
        outs_a += [] if a is None else [a]
        outs_b += [] if b is None else [b]
    outs_a.append(pa.flush())
    outs_b.append(pb.flush())
    a, b = np.concatenate(outs_a, axis=1), np.concatenate(outs_b, axis=1)
    assert a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the emission plan
# ---------------------------------------------------------------------------


def test_sim_walk_predicts_emitted():
    B = 1
    stub = lambda f, lo, hi, pl, end=None: torch.zeros(  # noqa: E731
        (B, (2 * 96 - 1) * 256))
    for fg in (None, 8):
        sd = tstream.DeviceStreamingDecoder(stub, B, 4, ctx=40, guard=32,
                                            window=96, first_guard=fg)
        n = 0
        for step in (7, 16, 3, 40, 11, 64, 5):
            n += step
            pred = sd._sim_walk(sd.emitted, n)
            sd.update_dev(torch.zeros((B, n, 4)), n, final=False)
            assert sd.emitted == pred, (fg, n)


def test_plan_walk_invariants_and_reference(rng):
    """The port's ``_plan_walk`` yields the reference's plan, and its
    invariants hold (tests/test_streaming.py::test_plan_walk_invariants),
    over randomized geometries and chunkings."""
    for trial in range(200):
        guard = int(rng.integers(4, 64))
        ctx = guard + int(rng.integers(0, 32))
        window = ctx + guard + 8 + int(rng.integers(0, 64))
        fg = (None if rng.random() < 0.5
              else int(rng.integers(0, guard + 1)))
        kw = dict(ctx=ctx, guard=guard, window=window, first_guard=fg)
        sd = tstream.StreamingDecoder(lambda w: None, 1, 4, **kw)
        ref = jstream.StreamingDecoder(lambda w: None, 1, 4, **kw)
        e = int(rng.integers(0, 80))
        n = e + int(rng.integers(0, 160))
        final = bool(rng.random() < 0.5)
        steps = list(sd._plan_walk(e, n, final))
        assert steps == list(ref._plan_walk(e, n, final))
        g_entry = sd.first_guard if e == 0 else sd.guard
        prev = e
        for e0, lo, hi, emit_hi, pad_left, is_last in steps:
            assert e0 == prev and emit_hi > e0
            assert 0 <= lo <= hi <= n and hi - lo <= window
            if not is_last:
                assert pad_left == 0
                assert emit_hi <= n - g_entry
                assert lo == max(0, e0 - ctx)
            else:
                assert lo == max(0, hi - window)
                if pad_left:
                    assert pad_left == window - (hi - lo)
            prev = emit_hi
        if final and n > e:
            assert prev == n, (trial, guard, ctx, window, e, n)
        if not final and steps:
            assert prev <= n - g_entry
