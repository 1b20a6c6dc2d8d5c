"""``chattts_tpu_torch.serving.TTSService`` and the port's HTTP server.

The service is held to the port's own ``Chat`` on the engine route:
``refine`` gives the facade's refined text, ``synthesize`` the codes of
``Chat.infer`` and its waveform within 1e-5 of the peak (the service's
16-slot engine and the facade's 8-slot one compute a row in batches of
other widths), ``synthesize_stream`` the chunks of
``Chat.infer(stream=True)`` within 1e-4.  In these comparisons the
sampler is replaced by one that picks each token from the request's depth
and codebook alone: a draw's rank order moves with the last ulps of the
logits, which BLAS may round otherwise from one run to the next, and the
comparison is of the paths around the sampler.  (The fallback
tokenizer's character ids also depend on the order characters were first
seen, so the refined text is read from ids of characters it has seen.)
``abort`` and ``interrupt`` unblock their waiters and free the slots; two
concurrent requests share the engine's slots; a waiter whose engine
stalls gets a ``TimeoutError`` within the service's limit.
Two intended differences from the reference are pinned: a stream cadence
is marked warm only once a window has been decoded, and the HTTP server
clamps ``max_new_token`` to [1, 2048] and ``min_new_token`` to
[0, max_new_token].  The HTTP routes are those of tests/test_api_server.py,
against the port's server on 127.0.0.1.

Every wait here is bounded: service timeouts of 60 s, thread joins and
HTTP requests with timeouts.
"""

import dataclasses
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from chattts_tpu_torch import Chat
from chattts_tpu_torch.engine.streaming import plan_windows
from chattts_tpu_torch.examples import api_server as api
from chattts_tpu_torch.serving import TTSService
from chattts_tpu_torch.utils.audio import read_wav_stream, wav_bytes
from torch_port_utils import port_config

TIMEOUT = 60.0


@pytest.fixture(scope="module")
def chat(tiny_config):
    c = Chat(config=port_config(tiny_config))
    c.load(source="random", seed=0, device="cpu", use_engine=True)
    return c


@pytest.fixture()
def svc(chat):
    s = TTSService(chat, timeout=TIMEOUT)
    yield s
    s.interrupt()
    s.close()


def _code(**kw):
    p = dict(max_new_token=48, min_new_token=40, manual_seed=3,
             stream_batch=8, pass_first_n_batches=1, stream_speed=4096,
             show_tqdm=False)
    p.update(kw)
    return Chat.InferCodeParams(**p)


@pytest.fixture()
def forced(chat, monkeypatch):
    """Tokens from the depth and codebook of each row, drawn from the ids
    of the characters of "hello world." (text ids, and code ids below
    EOS): deterministic whatever the logits' last ulps."""
    from chattts_tpu_torch.ops import sampling

    ids, attn, _ = chat.tokenizer.encode(["hello world."],
                                         chat.config.gpt.num_vq)
    allowed = torch.from_numpy(np.unique(ids[0][attn[0]][:, 0])).long()
    assert int(allowed.max()) < chat.tokenizer.break_0_ids

    def sample(logits, params, window_ids, window_mask, step, eos_token,
               max_penalized, noise=None, generator=None):
        rows = logits.shape[0]
        step = torch.as_tensor(step).expand(rows)
        col = torch.arange(rows) % 4
        return allowed[(step * 31 + col * 7 + 5) % len(allowed)]

    monkeypatch.setattr(sampling, "sample", sample)


def _raw_wavs(chat, log):
    inner = chat._decode_to_wavs

    def decode(result, use_decoder):
        log.append(([np.array(i) for i in result.ids],
                    inner(result, use_decoder)))
        return log[-1][1]

    return decode


def _join(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def _wait(pred, what):
    deadline = time.monotonic() + TIMEOUT
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the service against the facade
# ---------------------------------------------------------------------------


def test_synthesize_matches_chat_infer(chat, svc, forced, monkeypatch):
    log = []
    monkeypatch.setattr(chat, "_decode_to_wavs", _raw_wavs(chat, log))
    got = svc.synthesize("hello world.", params_code=_code(),
                         skip_refine_text=True)
    want = chat.infer("hello world.", skip_refine_text=True,
                      split_text=False, params_infer_code=_code())
    (svc_ids, svc_raw), (chat_ids, chat_raw) = log
    np.testing.assert_array_equal(svc_ids[0], chat_ids[0])
    assert svc_raw.shape == chat_raw.shape
    np.testing.assert_allclose(svc_raw, chat_raw,
                               atol=1e-5 * np.abs(chat_raw).max())
    assert got.dtype == np.float32 and got.size > 0
    np.testing.assert_array_equal(got, svc_raw[0][np.abs(svc_raw[0]) > 1e-5])
    assert len(want) == 1 and want[0].size > 0


def test_synthesize_stream_matches_chat_stream(chat, svc, forced):
    got = list(svc.synthesize_stream("hello world.", _code()))
    want = list(chat.infer("hello world.", stream=True, split_text=False,
                           skip_refine_text=True, params_infer_code=_code()))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert len(got) >= 2
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_refine_matches_the_facade(chat, forced):
    """The facade's refine pass runs first: it steps the text engine, which
    an attached service's engine thread steps too (TTSService's docstring)."""
    rp = Chat.RefineTextParams(max_new_token=8, min_new_token=2,
                               manual_seed=5, show_tqdm=False)
    want = chat.infer(["hello world"], split_text=False,
                      refine_text_only=True, params_refine_text=rp)
    svc = TTSService(chat, timeout=TIMEOUT)
    try:
        got = svc.refine(["hello world"], rp)
    finally:
        svc.close()
    assert got == want and len(got) == 1 and got[0]


# ---------------------------------------------------------------------------
# abort, interrupt, concurrency, timeouts
# ---------------------------------------------------------------------------


def _running_rid(eng):
    live = [r.request_id for r in eng.slots if r is not None]
    return live[0] if live else None


def test_abort_ends_a_stream_and_frees_its_slot(chat, svc):
    eng = chat._engine_for_code()
    gen = svc.synthesize_stream("a long stream", _code(
        max_new_token=400, min_new_token=400, pass_first_n_batches=0,
        stream_speed=2048))
    first = next(gen)
    rid = _running_rid(eng)
    assert first.size > 0 and rid is not None
    assert svc.abort(rid)
    rest = list(gen)  # the final notification ends the stream
    total = first.shape[1] + sum(c.shape[1] for c in rest)
    assert total < (2 * 400 - 1) * 256
    _wait(lambda: _running_rid(eng) is None, "the aborted slot is held")
    assert not svc.abort(rid) and not svc._pending


def test_abort_unblocks_synthesize(chat, svc):
    eng = chat._engine_for_code()
    errors = []

    def blocking():
        try:
            svc.synthesize("a long request", params_code=_code(
                max_new_token=400, min_new_token=400), skip_refine_text=True)
        except InterruptedError as e:
            errors.append(e)

    t = threading.Thread(target=blocking)
    t.start()
    _wait(lambda: _running_rid(eng) is not None, "never admitted")
    assert svc.abort(_running_rid(eng))
    _join([t])
    assert len(errors) == 1


def test_closing_a_stream_aborts_it(chat, svc):
    eng = chat._engine_for_code()
    gen = svc.synthesize_stream("abandoned", _code(
        max_new_token=400, min_new_token=400, pass_first_n_batches=0,
        stream_speed=2048))
    next(gen)
    gen.close()
    _wait(lambda: _running_rid(eng) is None and not svc._pending,
          "the abandoned stream still holds its slot")
    # a later request is admitted and served
    assert svc.synthesize("next", params_code=_code(),
                          skip_refine_text=True).size > 0


def test_interrupt_drops_all_work(chat, svc):
    eng = chat._engine_for_code()
    outcome = {}

    def blocking():
        try:
            svc.synthesize("one", params_code=_code(
                max_new_token=400, min_new_token=400), skip_refine_text=True)
        except InterruptedError:
            outcome["synthesize"] = "interrupted"

    def streaming():
        chunks = list(svc.synthesize_stream("two", _code(
            max_new_token=400, min_new_token=400)))
        outcome["stream"] = sum(c.shape[1] for c in chunks)

    ts = [threading.Thread(target=f) for f in (blocking, streaming)]
    for t in ts:
        t.start()
    _wait(lambda: sum(r is not None for r in eng.slots) == 2,
          "both requests were never running together")
    assert svc.interrupt() == 2
    _join(ts)
    assert outcome["synthesize"] == "interrupted"
    assert outcome["stream"] < (2 * 400 - 1) * 256
    assert not eng.has_unfinished() and not svc._pending


def test_two_concurrent_requests_share_slots(svc):
    out = {}

    def hit(seed):
        out[seed] = list(svc.synthesize_stream("concurrency", _code(
            manual_seed=seed, max_new_token=96, min_new_token=96)))

    ts = [threading.Thread(target=hit, args=(s,)) for s in (7, 8)]
    for t in ts:
        t.start()
    _join(ts)
    assert all(sum(c.shape[1] for c in out[s]) > 0 for s in (7, 8))
    assert svc.stats()["peak_slots"] >= 2


def test_a_stalled_engine_times_out_its_waiters(chat):
    """With the engine thread stopped (nothing steps the engines), a request's
    wait ends in TimeoutError after the service's limit, and the request
    is aborted rather than left queued: a blocking one and a stream."""
    svc = TTSService(chat, timeout=0.5)
    svc.close()  # the engine thread ends; submissions are never stepped
    eng = chat._engine_for_code()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        svc.synthesize("stalled", params_code=_code(), skip_refine_text=True)
    assert time.monotonic() - t0 < TIMEOUT
    assert not svc._pending and not eng.has_unfinished()
    with pytest.raises(TimeoutError):
        next(svc.synthesize_stream("stalled", _code()))
    assert not svc._pending and not eng.has_unfinished()


def test_cadence_is_warm_only_after_a_window_was_decoded(tiny_config):
    """Intended difference from the reference (``chattts_tpu/serving.py``
    marks a cadence warm after its first ``update_dev``, decoded or not):
    with no first-emission guard and a guard longer than the engine's
    chunk, the first increment decodes no window, and the cadence must not
    be marked warm then - only once a window has been decoded."""
    base = port_config(tiny_config)
    cfg = dataclasses.replace(
        base, decoder=dataclasses.replace(base.decoder, stack=dataclasses
                                          .replace(base.decoder.stack,
                                                   n_layer=6)),
    ).with_runtime(stream_first_guard=None)
    _, guard, _ = plan_windows(cfg.decoder.stack, cfg.vocos, 8)
    c = Chat(config=cfg)
    c.load(source="random", seed=0, device="cpu", use_engine=True)
    chunk = c._engine_for_code().ecfg.chunk_steps
    assert guard > chunk  # the first increment cannot emit
    svc = TTSService(c, timeout=TIMEOUT)
    decoded = []
    marks = []

    class Watched(set):
        def add(self, v):
            marks.append(len(decoded))
            super().add(v)

    svc._warm_windows = Watched()
    make = c._device_stream_decoder

    def counting(*a, **k):
        sd = make(*a, **k)
        fn = sd._decode_window_dev

        def window(*args):
            decoded.append(args[1:4])
            return fn(*args)

        sd._decode_window_dev = window
        return sd

    c._device_stream_decoder = counting
    try:
        chunks = list(svc.synthesize_stream("warm me", _code(
            max_new_token=96, min_new_token=96)))
    finally:
        svc.close()
    assert sum(ch.shape[1] for ch in chunks) > 0
    assert marks and all(m > 0 for m in marks)
    assert 8 in svc._warm_windows


# ---------------------------------------------------------------------------
# the HTTP server (tests/test_api_server.py's routes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server(tiny_config):
    httpd = api.serve(0, config=port_config(tiny_config), device="cpu",
                      host="127.0.0.1", timeout=TIMEOUT)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=TIMEOUT)


def _post(url, path, body):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def test_health(server):
    _, url = server
    with urllib.request.urlopen(url + "/health", timeout=TIMEOUT) as r:
        body = json.load(r)
    assert body["status"] == "ok" and body["code"]["slots"] == 16


def test_webui_page(server):
    _, url = server
    with urllib.request.urlopen(url + "/", timeout=TIMEOUT) as r:
        body = r.read()
    assert r.headers["Content-Type"].startswith("text/html")
    assert b"generate_voice" in body


def test_generate_voice(server):
    _, url = server
    body = {"text": ["hi there"], "skip_refine_text": True,
            "max_new_token": 12, "min_new_token": 6, "manual_seed": 1}
    with _post(url, "/generate_voice", body) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "audio/wav"
    assert data[:4] == b"RIFF"


def test_openai_speech(server):
    _, url = server
    body = {"input": "hello", "skip_refine_text": True,
            "max_new_token": 12, "min_new_token": 6, "manual_seed": 2}
    with _post(url, "/v1/audio/speech", body) as r:
        assert r.read()[:4] == b"RIFF"


def test_openai_speech_stream(server):
    """ONE logical wav (one unknown-length header, then PCM16 frames), and
    its samples equal a non-streamed render of the same seed up to
    deletions of sub-audible samples (the one-shot path strips |x| < 1e-5
    anywhere, the stream only its tail), as tests/test_api_server.py
    holds the reference's."""
    _, url = server
    body = {"input": "hello streaming", "skip_refine_text": True,
            "stream": True, "max_new_token": 64, "min_new_token": 64,
            "stream_batch": 4, "pass_first_n_batches": 0,
            "stream_speed": 2048, "manual_seed": 3}
    with _post(url, "/v1/audio/speech", body) as r:
        data = r.read()
    assert data[:4] == b"RIFF" and data.count(b"RIFF") == 1
    streamed, sr = read_wav_stream(data)
    assert sr == 24000 and streamed.size > 0
    ns = dict(body)
    ns.pop("stream")
    with _post(url, "/v1/audio/speech", ns) as r:
        ref, _ = read_wav_stream(r.read())
    atol, eps = 2e-4, 3e-4
    i = j = skips = 0
    while i < streamed.size and j < ref.size:
        if abs(streamed[i] - ref[j]) <= atol:
            i += 1
            j += 1
        elif abs(streamed[i]) <= eps:
            i += 1
            skips += 1
        elif abs(ref[j]) <= eps:
            j += 1
            skips += 1
        else:
            raise AssertionError(f"stream diverges from render at {i}/{j}: "
                                 f"{streamed[i]} vs {ref[j]}")
    skips += (streamed.size - i) + (ref.size - j)
    assert skips <= 8, f"{skips} unmatched samples"


def test_openai_speech_stream_disconnect_aborts(server):
    httpd, url = server
    u = urllib.parse.urlparse(url)
    body = json.dumps({
        "input": "very long stream to abandon", "stream": True,
        "max_new_token": 512, "min_new_token": 512, "stream_batch": 4,
        "pass_first_n_batches": 0, "stream_speed": 256,
        "manual_seed": 11}).encode()
    s = socket.create_connection((u.hostname, u.port), timeout=TIMEOUT)
    try:
        s.sendall(b"POST /v1/audio/speech HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"RIFF" not in got:
            chunk = s.recv(4096)
            assert chunk, "server closed before streaming"
            got += chunk
    finally:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
        s.close()
    eng = httpd.chat._engine_for_code()
    _wait(lambda: (not any(r is not None for r in eng.slots)
                   and not eng.waiting and not httpd.svc._pending),
          "abandoned stream still holds a decode slot")


def test_bad_requests(server):
    _, url = server
    for path, body in [
        ("/generate_voice", {}),
        ("/generate_voice", {"text": ""}),
        ("/v1/audio/speech", {}),
        ("/v1/audio/speech", {"input": "x", "response_format": "mp3"}),
    ]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, path, body)
        assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, "/nope", {})
    assert ei.value.code == 404


def test_concurrent_requests_share_slots(server):
    _, url = server
    body = {"input": "concurrency test sentence", "skip_refine_text": True,
            "max_new_token": 96, "min_new_token": 96}
    results = []

    def hit(seed):
        with _post(url, "/v1/audio/speech", dict(body, manual_seed=seed)) as r:
            results.append(r.read()[:4])

    ts = [threading.Thread(target=hit, args=(s,)) for s in (7, 8, 9)]
    for t in ts:
        t.start()
    _join(ts)
    assert results == [b"RIFF"] * 3
    with urllib.request.urlopen(url + "/health", timeout=TIMEOUT) as r:
        assert json.load(r)["peak_slots"] >= 2


def test_refine_endpoint(server):
    _, url = server
    with _post(url, "/refine", {"text": "refine me", "manual_seed": 5}) as r:
        assert isinstance(json.load(r)["refined"], str)


def test_sample_speakers_and_clone(server):
    _, url = server
    with urllib.request.urlopen(url + "/sample_random_speaker",
                                timeout=TIMEOUT) as r:
        emb = json.load(r)["spk_emb"]
    assert isinstance(emb, str) and len(emb) > 10
    wav = (np.sin(np.linspace(0, 440 * 2 * np.pi, 24000)) * 0.3
           ).astype(np.float32)
    req = urllib.request.Request(
        url + "/sample_audio_speaker", data=wav_bytes(wav),
        headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        smp = json.load(r)["spk_smp"]
    assert isinstance(smp, str) and len(smp) > 4
    body = {"text": "cloned voice", "skip_refine_text": True,
            "spk_smp": smp, "txt_smp": "reference",
            "max_new_token": 10, "min_new_token": 4, "manual_seed": 6}
    with _post(url, "/generate_voice", body) as r:
        assert r.read()[:4] == b"RIFF"


def test_interrupt_endpoint(server):
    _, url = server
    with _post(url, "/interrupt", {}) as r:
        assert "dropped" in json.load(r)


def test_generate_voice_zip(server):
    _, url = server
    body = {"text": ["one", "two"], "format": "zip", "skip_refine_text": True,
            "max_new_token": 10, "min_new_token": 4, "manual_seed": 4}
    with _post(url, "/generate_voice", body) as r:
        data = r.read()
    assert r.headers["Content-Type"] == "application/zip"
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        assert sorted(zf.namelist()) == ["0.wav", "1.wav"]
        for n in zf.namelist():
            assert zf.read(n)[:4] == b"RIFF"


def test_params_clamped_to_bounded_population():
    d = Chat.InferCodeParams()
    _, p = api._params_from({})
    assert (p.stream_batch, p.stream_speed, p.pass_first_n_batches) == (
        d.stream_batch, d.stream_speed, d.pass_first_n_batches)
    for asked, snapped in [(5, 16), (16, 16), (17, 16), (21, 24),
                           (24, 24), (1000, 24), (0, 16)]:
        _, p = api._params_from({"stream_batch": asked})
        assert p.stream_batch == snapped, (asked, p.stream_batch, snapped)
    _, p = api._params_from({"max_new_token": 10 ** 9,
                             "min_new_token": -5,
                             "stream_speed": 10 ** 9,
                             "pass_first_n_batches": 99})
    assert p.max_new_token == 2048 and p.min_new_token == 0
    assert p.stream_speed == 48000 and p.pass_first_n_batches == 8


@pytest.mark.parametrize("max_new,min_new,want", [
    (0, 0, (1, 0)), (-7, 3, (1, 1)), (100, 500, (100, 100)),
    (10 ** 9, 10 ** 9, (2048, 2048)), (64, 32, (64, 32))])
def test_token_bounds_clamped_on_both_sides(max_new, min_new, want):
    """Intended difference from the reference (``examples/api_server.py``
    clamps ``max_new_token`` only from above and ``min_new_token`` only
    from below): a non-positive maximum would end every attempt empty and
    burn the retries, a minimum above the maximum would suppress EOS for
    the whole budget."""
    _, p = api._params_from({"max_new_token": max_new,
                             "min_new_token": min_new})
    assert (p.max_new_token, p.min_new_token) == want
