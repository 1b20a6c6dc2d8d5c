"""The port's stream player against the JAX package's (CPU, tiny config).

``StreamRebuffer`` and ``http_stream`` are held to the JAX ones on the same
input; the CLI writes the stream of the port's ``Chat.infer(stream=True)``
in process and the port's server's streamed PCM with ``--url``.
"""

import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from chattts_tpu_torch import Chat
from chattts_tpu_torch.examples import api_server as api
from chattts_tpu_torch.examples import stream_player as tsp
from chattts_tpu_torch.utils.audio import (float_to_int16, pcm16_bytes,
                                           wav_stream_header)
from torch_port_utils import port_config


@pytest.fixture(scope="module")
def jsp():
    import examples.stream_player as jsp

    return jsp


def _pcm(path):
    with wave.open(str(path), "rb") as w:
        assert w.getframerate() == 24000
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _chunks(rows, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in rng.integers(0, 700, 12):
        shape = (n,) if rows is None else (rows, n)
        out.append(rng.standard_normal(shape).astype(np.float32) * 0.3)
    return out


@pytest.mark.parametrize("rows", [None, 1, 3], ids=["1d", "1xn", "3xn"])
@pytest.mark.parametrize("block", [256, 1000])
def test_rebuffer_matches_jax(jsp, rows, block):
    mine, ref = tsp.StreamRebuffer(block), jsp.StreamRebuffer(block)
    for chunk in _chunks(rows, seed=block + (rows or 0)):
        got, want = list(mine.push(chunk)), list(ref.push(chunk.copy()))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (block,)
            np.testing.assert_array_equal(g, w)
    got, want = mine.flush(), ref.flush()
    np.testing.assert_array_equal(got, want)
    assert mine.flush() is None and ref.flush() is None


@pytest.fixture(scope="module")
def stub():
    """A server that answers any POST with one fixed wav-stream body,
    written in odd-sized pieces (a sample split across writes)."""
    rng = np.random.default_rng(9)
    body = wav_stream_header() + pcm16_bytes(
        rng.standard_normal(5003).astype(np.float32) * 0.2)
    sizes = [1, 7, 44, 3, 8191, 13, 257]

    class Stub(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.end_headers()
            pos, i = 0, 0
            while pos < len(body):
                n = sizes[i % len(sizes)]
                self.wfile.write(body[pos:pos + n])
                self.wfile.flush()
                pos, i = pos + n, i + 1

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", body
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def test_http_stream_matches_jax(jsp, stub):
    url, body = stub
    got = list(tsp.http_stream(url, "hi", 16, manual_seed=3))
    want = list(jsp.http_stream(url, "hi", 16, manual_seed=3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    pcm = np.frombuffer(body[44:], np.int16)
    np.testing.assert_array_equal(np.concatenate(got) * 32768.0, pcm)


def test_main_in_process_writes_the_chat_stream(tiny_config, tmp_path):
    """The CLI's wav is the quantized concatenation of the chunks that a
    fresh chat's ``Chat.infer(stream=True)`` of the same call streams (a
    fresh chat draws the same seeds)."""
    torch.set_num_threads(1)
    cfg = port_config(tiny_config)
    out = tmp_path / "player.wav"
    assert tsp.main(["hello streaming.", "--source", "random", "--device",
                     "cpu", "--max-new", "16", "--block", "512", "-o",
                     str(out)], config=cfg) == 0
    chat = Chat(config=cfg)
    assert chat.load(source="random", device="cpu")
    chunks = list(chat.infer("hello streaming.", stream=True,
                             params_infer_code=Chat.InferCodeParams(
                                 max_new_token=16)))
    assert chunks and all(c.shape[0] == 1 for c in chunks)
    want = float_to_int16(np.concatenate([c.reshape(-1) for c in chunks]))
    got = _pcm(out)
    assert got.size > 0
    np.testing.assert_array_equal(got, want)


def test_main_url_writes_the_servers_stream(tiny_config, tmp_path,
                                            monkeypatch):
    """``--url`` against the port's server on a tiny chat: the wav holds
    the PCM the server streamed (read back as float and quantized again
    by ``write_wav``, which puts each sample within one step of it)."""
    sent = []
    chunk = api.Handler._stream_chunk

    def recording(self, payload):
        sent.append(payload)
        return chunk(self, payload)

    monkeypatch.setattr(api.Handler, "_stream_chunk", recording)
    httpd = api.serve(0, source="random", config=port_config(tiny_config),
                      device="cpu", host="127.0.0.1", timeout=60.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    out = tmp_path / "url.wav"
    try:
        assert tsp.main(["hello over http.", "--url",
                         f"http://127.0.0.1:{httpd.server_address[1]}",
                         "--max-new", "24", "--block", "700", "-o",
                         str(out)]) == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=60)
    stream = b"".join(sent)
    assert stream[:44] == wav_stream_header()
    pcm = np.frombuffer(stream[44:], np.int16)
    got = _pcm(out)
    assert got.size == pcm.size > 0
    np.testing.assert_array_equal(
        got, float_to_int16(pcm.astype(np.float32) / 32768.0))
    assert np.abs(got.astype(np.int32) - pcm).max() <= 1
