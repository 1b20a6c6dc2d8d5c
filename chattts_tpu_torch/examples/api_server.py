"""HTTP TTS API server - stdlib, no framework dependencies (port of
``examples/api_server.py``).

Serves the API surfaces of the reference's examples
(``examples/api/main.py:71-119`` and the OpenAI-compatible
``examples/api/openai_api.py:149-285``) plus the WebUI helpers:

* ``POST /generate_voice``  {"text": [...], "spk_emb"?, params...}
  -> audio/wav (or format=zip: one wav per text)
* ``POST /v1/audio/speech`` {"input": "...", "voice"?, "stream"?} -> wav
* ``POST /refine``          {"text": "..."} -> {"refined": "..."}
* ``POST /sample_audio_speaker``  raw wav body -> {"spk_smp": "..."}
* ``GET  /sample_random_speaker`` -> {"spk_emb": "..."}
* ``POST /interrupt``       -> drains all queued/running work
* ``GET  /health``, ``GET /`` (the WebUI page of the JAX package's
  ``examples/webui.html``, read where the repository keeps it)

Unlike the reference (one asyncio.Lock around the model,
openai_api.py:67,205), CONCURRENT requests share the continuous-batching
engine's decode slots through ``chattts_tpu_torch.serving.TTSService``.
The chat and the service belong to the server object (:func:`serve`), so
one process may run several servers.

Run it with ``python -m chattts_tpu_torch.examples.api_server`` (CUDA by
default; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import wave
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from chattts_tpu_torch import Chat
from chattts_tpu_torch.serving import TTSService
from chattts_tpu_torch.utils.audio import (pcm16_bytes, resample, transcode,
                                           wav_bytes, wav_stream_header)
from chattts_tpu_torch.utils.logger import get_logger
from chattts_tpu_torch.utils.seeder import SpeakerSeedContext

logger = get_logger("chattts_tpu_torch.api")

WEBUI = Path(__file__).resolve().parents[2] / "examples" / "webui.html"

# Streaming-cadence defaults come from the dataclass (they are tuned over
# time; stale literals here would silently desynchronize the server from
# the cadence TTSService warms at construction).
_DEFAULTS = Chat.InferCodeParams()
# Each distinct stream_batch is a distinct window shape, whose first decode
# pays first-hit costs (serving.py warmup_stream).  An open HTTP surface
# must not let clients mint an unbounded population of them, so client
# values snap to this fixed set: the default cadence (warmed at service
# construction) and the low-latency lever cadence.
_STREAM_BATCHES = sorted({16, _DEFAULTS.stream_batch})
MAX_NEW_TOKEN = 2048


def _snap_stream_batch(v: int) -> int:
    return min(_STREAM_BATCHES, key=lambda a: (abs(a - v), a))


class Server(ThreadingHTTPServer):
    """The HTTP server with the chat and the service it serves."""

    daemon_threads = True

    def __init__(self, address, chat: Chat, svc: TTSService):
        super().__init__(address, Handler)
        self.chat = chat
        self.svc = svc
        self._voice_lock = threading.Lock()
        self._voices: dict[str, str] = {}  # seed -> spk_emb string cache

    def server_close(self):
        super().server_close()
        self.svc.close()

    def resolve_voice(self, voice) -> Optional[str]:
        """OpenAI `voice` param: a seed number or a raw spk_emb string."""
        if voice is None or voice == "":
            return None
        v = str(voice)
        if v.isdigit():
            with self._voice_lock:
                if v not in self._voices:
                    with SpeakerSeedContext(self.chat.speaker, int(v)):
                        self._voices[v] = self.chat.sample_random_speaker()
                return self._voices[v]
        return v  # assume portable spk_emb string

    def params_from(self, body) -> tuple[Chat.RefineTextParams,
                                         Chat.InferCodeParams]:
        return _params_from(body, self.resolve_voice(
            body.get("voice") or body.get("spk_emb")))


def _params_from(body, spk_emb=None) -> tuple[Chat.RefineTextParams,
                                              Chat.InferCodeParams]:
    """Client parameters, clamped.  ``max_new_token`` is held to [1, 2048]
    and ``min_new_token`` to [0, max_new_token] (the reference clamps only
    the first from above and the second from below: a zero or negative
    maximum then burns every empty-generation retry, and a minimum above
    the maximum suppresses EOS for the whole budget)."""
    max_new = min(max(int(body.get("max_new_token", MAX_NEW_TOKEN)), 1),
                  MAX_NEW_TOKEN)
    p = Chat.InferCodeParams(
        spk_emb=spk_emb,
        spk_smp=body.get("spk_smp"),
        txt_smp=body.get("txt_smp"),
        temperature=float(body.get("temperature", 0.3)),
        top_P=float(body.get("top_p", 0.7)),
        top_K=int(body.get("top_k", 20)),
        max_new_token=max_new,
        min_new_token=min(max(int(body.get("min_new_token", 0)), 0),
                          max_new),
        manual_seed=body.get("manual_seed"),
        stream_batch=_snap_stream_batch(
            int(body.get("stream_batch", _DEFAULTS.stream_batch))),
        stream_speed=min(max(int(body.get(
            "stream_speed", _DEFAULTS.stream_speed)), 2000), 48000),
        pass_first_n_batches=min(max(int(body.get(
            "pass_first_n_batches", _DEFAULTS.pass_first_n_batches)), 0), 8),
    )
    rp = Chat.RefineTextParams(
        prompt=body.get("refine_prompt", ""),
        manual_seed=body.get("manual_seed"),
    )
    return rp, p


class Handler(BaseHTTPRequestHandler):
    server: Server

    def log_message(self, fmt, *args):  # route through our logger
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json_error(self, code: int, msg: str):
        self._json(code, {"error": msg})

    def _bytes(self, payload: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _stream_chunk(self, payload: bytes):
        """One HTTP chunked-transfer frame (empty payloads are skipped - a
        zero-length chunk would terminate the transfer)."""
        if payload:
            self.wfile.write(f"{len(payload):x}\r\n".encode())
            self.wfile.write(payload + b"\r\n")
            self.wfile.flush()

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            try:
                page = WEBUI.read_bytes()
            except OSError:
                return self._json_error(404, "webui.html missing")
            self._bytes(page, "text/html; charset=utf-8")
        elif self.path == "/health":
            self._json(200, {"status": "ok", **self.server.svc.stats()})
        elif self.path == "/sample_random_speaker":
            self._json(200,
                       {"spk_emb": self.server.chat.sample_random_speaker()})
        else:
            self._json_error(404, "not found")

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            return self._json_error(400, "bad Content-Length")
        raw = self.rfile.read(n)

        if self.path == "/sample_audio_speaker":
            return self._sample_audio_speaker(raw)
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            return self._json_error(400, "invalid JSON body")
        if self.path == "/generate_voice":
            return self._generate_voice(body)
        if self.path == "/v1/audio/speech":
            return self._openai_speech(body)
        if self.path == "/refine":
            return self._refine(body)
        if self.path == "/interrupt":
            return self._json(200, {"dropped": self.server.svc.interrupt()})
        return self._json_error(404, "not found")

    def _sample_audio_speaker(self, raw: bytes):
        """Voice clone: wav upload -> spk_smp string (core.py:179-180)."""
        try:
            with wave.open(io.BytesIO(raw)) as w:
                sr = w.getframerate()
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                if w.getnchannels() > 1:
                    pcm = pcm.reshape(-1, w.getnchannels()).mean(1)
        except (wave.Error, EOFError, ValueError) as e:
            return self._json_error(400, f"expected a wav body: {e}")
        wav = pcm.astype(np.float32) / 32768.0
        if sr != 24000:
            wav = resample(wav, sr, 24000)
        smp = self.server.chat.sample_audio_speaker(wav)
        self._json(200, {"spk_smp": smp})

    def _refine(self, body):
        text = body.get("text")
        if not isinstance(text, str) or not text:
            return self._json_error(400, "'text' must be a non-empty string")
        rp, _ = self.server.params_from(body)
        try:
            refined = self.server.svc.refine([text], rp)[0]
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.exception("refine failed")
            return self._json_error(500, f"refine failed: {e}")
        self._json(200, {"refined": refined})

    def _generate_voice(self, body):
        texts = body.get("text")
        if isinstance(texts, str):
            texts = [texts]
        if not texts or not all(isinstance(t, str) and t for t in texts):
            return self._json_error(400, "'text' must be a non-empty string "
                                         "or list of strings")
        fmt = body.get("format", "wav")
        rp, p = self.server.params_from(body)
        skip = bool(body.get("skip_refine_text", False))
        try:
            wavs = [self.server.svc.synthesize(t, rp, p,
                                               skip_refine_text=skip)
                    for t in texts]
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.exception("inference failed")
            return self._json_error(500, f"inference failed: {e}")
        if fmt == "zip":  # one file per text (reference main.py:71-119)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w") as zf:
                for i, w in enumerate(wavs):
                    zf.writestr(f"{i}.wav", wav_bytes(np.asarray(w)))
            return self._bytes(buf.getvalue(), "application/zip")
        audio = (np.concatenate([w for w in wavs if w.size])
                 if any(w.size for w in wavs) else np.zeros(1, np.float32))
        try:
            payload = transcode(audio, fmt)
        except RuntimeError as e:
            return self._json_error(400, str(e))
        self._bytes(payload, f"audio/{fmt}")

    def _openai_speech(self, body):
        text = body.get("input")
        if not isinstance(text, str) or not text:
            return self._json_error(400, "'input' must be a non-empty string")
        fmt = body.get("response_format", "wav")
        if fmt != "wav":
            return self._json_error(
                400, f"response_format {fmt!r} unsupported (wav only)")
        rp, p = self.server.params_from(body)
        svc = self.server.svc
        if bool(body.get("stream", False)):
            # ONE logical wav per response: a single unknown-length header,
            # then raw PCM16 frames per emission window (the reference
            # streams one stream per request, openai_api.py:149-285)
            gen = svc.synthesize_stream(text, p)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._stream_chunk(wav_stream_header())
                for chunk in gen:
                    self._stream_chunk(pcm16_bytes(chunk[0]))
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionError) as e:
                # routine consumer disconnect - not a server failure
                logger.info("stream client gone: %s", e)
            except Exception:  # noqa: BLE001 - synthesis/engine failure:
                # the client gets a truncated body (no terminal chunk);
                # the server must record it as an ERROR, not a disconnect
                logger.exception("stream failed mid-response")
            finally:
                # client disconnect mid-stream: closing the generator fires
                # its abort path, freeing the engine slot immediately
                # instead of decoding to max_new for nobody
                gen.close()
            return
        try:
            audio = svc.synthesize(text, rp, p, skip_refine_text=bool(
                body.get("skip_refine_text", True)))
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.exception("inference failed")
            return self._json_error(500, f"inference failed: {e}")
        self._bytes(wav_bytes(audio), "audio/wav")


def serve(port: int, source: str = "random", config=None, device=None,
          host: str = "0.0.0.0", timeout: float = 600.0) -> Server:
    """Load a chat on the engine route, start its TTSService (whose waits
    give up after ``timeout`` seconds) and return the server, bound but not
    yet serving (call ``serve_forever``)."""
    chat = Chat(logger=logger, config=config)
    chat.load(source=source, device=device, use_engine=True)
    httpd = Server((host, port), chat, TTSService(chat, timeout=timeout))
    logger.info("serving on %s:%d (continuous batching across requests)",
                host, httpd.server_address[1])
    return httpd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--source", default="random", choices=["random"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    serve(args.port, args.source, device=args.device,
          host=args.host).serve_forever()


if __name__ == "__main__":
    main()
