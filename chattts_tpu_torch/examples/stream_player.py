"""Streaming playback helper on the port (the counterpart of the JAX
package's ``examples/stream_player.py``).

``StreamRebuffer`` re-buffers a stream's variable-size chunks into
fixed-size blocks, as an audio device takes them; without an audio device
the CLI writes the re-buffered stream to a wav.  The stream comes from
``Chat.infer(stream=True)`` in process (on the card, the Generator's CUDA
decode step on the int8 cache), or with ``--url`` from a running
``api_server``'s streamed ``/v1/audio/speech``.

    python -m chattts_tpu_torch.examples.stream_player "Hello streaming world" -o out.wav
    python -m chattts_tpu_torch.examples.stream_player "Hi." --device cpu --source random
    python -m chattts_tpu_torch.examples.stream_player "Hi." --url http://127.0.0.1:8000
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Iterator, List, Optional

import numpy as np

from chattts_tpu_torch import Chat
from chattts_tpu_torch.utils.audio import SAMPLE_RATE, write_wav
from chattts_tpu_torch.utils.logger import get_logger

logger = get_logger("chattts.stream")


class StreamRebuffer:
    """Accumulates (B, n) or (n,) float chunks, emits fixed-size mono
    blocks: a (1, n) chunk is its row, a (B, n) chunk its rows' mean."""

    def __init__(self, block_size: int = 4096):
        self.block_size = block_size
        self._buf = np.zeros(0, np.float32)

    def push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        if chunk.ndim == 2:
            chunk = chunk.reshape(-1) if chunk.shape[0] == 1 else \
                chunk.mean(axis=0)
        self._buf = np.concatenate([self._buf, chunk.astype(np.float32)])
        while self._buf.size >= self.block_size:
            yield self._buf[: self.block_size]
            self._buf = self._buf[self.block_size:]

    def flush(self) -> Optional[np.ndarray]:
        if self._buf.size:
            out, self._buf = self._buf, np.zeros(0, np.float32)
            return out
        return None


def http_stream(url: str, text: str, max_new: int,
                **body_extra) -> Iterator[np.ndarray]:
    """Read the api_server's streamed ``/v1/audio/speech`` body: ONE wav
    header of unknown length (``utils.audio.wav_stream_header``), then raw
    PCM16.  Skips the 44-byte header and yields float32 blocks as the
    reads arrive, a sample split across two reads carried to the next."""
    body = {"input": text, "stream": True, "max_new_token": max_new,
            **body_extra}
    req = urllib.request.Request(
        url.rstrip("/") + "/v1/audio/speech",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        hdr = r.read(44)
        if hdr[:4] != b"RIFF":
            raise RuntimeError("expected a wav stream")
        carry = b""
        while True:
            raw = r.read(8192)
            if not raw:
                break
            carry += raw
            n = len(carry) // 2 * 2
            if n:
                yield (np.frombuffer(carry[:n], np.int16)
                       .astype(np.float32) / 32768.0)
                carry = carry[n:]


def main(argv: Optional[List[str]] = None, config=None) -> int:
    """Parse ``argv`` (``sys.argv[1:]`` by default), stream, re-buffer and
    write the wav; returns the exit code.  ``config`` overrides the model
    config of the in-process chat (tests pass a small one)."""
    ap = argparse.ArgumentParser(description="stream and re-buffer speech")
    ap.add_argument("text")
    ap.add_argument("--output", "-o", default="stream_out.wav")
    ap.add_argument("--source", default="local",
                    choices=["local", "custom", "random"])
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--max-new", type=int, default=2048)
    ap.add_argument("--url", default=None,
                    help="read a running api_server's HTTP stream instead "
                         "of loading the model in process")
    ap.add_argument("--device", default=None,
                    help="torch device of the in-process chat (default: "
                         "cuda)")
    args = ap.parse_args(argv)

    if args.url is not None:
        chunks = http_stream(args.url, args.text, args.max_new)
    else:
        chat = Chat(logger=logger, config=config)
        if not chat.load(source=args.source, device=args.device):
            logger.error("model load failed")
            return 1
        params = Chat.InferCodeParams(max_new_token=args.max_new)
        chunks = chat.infer(args.text, stream=True,
                            params_infer_code=params)

    rebuf = StreamRebuffer(args.block)
    blocks = []
    t0 = time.time()
    first = None
    for chunk in chunks:
        for block in rebuf.push(chunk):
            if first is None:
                first = time.time() - t0
                logger.info("first audio block after %.2fs", first)
            blocks.append(block)
    tail = rebuf.flush()
    if tail is not None:
        blocks.append(tail)
    wav = np.concatenate(blocks) if blocks else np.zeros(0, np.float32)
    write_wav(args.output, wav)
    logger.info("wrote %s: %.2fs audio, TTFA %.2fs, wall %.2fs",
                args.output, wav.size / SAMPLE_RATE, first or -1,
                time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
