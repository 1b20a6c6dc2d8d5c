"""Audio I/O: wav read/write, resampling, PCM conversion (a copy of
``chattts_tpu/utils/audio.py``).

Replaces the reference's ``tools/audio`` package (PyAV-based ``load_audio``
resampling to 24 kHz mono, ``av.py:43-127``; PCM->wav/mp3/ogg views,
``pcm.py:8-91``; numba peak quantizer, ``np.py:7-11``).  Without PyAV or
ffmpeg python bindings:

* wav read/write use the stdlib ``wave`` module and the numpy quantizer
  :func:`float_to_int16` (the JAX package's native library is not loaded);
* resampling is a windowed-sinc polyphase implemented in numpy;
* mp3/ogg transcode shells out to an ``ffmpeg`` binary when one exists and
  raises a clear error otherwise.
"""

from __future__ import annotations

import io
import shutil
import subprocess
import wave
from typing import Optional, Union

import numpy as np

SAMPLE_RATE = 24000


def float_to_int16(audio: np.ndarray) -> np.ndarray:
    """f32 -> i16 quantizer (tools/audio/np.py:7-11 semantics).

    A fixed 32767 gain, attenuated only when the peak exceeds full scale
    (integer math: 32767*32768 // (ceil(peak)*32768)).  Quiet audio keeps
    its loudness, and because the gain is constant for in-range signals,
    independently quantized streaming chunks share the same loudness.
    """
    x = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    am = (32767 * 32768) // (max(1, int(np.ceil(peak))) * 32768)
    return np.multiply(x, float(am)).astype(np.int16).reshape(audio.shape)


def write_wav(path_or_buf: Union[str, io.BytesIO], audio: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> None:
    """float32 mono waveform -> 16-bit PCM wav."""
    pcm = float_to_int16(np.asarray(audio, np.float32).reshape(-1))
    w = wave.open(path_or_buf, "wb")
    try:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    finally:
        w.close()


def wav_bytes(audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, audio, sample_rate)
    return buf.getvalue()


def wav_stream_header(sample_rate: int = SAMPLE_RATE) -> bytes:
    """44-byte PCM16-mono WAV header with UNKNOWN length.

    RIFF/data sizes are 0xFFFFFFFF - the convention encoders (ffmpeg) use
    for non-seekable sinks - so a streaming HTTP response can send ONE
    header followed by raw PCM16 frames and remain a single logical wav
    whose true length is wherever the transfer ends (the reference streams
    one logical stream per request, examples/api/openai_api.py:149-285).
    Use :func:`read_wav_stream` to parse such a body.
    """
    import struct

    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                    sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def pcm16_bytes(audio: np.ndarray) -> bytes:
    """float32 waveform -> raw little-endian PCM16 frames (no container).

    Same quantizer as :func:`write_wav` (fixed 32767 gain for in-range
    signals), so independently quantized streaming chunks concatenate into
    the same PCM a whole-file write would produce.
    """
    return float_to_int16(np.asarray(audio, np.float32).reshape(-1)).tobytes()


def read_wav_stream(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a streamed wav body (header sizes may be the 0xFFFFFFFF
    unknown-length convention): reads the fmt chunk, then consumes PCM to
    end-of-data regardless of the declared data size.  Returns
    (float32 mono waveform, sample_rate).  Also accepts ordinary wavs."""
    import struct

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")
    pos, fmt, pcm = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body_end = (len(data) if size == 0xFFFFFFFF
                    else min(len(data), pos + 8 + size))
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", data[pos + 8:pos + 24])
        elif cid == b"data":
            pcm = data[pos + 8:body_end]
        pos = body_end + (body_end & 1 if size != 0xFFFFFFFF else 0)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise ValueError(f"unsupported wav stream format {fmt}")
    x = np.frombuffer(pcm[: len(pcm) - (len(pcm) % (2 * channels))],
                      np.int16).astype(np.float32) / 32768.0
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sample_rate


def read_wav(path_or_buf) -> tuple[np.ndarray, int]:
    """wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    w = wave.open(path_or_buf, "rb")
    try:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    finally:
        w.close()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def resample(audio: np.ndarray, sr_in: int, sr_out: int = SAMPLE_RATE,
             num_zeros: int = 16) -> np.ndarray:
    """Windowed-sinc polyphase resampler (mono float32)."""
    if sr_in == sr_out:
        return np.asarray(audio, np.float32)
    from math import gcd

    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    x = np.asarray(audio, np.float64)
    # upsample by zero-stuffing, filter, then decimate
    cutoff = 0.5 / max(up, down)
    half = num_zeros * max(up, down)
    t = np.arange(-half, half + 1)
    h = 2 * cutoff * np.sinc(2 * cutoff * t) * np.hanning(t.size)
    h *= up
    xs = np.zeros(x.size * up)
    xs[::up] = x
    y = np.convolve(xs, h, mode="same")
    return y[::down].astype(np.float32)


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Audio file -> float32 mono waveform at `sr` (reference av.py:43-127).

    wav natively; other containers through the ffmpeg binary when present.
    """
    if path.lower().endswith(".wav"):
        x, in_sr = read_wav(path)
        return resample(x, in_sr, sr)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"cannot load {path!r}: non-wav decoding needs an ffmpeg binary "
            "(none found on PATH)")
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-i", path, "-f", "f32le", "-ac", "1",
         "-ar", str(sr), "-"],
        capture_output=True, check=True)
    return np.frombuffer(out.stdout, np.float32).copy()


def transcode(audio: np.ndarray, fmt: str, sample_rate: int = SAMPLE_RATE
              ) -> bytes:
    """wav/mp3/ogg bytes from a float32 waveform (pcm.py:8-91 analog)."""
    if fmt == "wav":
        return wav_bytes(audio, sample_rate)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            f"{fmt} output needs an ffmpeg binary (none found on PATH); "
            "wav output is always available")
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-f", "wav", "-i", "-", "-f", fmt, "-"],
        input=wav_bytes(audio, sample_rate), capture_output=True, check=True)
    return out.stdout
