"""String codecs for portable speaker/voice state.

ChatTTS checkpoints speaker embeddings (``spk_emb``), zero-shot voice-clone code
matrices (``spk_smp``) and the DVAE mel coefficient vector (``coef``) as
base16384(+lzma) strings; these codecs are part of the public API surface and
must be byte-compatible (reference: ``ChatTTS/model/speaker.py:89-154``,
``ChatTTS/model/dvae.py:220-248``).

The reference delegates to the external ``pybase16384`` C library.  We ship a
pure-numpy implementation of the same wire format instead: every 14 bits of
payload map to one UTF-16 code unit offset by U+4E00 (the CJK block, so strings
survive copy/paste), and a trailing U+3D0r marker records the remainder ``r``
(payload length mod 7).  Vectorised bit-slicing keeps encode/decode O(n) in
numpy rather than a Python loop.
"""

from __future__ import annotations

import lzma

import numpy as np

_BASE = 0x4E00  # first code unit of the 14-bit alphabet
_PAD = 0x3D00  # padding marker base: chr(0x3D00 + remainder)

_LZMA_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 9 | lzma.PRESET_EXTREME}]


def _bits_of_bytes(data: np.ndarray) -> np.ndarray:
    """uint8 array -> bool bit array, MSB first."""
    return np.unpackbits(data, bitorder="big")


def b14_encode(data: bytes) -> str:
    """Encode bytes to a base16384 string (pybase16384-compatible)."""
    if len(data) == 0:
        return ""
    arr = np.frombuffer(data, dtype=np.uint8)
    rem = len(data) % 7
    # number of 14-bit code units for the payload
    nchars = (len(data) // 7) * 4
    if rem:
        nchars += -(-(8 * rem) // 14)  # ceil
    bits = _bits_of_bytes(arr)
    pad = nchars * 14 - bits.size
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=bits.dtype)])
    groups = bits.reshape(nchars, 14).astype(np.uint16)
    weights = (1 << np.arange(13, -1, -1)).astype(np.uint16)
    vals = (groups * weights).sum(axis=1).astype(np.uint16) + _BASE
    s = "".join(map(chr, vals.tolist()))
    if rem:
        s += chr(_PAD + rem)
    return s


def b14_decode(s: str) -> bytes:
    """Decode a base16384 string to bytes (pybase16384-compatible)."""
    if not s:
        return b""
    rem = 0
    if _PAD < ord(s[-1]) <= _PAD + 6:
        rem = ord(s[-1]) - _PAD
        s = s[:-1]
    vals = np.fromiter((ord(c) - _BASE for c in s), dtype=np.int32, count=len(s))
    if vals.size and (vals.min() < 0 or vals.max() >= 16384):
        raise ValueError("invalid base16384 character in input")
    bits = ((vals[:, None] >> np.arange(13, -1, -1)[None, :]) & 1).astype(np.uint8)
    nbytes = bits.size // 8
    out = np.packbits(bits.reshape(-1)[: nbytes * 8], bitorder="big")
    if rem:
        # last partial block decoded ceil(8*rem/14)*14//8 bytes; keep only rem
        nch = -(-(8 * rem) // 14)
        extra = (nch * 14) // 8
        out = out[: out.size - extra + rem]
    return out.tobytes()


def _lzma_compress(data: bytes) -> bytes:
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _lzma_decompress(data: bytes) -> bytes:
    return lzma.decompress(data, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


# ---------------------------------------------------------------------------
# High-level codecs (wire-compatible with the reference Speaker/DVAE strings)
# ---------------------------------------------------------------------------


def encode_spk_emb(emb: np.ndarray) -> str:
    """float speaker embedding -> portable string (speaker.py:137-151)."""
    arr = np.asarray(emb, dtype=np.float16)
    return b14_encode(_lzma_compress(arr.tobytes()))


def decode_spk_emb(s: str) -> np.ndarray:
    """portable string -> float16 speaker embedding (speaker.py:153-154)."""
    return np.frombuffer(_lzma_decompress(b14_decode(s)), dtype=np.float16).copy()


def encode_code_prompt(prompt: np.ndarray) -> str:
    """2-D uint code matrix (num_vq, T) -> spk_smp string (speaker.py:89-104)."""
    arr = np.asarray(prompt)
    if arr.ndim != 2:
        raise ValueError("prompt must be a 2-D array")
    shp = np.array(arr.shape, dtype="<u2").tobytes()
    return b14_encode(shp + _lzma_compress(arr.astype("<u2").tobytes()))


def decode_code_prompt(s: str) -> np.ndarray:
    """spk_smp string -> int32 code matrix (num_vq, T) (speaker.py:106-124)."""
    dec = b14_decode(s)
    shp = np.frombuffer(dec[:4], dtype="<u2")
    p = np.frombuffer(_lzma_decompress(dec[4:]), dtype="<u2").copy()
    return p.astype(np.int32).reshape(int(shp[0]), int(shp[1]))


def encode_coef(coef: np.ndarray) -> str:
    """DVAE mel coefficient vector -> string (dvae.py:245-248, no lzma)."""
    return b14_encode(np.asarray(coef, dtype=np.float32).tobytes())


def decode_coef(s: str) -> np.ndarray:
    """string -> float32 DVAE mel coefficient vector (dvae.py:222-226)."""
    return np.frombuffer(b14_decode(s), dtype=np.float32).copy()


def decode_spk_stat(s: str) -> tuple[np.ndarray, np.ndarray]:
    """Embedded speaker statistics string -> (std, mean) float16 halves.

    Reference: ``ChatTTS/model/speaker.py:11-16`` (raw b14, no lzma; the
    flat fp16 vector is chunked in half into std then mean).
    """
    stat = np.frombuffer(b14_decode(s), dtype=np.float16)
    n = stat.size // 2
    return stat[:n].copy(), stat[n:].copy()
