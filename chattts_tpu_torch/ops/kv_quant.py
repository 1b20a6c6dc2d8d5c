"""The int8 and int4 KV wire formats (port of ``kv8_quantize``,
``kv8_dequantize``, ``kv4_quantize`` and ``kv4_dequantize`` in
``chattts_tpu/ops/pallas_step.py``).

A kv8 cache row is ``[q(HD) int8 | m(H) int8 | e(H) int8 | zeros]``, ``HD +
KV_PAD`` bytes wide.  Every (token, head) carries its own scale ``m * 2^e``
with ``m`` in [64, 127] (0 for an all-zero head): the head's absmax / 127,
its mantissa rounded *up* to 7 bits so no value clips.  A kv4 row is
``[packed(HD/2) | m(H) | e(H) | zeros]``, ``HD/2 + KV_PAD`` bytes wide: the
same scales from absmax / 7, values in [-7, 7], feature f < HD/2 in the low
nibble of byte f and feature HD/2 + f in its high nibble.  The prefill
quantizes whole caches with :func:`kv8_quantize` or :func:`kv4_quantize`;
the decode kernel appends rows with the same arithmetic
(``csrc/decode_step.cu``), so both dequantize alike.

Powers of two are built from exponent bits and ``floor(log2(x))`` is read
from them, so the format is the same on every device.  (XLA on the CPU
computes ``exp2`` through ``exp`` and is a unit in the last place off for
|n| >= 13; the reference's formulas are otherwise followed to the letter:
half-to-even rounding, IEEE division.)
"""

from __future__ import annotations

import torch

KV_PAD = 128  # pad lanes of a row; the first 2*H carry the scales


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as f32 for integer-valued ``e`` in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive normal f32 ``x``, as int32."""
    return (x.contiguous().view(torch.int32) >> 23) - 127


def head_scales(a: torch.Tensor, maxq: float = 127.0):
    """Per-head absmax ``a`` (f32) -> (m, es, sdec): the stored mantissa and
    exponent (integer-valued f32) and the decoded scale ``m * 2^es``, for
    values quantized to [-maxq, maxq]."""
    sc = a / maxq
    e = floor_log2(torch.clamp(sc, min=1e-30))
    m = torch.ceil(sc * pow2(-e) * 64.0)          # in [64, 128]
    e = torch.where(m > 127.0, e + 1, e)
    m = torch.where(m > 127.0, torch.full_like(m, 64.0), m)
    m = torch.where(a > 0.0, m, torch.zeros_like(m))
    es = torch.clamp(e - 6, -126, 126)
    return m, es.to(torch.float32), m * pow2(es)


def _quantize_heads(flat: torch.Tensor, cfg, maxq: float):
    """(..., HD) rows -> (integer-valued f32 values (..., HD) in [-maxq,
    maxq], scale lanes (..., KV_PAD) int8 ``[m(H) | e(H) | zeros]``)."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    if 2 * H > KV_PAD:
        raise ValueError("too many heads for the kv-int8/int4 scale lanes")
    x = flat.to(torch.float32)
    lead = x.shape[:-1]
    xh = x.reshape(lead + (H, Dh))
    m, es, sdec = head_scales(xh.abs().amax(dim=-1), maxq)
    q = torch.clamp(torch.round(xh / torch.clamp(sdec, min=1e-30)[..., None]),
                    -maxq, maxq)
    pad = torch.zeros(lead + (KV_PAD - 2 * H,), dtype=torch.int8,
                      device=x.device)
    lanes = torch.cat([m.to(torch.int8), es.to(torch.int8), pad], dim=-1)
    return q.reshape(lead + (H * Dh,)), lanes


def kv8_quantize(flat: torch.Tensor, cfg) -> torch.Tensor:
    """(..., HD) k/v rows -> (..., HD + KV_PAD) int8 rows."""
    q, lanes = _quantize_heads(flat, cfg, 127.0)
    return torch.cat([q.to(torch.int8), lanes], dim=-1)


def kv4_packable(cfg) -> bool:
    """Whether kv4 rows exist for this geometry: an even head dimension and
    HD a multiple of 256, as the reference requires."""
    HD = cfg.num_attention_heads * cfg.head_dim
    return cfg.head_dim % 2 == 0 and HD % 256 == 0


def kv4_quantize(flat: torch.Tensor, cfg) -> torch.Tensor:
    """(..., HD) k/v rows -> (..., HD/2 + KV_PAD) int8 rows of nibbles."""
    if not kv4_packable(cfg):
        raise ValueError("geometry not kv-int4-packable: needs an even head "
                         "dimension and heads * head_dim % 256 == 0")
    q, lanes = _quantize_heads(flat, cfg, 7.0)
    q = q.to(torch.int32)
    half = q.shape[-1] // 2
    u = (q[..., :half] & 15) | ((q[..., half:] & 15) << 4)     # [0, 255]
    packed = ((u << 24) >> 24).to(torch.int8)  # the low byte, sign-extended
    return torch.cat([packed, lanes], dim=-1)


def kv_quantizer(kv_bits: int, cfg):
    """The quantizer of a cache tier (None for 0, the bf16 cache); raises on
    a tier that does not exist, or not for this geometry."""
    if kv_bits not in (0, 8, 4):
        raise ValueError(f"kv_bits must be 8, 4 or 0, not {kv_bits}")
    if kv_bits == 4 and not kv4_packable(cfg):
        raise ValueError("geometry not kv-int4-packable: kv_bits=4 needs an "
                         "even head dimension and heads * head_dim % 256 == 0")
    return {0: None, 8: kv8_quantize, 4: kv4_quantize}[kv_bits]


def row_width(kv_bits: int, cfg) -> int:
    """Elements of a cache row of a tier: HD bf16, or HD (kv8) or HD/2 (kv4)
    bytes and the KV_PAD scale lanes."""
    HD = cfg.num_attention_heads * cfg.head_dim
    return {0: HD, 8: HD + KV_PAD, 4: HD // 2 + KV_PAD}[kv_bits]


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., n) int8 bytes -> (..., 2n) int32 values in [-8, 7]: the low
    nibbles of all bytes, then the high nibbles, sign-extended."""
    b = packed.to(torch.int32)
    return torch.cat([(b << 28) >> 28, b >> 4], dim=-1)


def row_scales(rows: torch.Tensor, cfg) -> torch.Tensor:
    """The (..., H) f32 scales ``m * 2^e`` embedded in kv8 or kv4 rows (the
    scale lanes are the last KV_PAD of either)."""
    H = cfg.num_attention_heads
    at = rows.shape[-1] - KV_PAD
    return (rows[..., at:at + H].to(torch.float32)
            * pow2(rows[..., at + H:at + 2 * H]))


def kv8_dequantize(rows: torch.Tensor, cfg) -> torch.Tensor:
    """Inverse of :func:`kv8_quantize`: (..., HD + KV_PAD) int8 -> f32."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    lead = rows.shape[:-1]
    q = rows[..., :HD].to(torch.float32).reshape(lead + (H, Dh))
    return (q * row_scales(rows, cfg)[..., None]).reshape(lead + (HD,))


def kv4_dequantize(rows: torch.Tensor, cfg) -> torch.Tensor:
    """Inverse of :func:`kv4_quantize`: (..., HD/2 + KV_PAD) int8 -> f32."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    lead = rows.shape[:-1]
    q = unpack_nibbles(rows[..., :HD // 2]).to(torch.float32)
    q = q.reshape(lead + (H, Dh))
    return (q * row_scales(rows, cfg)[..., None]).reshape(lead + (HD,))
