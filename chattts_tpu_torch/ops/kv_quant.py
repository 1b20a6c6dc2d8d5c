"""The int8 KV wire format (port of ``kv8_quantize``/``kv8_dequantize`` in
``chattts_tpu/ops/pallas_step.py``).

A cache row is ``[q(HD) int8 | m(H) int8 | e(H) int8 | zeros]``, ``HD +
KV_PAD`` bytes wide.  Every (token, head) carries its own scale ``m * 2^e``
with ``m`` in [64, 127] (0 for an all-zero head): the head's absmax / 127,
its mantissa rounded *up* to 7 bits so no value clips.  The prefill
quantizes whole caches with :func:`kv8_quantize`; the decode kernel appends
rows with the same arithmetic (``csrc/decode_step.cu``), so both dequantize
alike.

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


def head_scales(a: torch.Tensor):
    """Per-head absmax ``a`` (f32) -> (m, es, sdec): the stored mantissa and
    exponent (integer-valued f32) and the decoded scale ``m * 2^es``."""
    sc = a / 127.0
    e = floor_log2(torch.clamp(sc, min=1e-30))
    m = torch.ceil(sc * pow2(-e) * 64.0)          # in [64, 128]
    e = torch.where(m > 127.0, e + 1, e)
    m = torch.where(m > 127.0, torch.full_like(m, 64.0), m)
    m = torch.where(a > 0.0, m, torch.zeros_like(m))
    es = torch.clamp(e - 6, -126, 126)
    return m, es.to(torch.float32), m * pow2(es)


def kv8_quantize(flat: torch.Tensor, cfg) -> torch.Tensor:
    """(..., HD) k/v rows -> (..., HD + KV_PAD) int8 rows."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    if 2 * H > KV_PAD:
        raise ValueError("too many heads for the kv-int8 scale lanes")
    x = flat.to(torch.float32)
    lead = x.shape[:-1]
    xh = x.reshape(lead + (H, Dh))
    m, es, sdec = head_scales(xh.abs().amax(dim=-1))
    q = torch.clamp(torch.round(xh / torch.clamp(sdec, min=1e-30)[..., None]),
                    -127.0, 127.0).to(torch.int8)
    pad = torch.zeros(lead + (KV_PAD - 2 * H,), dtype=torch.int8,
                      device=x.device)
    return torch.cat([q.reshape(lead + (HD,)), m.to(torch.int8),
                      es.to(torch.int8), pad], dim=-1)


def row_scales(rows: torch.Tensor, cfg) -> torch.Tensor:
    """The (..., H) f32 scales ``m * 2^e`` embedded in kv8 rows."""
    H = cfg.num_attention_heads
    HD = H * cfg.head_dim
    return (rows[..., HD:HD + H].to(torch.float32)
            * pow2(rows[..., HD + H:HD + 2 * H]))


def kv8_dequantize(rows: torch.Tensor, cfg) -> torch.Tensor:
    """Inverse of :func:`kv8_quantize`: (..., HD + KV_PAD) int8 -> f32."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    HD = H * Dh
    lead = rows.shape[:-1]
    q = rows[..., :HD].to(torch.float32).reshape(lead + (H, Dh))
    return (q * row_scales(rows, cfg)[..., None]).reshape(lead + (HD,))
