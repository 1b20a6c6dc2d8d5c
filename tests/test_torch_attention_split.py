"""The decode step's attention split over key chunks, as the CUDA pair
``attend_scores`` / ``attend_values`` (csrc/decode_step.cu) computes it,
against ``ops/decode_step.py::attend_plain``, on the CPU.

The mirror below is the kernels' decomposition in torch ops: every key's
score is its own dot product (scaled by its key's scale on the quantized
tiers), each chunk of C keys of a row's window [lo_b, cur_b] has a max, the
window's max is the max of those, and each chunk sums p = exp(s - m) and
bf16(p * v_scale) * v into a partial; the partials are added in chunk
order.  The max is exact, so every p, and every bf16-rounded numerator, is
the plain version's: the two differ only in the order of f32 sums.  A sum
of at most T terms in any order is within T * 2^-24 of the exact sum times
the sum of the terms' magnitudes, for the numerator (at most max|v| times
the denominator) and the denominator alike, so o is held to
2 * T * 2^-24 * (max|v| + |o|) per element, both sides' errors added.

``attend_plain`` itself is held to the reference's Pallas kernel by
tests/test_torch_decode_step_variants.py and test_torch_decode_step_tiers.py.
"""

import numpy as np
import pytest
import torch

from chattts_tpu_torch.config import GPTConfig
from chattts_tpu_torch.ops import decode_step as ds
from chattts_tpu_torch.ops import kv_quant

# four heads of 64: HD 256, so kv4 rows pack (two heads share each byte)
CFG = GPTConfig(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                num_hidden_layers=1, max_position_embeddings=1024)
# keys of a window, by the chunk C; "T" is the whole cache, 3C + 5 rows
WINDOWS = {"1": lambda c: 1, "C-1": lambda c: c - 1, "C": lambda c: c,
           "C+1": lambda c: c + 1, "2C+1": lambda c: 2 * c + 1,
           "T": lambda c: 3 * c + 5}


def _bf(x):
    return x.to(torch.bfloat16).to(torch.float32)


def split_attend(q, kr, vr, lo, cur, cfg, chunk, fault=None):
    """The kernels' two-pass schedule: o (B, HD) for roped q (B, HD) f32
    over rows [lo_b, cur_b] of caches kr/vr (B, T, W), any tier.  ``fault``
    plants a mistake the schedule could make: "last_chunk_dropped", or
    "max_per_chunk" (p rounded against its chunk's max, the partials
    rescaled to the window's max afterwards)."""
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    B, T = kr.shape[:2]
    quant = kr.dtype == torch.int8
    qs = _bf(q * (1.0 / float(np.sqrt(Dh)))).reshape(B, H, Dh)
    keys = ds.cache_values(kr, cfg).reshape(B, T, H, Dh)
    vals = ds.cache_values(vr, cfg).reshape(B, T, H, Dh)
    scores = torch.einsum("bhd,bthd->bht", qs, keys)
    v_scales = torch.ones_like(scores)
    if quant:
        scores = scores * kv_quant.row_scales(kr, cfg).transpose(1, 2)
        v_scales = kv_quant.row_scales(vr, cfg).transpose(1, 2)
    o = torch.empty((B, H, Dh))
    for b in range(B):
        first, n = int(lo[b]), int(cur[b]) - int(lo[b]) + 1
        chunks = [(first + i, first + min(i + chunk, n))
                  for i in range(0, n, chunk)]
        maxima = [scores[b, :, s:e].amax(-1) for s, e in chunks]   # (H,) each
        m = torch.stack(maxima).amax(0)
        if fault == "last_chunk_dropped" and len(chunks) > 1:
            chunks = chunks[:-1]
        acc, l = torch.zeros((H, Dh)), torch.zeros(H)
        for (s, e), mc in zip(chunks, maxima):
            ref = mc if fault == "max_per_chunk" else m
            p = torch.exp(scores[b, :, s:e] - ref[:, None])
            num = _bf(p * v_scales[b, :, s:e])
            w = torch.exp(ref - m)[:, None]
            acc = acc + torch.einsum("ht,thd->hd", num, vals[b, s:e]) * w
            l = l + p.sum(-1) * w[:, 0]
        o[b] = acc / l[:, None]
    return o.reshape(B, H * Dh)


def _caches(kv_bits, B, T, rng):
    HD = CFG.num_attention_heads * CFG.head_dim
    out = []
    for _ in range(2):
        c = torch.from_numpy(rng.standard_normal((B, T, HD), np.float32)
                             ).to(torch.bfloat16)
        quantize = kv_quant.kv_quantizer(kv_bits, CFG)
        out.append(quantize(c, CFG) if quantize else c)
    return out


def _case(kv_bits, n, chunk, seed, fault=None):
    """(split, plain, tolerance) for B 3 rows whose windows of n keys start
    at row 0, end at the last row and sit in the middle of a cache of
    3C + 5 rows (or n = T: the whole cache)."""
    T = 3 * chunk + 5
    n = min(n, T)
    rng = np.random.default_rng(seed)
    B, HD = 3, CFG.num_attention_heads * CFG.head_dim
    kr, vr = _caches(kv_bits, B, T, rng)
    q = torch.from_numpy(rng.standard_normal((B, HD), np.float32))
    lo = torch.tensor([0, T - n, (T - n) // 2])
    cur = lo + n - 1
    t = torch.arange(T)
    visible = ((t[None, :] >= lo[:, None])
               & (t[None, :] <= cur[:, None]))[:, None, :]
    want = ds.attend_plain(q, kr, vr, visible, CFG)
    got = split_attend(q, kr, vr, lo, cur, CFG, chunk, fault)
    dequantize = {0: lambda r, cfg: r.float(), 8: kv_quant.kv8_dequantize,
                  4: kv_quant.kv4_dequantize}[kv_bits]
    vmax = dequantize(vr, CFG).abs().max()
    return got, want, 2 * T * 2.0 ** -24 * (vmax + want.abs())


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_split_attention_matches_plain(kv_bits, window, chunk):
    n = WINDOWS[window](chunk)
    got, want, tol = _case(kv_bits, n, chunk, 1000 * kv_bits + n)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= tol).all()), float(
        ((got - want).abs() / tol).max())


@pytest.mark.parametrize("fault", ["last_chunk_dropped", "max_per_chunk"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_tolerance_sees_a_wrong_schedule(kv_bits, fault):
    """The tolerance is tight enough to reject the schedule's faults."""
    got, want, tol = _case(kv_bits, 2 * 64 + 1, 64, 5, fault)
    assert bool(((got - want).abs() > tol).any())
