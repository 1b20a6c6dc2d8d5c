"""Llama-architecture decoder in PyTorch (port of ``chattts_tpu/models/llama.py``).

Plain functions over a parameter tree with the JAX package's layout, so the
two can be held against each other leaf by leaf:

* ``layers[i]["attn"]["wqkv"]`` (D, 3, H, Dh) and ``["wo"]`` (H*Dh, D),
  ``["mlp"]["wgu"]`` (D, 2, I) and ``["down"]`` (I, D), all bf16 in
  (in, out) layout; ``ln1``/``ln2``/``norm`` (D,) f32.

:func:`prefill` runs the prompt through every layer with torch ops (the
reference's prefill is XLA, not a Pallas kernel).  :func:`decode_step` is the
reference's XLA step (bf16 residual, masked full-length attention, one
position or a position per row); the generator's and the engine's decode
step is the kernel of ``ops/decode_step.py`` instead.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GPTConfig

# additive attention-mask value: large-finite so fully-masked softmax rows
# stay NaN-free (see prefill_bias)
_MASK_VALUE = -1e9


def init_params(gen: torch.Generator, cfg: GPTConfig,
                dtype=torch.bfloat16) -> dict:
    """Seeded random tree in the layout above (drawn on the CPU)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, Dh = cfg.num_attention_heads, cfg.head_dim

    def lin(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(dtype)

    layers = [{
        "attn": {"wqkv": lin(D, 3, H, Dh), "wo": lin(H * Dh, D)},
        "mlp": {"wgu": lin(D, 2, I), "down": lin(I, D)},
        "ln1": torch.ones(D),
        "ln2": torch.ones(D),
    } for _ in range(cfg.num_hidden_layers)]
    return {"layers": layers, "norm": torch.ones(D)}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def rope_tables(cfg: GPTConfig) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (max_pos, head_dim), HF half-rotation layout."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    t = np.arange(cfg.max_position_embeddings, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # (T, d/2)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@lru_cache(maxsize=8)
def rope_tables_torch(cfg: GPTConfig, device: torch.device):
    """:func:`rope_tables` as f32 tensors on ``device`` (built once)."""
    cos, sin = rope_tables(cfg)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, T, H, Dh); cos/sin: (B, T, Dh) or (T, Dh)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)


class KVCache(NamedTuple):
    """Per-layer KV leaves: k/v are tuples of L tensors (B, Tmax, H, Dh)."""

    k: tuple
    v: tuple

    @staticmethod
    def create(cfg: GPTConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, max_len, cfg.num_attention_heads, cfg.head_dim)

        def zeros():
            return tuple(torch.zeros(shape, dtype=dtype, device=device)
                         for _ in range(cfg.num_hidden_layers))

        return KVCache(zeros(), zeros())


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("btd,dci->btci", x, p["wgu"])  # (B, T, 2, I)
    return (F.silu(gu[:, :, 0]) * gu[:, :, 1]) @ p["down"]


def _qkv(p: dict, x: torch.Tensor):
    """x (B, T, D) -> q, k, v each (B, T, H, Dh) via one fused matmul."""
    qkv = torch.einsum("btd,dchk->btchk", x, p["wqkv"])
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def prefill_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """Additive bias (B, 1, T0, T0): query i sees key j iff j <= i and
    mask[j].  Large-finite rather than -inf, so a left-pad query row with
    no visible key stays finite instead of poisoning the cache with NaN."""
    T0 = attn_mask.shape[1]
    causal = torch.tril(torch.ones((T0, T0), dtype=torch.bool,
                                   device=attn_mask.device))
    ok = causal[None] & attn_mask[:, None, :]
    bias = torch.where(ok, 0.0, _MASK_VALUE).to(torch.float32)
    return bias[:, None]


def _attend(q, k, v, bias, head_dim: int, dtype):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh), bias (B, 1, Tq, Tk) ->
    (B, Tq, H*Dh): f32 scores, softmax rounded to ``dtype`` before PV."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / math.sqrt(head_dim) + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))
    return o.reshape(o.shape[0], o.shape[1], -1)


def prefill_block(lp: dict, x: torch.Tensor, bias: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, cfg: GPTConfig,
                  dtype=torch.bfloat16):
    """One layer of the full-sequence forward -> (x, k, v)."""
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lp["ln1"], eps)
    q, k, v = _qkv(lp["attn"], h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    x = x + _attend(q, k, v, bias, cfg.head_dim, dtype) @ lp["attn"]["wo"]
    h = rms_norm(x, lp["ln2"], eps)
    return x + _mlp(lp["mlp"], h), k, v


def prefill(params: dict, emb: torch.Tensor, attn_mask: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, cfg: GPTConfig,
            dtype=torch.bfloat16):
    """Full-sequence forward; returns (hidden (B, T0, D) f32, cache).

    ``emb`` (B, T0, D), ``attn_mask`` (B, T0) bool (False at left padding),
    ``positions`` (B, T0) rope positions.  The cache's rows [0, T0) are
    written in place.
    """
    cos_t, sin_t = rope_tables_torch(cfg, emb.device)
    cos, sin = cos_t[positions], sin_t[positions]
    bias = prefill_bias(attn_mask)
    x = emb.to(dtype)
    T0 = emb.shape[1]
    for li, lp in enumerate(params["layers"]):
        x, k, v = prefill_block(lp, x, bias, cos, sin, cfg, dtype)
        cache.k[li][:, :T0] = k.to(cache.k[li].dtype)
        cache.v[li][:, :T0] = v.to(cache.v[li].dtype)
    hidden = rms_norm(x, params["norm"], cfg.rms_norm_eps).to(torch.float32)
    return hidden, cache


def decode_step(params: dict, emb: torch.Tensor, cache: KVCache, cur,
                key_valid: torch.Tensor, positions: torch.Tensor,
                cfg: GPTConfig, dtype=torch.bfloat16):
    """One AR step: writes k/v at row ``cur`` in place, then attends over
    the rows ``key_valid`` marks within [0, cur].  ``cur`` is one position
    (all sequences at the same depth) or a (B,) tensor (continuous batching:
    a position per row, the writes become per-row scatters).  Returns
    (hidden (B, D) f32, cache)."""
    cos_t, sin_t = rope_tables_torch(cfg, emb.device)
    cos = cos_t[positions][:, None, :]  # (B, 1, Dh)
    sin = sin_t[positions][:, None, :]
    B, Tmax = emb.shape[0], cache.k[0].shape[1]
    slots = torch.arange(Tmax, device=emb.device)
    rows = torch.arange(B, device=emb.device)
    cur = torch.as_tensor(cur, device=emb.device).expand(B)
    ok = key_valid & (slots[None, :] <= cur[:, None])
    bias = torch.where(ok, 0.0, _MASK_VALUE).to(torch.float32)[:, None, None, :]
    x = emb[:, None, :].to(dtype)  # (B, 1, D)
    eps = cfg.rms_norm_eps
    for li, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"], eps)
        q, k, v = _qkv(lp["attn"], h)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        cache.k[li][rows, cur] = k[:, 0].to(cache.k[li].dtype)
        cache.v[li][rows, cur] = v[:, 0].to(cache.v[li].dtype)
        o = _attend(q, cache.k[li], cache.v[li], bias, cfg.head_dim, dtype)
        x = x + o @ lp["attn"]["wo"]
        h = rms_norm(x, lp["ln2"], eps)
        x = x + _mlp(lp["mlp"], h)
    hidden = rms_norm(x[:, 0], params["norm"], eps).to(torch.float32)
    return hidden, cache


def load_from_state(state: dict, cfg: GPTConfig) -> dict:
    """An HF LlamaModel state dict of numpy arrays ('model.' prefix already
    stripped) -> the tree above, on the CPU: q/k/v fused into ``wqkv`` (D,
    3, H, Dh) and gate/up into ``wgu`` (D, 2, I), matrices in bfloat16,
    norms in float32.  Each leaf is built from the state on its own, so the
    float32 state is never held as a tree."""
    D, H, Dh, I = (cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                   cfg.intermediate_size)

    def t(key):  # torch Linear (out, in) -> (in, out)
        return np.asarray(state[key]).T

    def mat(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    def vec(key):
        return torch.from_numpy(np.asarray(state[key], np.float32).copy())

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        qkv = np.stack([t(p + "self_attn.q_proj.weight"),
                        t(p + "self_attn.k_proj.weight"),
                        t(p + "self_attn.v_proj.weight")], axis=1)
        gu = np.stack([t(p + "mlp.gate_proj.weight"),
                       t(p + "mlp.up_proj.weight")], axis=1)
        layers.append({
            "attn": {"wqkv": mat(qkv.reshape(D, 3, H, Dh)),
                     "wo": mat(t(p + "self_attn.o_proj.weight"))},
            "mlp": {"wgu": mat(gu.reshape(D, 2, I)),
                    "down": mat(t(p + "mlp.down_proj.weight"))},
            "ln1": vec(p + "input_layernorm.weight"),
            "ln2": vec(p + "post_attention_layernorm.weight"),
        })
    return {"layers": layers, "norm": vec("norm.weight")}
