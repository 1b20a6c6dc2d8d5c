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
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GPTConfig
from ..utils.io import as_torch

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


_ROPE_KEPT: dict = {}


def _tracing() -> bool:
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def rope_tables_torch(cfg: GPTConfig, device: torch.device):
    """:func:`rope_tables` as f32 tensors on ``device``, built once per
    (config, device) and kept.  Under a trace (``torch.compile``,
    ``torch.export``) they are built inside the trace, where they become
    the graph's constants, and not kept: only real tensors are, so a trace
    never leaves a traced tensor for later eager calls."""
    key = (cfg, torch.device(device))
    kept = None if _tracing() else _ROPE_KEPT.get(key)
    if kept is not None:
        return kept
    cos, sin = rope_tables(cfg)
    out = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))
    if not _tracing() and all(type(t) is torch.Tensor for t in out):
        _ROPE_KEPT[key] = out
    return out


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


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in their promoted dtype, as
    ``jnp.einsum`` takes them (a bf16 activation times f32 weights is an
    f32 product; equal dtypes pass unchanged)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ gate) * (x @ up), the input of ``down``."""
    gu = _einsum("btd,dci->btci", x, p["wgu"])  # (B, T, 2, I)
    return F.silu(gu[:, :, 0]) * gu[:, :, 1]


def _project(a: torch.Tensor, w: torch.Tensor, reduce, mesh=None
             ) -> torch.Tensor:
    """a @ w; with ``reduce`` (a tensor-parallel rank's sum over ranks, in
    place) or a ``mesh`` of more than one tp rank (its differentiable sum,
    ``Mesh.reduce``) the rank's f32 partial is summed across ranks and
    rounded once to the product's dtype, as the whole product would be.
    Raises if the in-place ``reduce`` meets a partial that needs a
    gradient: autograd cannot differentiate it."""
    if mesh is not None and mesh.shape["tp"] > 1:
        reduce = lambda t: mesh.reduce(t, "tp")  # noqa: E731
    elif reduce is None:
        return _matmul(a, w)
    elif torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        raise RuntimeError("an in-place reduce met a tensor that needs a "
                           "gradient: a training layer sums over tp through "
                           "prefill_block's mesh")
    dt = torch.promote_types(a.dtype, w.dtype)
    return reduce(a.to(torch.float32) @ w.to(torch.float32)).to(dt)


def _qkv(p: dict, x: torch.Tensor):
    """x (B, T, D) -> q, k, v each (B, T, H, Dh) via one fused matmul."""
    qkv = _einsum("btd,dchk->btchk", x, p["wqkv"])
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def prefill_bias(attn_mask: torch.Tensor, start: int = 0,
                 length: Optional[int] = None) -> torch.Tensor:
    """Additive bias (B, 1, length, T0) of the queries at positions
    [start, start + length) (default all T0) over the T0 keys: query i
    sees key j iff j <= i and mask[j].  Large-finite rather than -inf, so
    a left-pad query row with no visible key stays finite instead of
    poisoning the cache with NaN."""
    T0 = attn_mask.shape[1]
    length = T0 - start if length is None else length
    dev = attn_mask.device
    causal = (torch.arange(T0, device=dev)[None, :]
              <= torch.arange(start, start + length, device=dev)[:, None])
    ok = causal[None] & attn_mask[:, None, :]
    bias = torch.where(ok, 0.0, _MASK_VALUE).to(torch.float32)
    return bias[:, None]


def _attend(q, k, v, bias, head_dim: int, dtype):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh), bias (B, 1, Tq, Tk) ->
    (B, Tq, H*Dh): f32 scores, softmax rounded to ``dtype`` before PV (an
    f32 v, from f32 weights, takes the product to f32)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    scores = scores / math.sqrt(head_dim) + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    o = _einsum("bhqk,bkhd->bqhd", probs, v)
    return o.reshape(o.shape[0], o.shape[1], -1)


def prefill_block(lp: dict, x: torch.Tensor, bias: torch.Tensor,
                  cos: torch.Tensor, sin: torch.Tensor, cfg: GPTConfig,
                  dtype=torch.bfloat16, reduce=None, mesh=None):
    """One layer of the full-sequence forward -> (x, k, v).  ``reduce``:
    ``lp`` is a tensor-parallel rank's shard (its heads, its slice of I)
    and the outputs of wo and down are summed over ranks with it (in
    place, no gradient).

    ``mesh``: a training rank's (dp, sp, tp) mesh, differentiable.  Under
    tp > 1 ``lp`` is the rank's tp shard: each normed input is copied onto
    tp before the column-parallel wqkv and wgu (its gradient summed over
    tp) and the f32 partials of the row-parallel wo and down are summed
    over tp (Megatron's pair).  Under sp > 1 ``x`` holds the rank's T/sp
    positions, ``bias`` its rows over all T keys, and k and v are gathered
    over sp; the returned k and v are the rank's own."""
    eps = cfg.rms_norm_eps
    tp = mesh is not None and mesh.shape["tp"] > 1
    sp = mesh is not None and mesh.shape["sp"] > 1
    h = rms_norm(x, lp["ln1"], eps)
    if tp:
        h = mesh.copy(h, "tp")
    q, k, v = _qkv(lp["attn"], h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ka, va = ((mesh.gather_cat(k, "sp", 1), mesh.gather_cat(v, "sp", 1))
              if sp else (k, v))
    x = x + _project(_attend(q, ka, va, bias, cfg.head_dim, dtype),
                     lp["attn"]["wo"], reduce, mesh)
    h = rms_norm(x, lp["ln2"], eps)
    if tp:
        h = mesh.copy(h, "tp")
    x = x + _project(_swiglu(lp["mlp"], h), lp["mlp"]["down"], reduce, mesh)
    return x, k, v


def prefill(params: dict, emb: torch.Tensor, attn_mask: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, cfg: GPTConfig,
            dtype=torch.bfloat16, reduce=None):
    """Full-sequence forward; returns (hidden (B, T0, D) f32, cache).

    ``emb`` (B, T0, D), ``attn_mask`` (B, T0) bool (False at left padding),
    ``positions`` (B, T0) rope positions.  The cache's rows [0, T0) are
    written in place.  ``reduce``: ``params`` is a tensor-parallel rank's
    shard and ``cache`` holds its heads (see :func:`prefill_block`).
    """
    cos_t, sin_t = rope_tables_torch(cfg, emb.device)
    cos, sin = cos_t[positions], sin_t[positions]
    bias = prefill_bias(attn_mask)
    x = emb.to(dtype)
    T0 = emb.shape[1]
    for li, lp in enumerate(params["layers"]):
        x, k, v = prefill_block(lp, x, bias, cos, sin, cfg, dtype, reduce)
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
        o = _attend(q, cache.k[li].to(dtype), cache.v[li].to(dtype), bias,
                    cfg.head_dim, dtype)
        x = x + _matmul(o, lp["attn"]["wo"])
        h = rms_norm(x, lp["ln2"], eps)
        x = x + _matmul(_swiglu(lp["mlp"], h), lp["mlp"]["down"])
    hidden = rms_norm(x[:, 0], params["norm"], eps).to(torch.float32)
    return hidden, cache


def load_from_state(state: dict, cfg: GPTConfig) -> dict:
    """An HF LlamaModel state dict of numpy arrays or bf16 tensors
    (``utils/io.load_safetensors``; the 'model.' prefix already
    stripped) -> the tree above, on the CPU: q/k/v fused into ``wqkv`` (D,
    3, H, Dh) and gate/up into ``wgu`` (D, 2, I), matrices in bfloat16,
    norms in float32.  Each leaf is built from the state on its own, so the
    float32 state is never held as a tree."""
    D, H, Dh, I = (cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim,
                   cfg.intermediate_size)

    def t(key):  # torch Linear (out, in) -> (in, out)
        return as_torch(state[key]).T

    def mat(a):  # one contiguous bf16 copy of its own
        return torch.empty(a.shape, dtype=torch.bfloat16).copy_(a)

    def vec(key):
        a = as_torch(state[key])
        return torch.empty(a.shape, dtype=torch.float32).copy_(a)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        qkv = torch.stack([t(p + "self_attn.q_proj.weight"),
                           t(p + "self_attn.k_proj.weight"),
                           t(p + "self_attn.v_proj.weight")], dim=1)
        gu = torch.stack([t(p + "mlp.gate_proj.weight"),
                          t(p + "mlp.up_proj.weight")], dim=1)
        layers.append({
            "attn": {"wqkv": mat(qkv.reshape(D, 3, H, Dh)),
                     "wo": mat(t(p + "self_attn.o_proj.weight"))},
            "mlp": {"wgu": mat(gu.reshape(D, 2, I)),
                    "down": mat(t(p + "mlp.down_proj.weight"))},
            "ln1": vec(p + "input_layernorm.weight"),
            "ln2": vec(p + "post_attention_layernorm.weight"),
        })
    return {"layers": layers, "norm": vec("norm.weight")}
