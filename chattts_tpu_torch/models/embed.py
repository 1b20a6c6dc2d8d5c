"""Input embeddings and output heads (port of ``chattts_tpu/models/embed.py``).

One text table, ``num_vq`` stacked audio-code tables (summed where a
position holds a 4-tuple code token), a text head and ``num_vq`` stacked
code heads, with the JAX package's layouts: ``emb_text`` (V_text, D),
``emb_code`` (num_vq, V_audio, D), ``head_text`` (D, V_text), ``head_code``
(num_vq, D, V_audio).  Lookups are plain gathers (the JAX package's one-hot
matmul is a TPU lowering trick).
"""

from __future__ import annotations

import math

import torch

from ..config import GPTConfig
from ..utils.io import as_torch, to_tensor


def init_params(gen: torch.Generator, cfg: GPTConfig,
                dtype=torch.float32) -> dict:
    D = cfg.hidden_size

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return {
        "emb_text": randn(cfg.num_text_tokens, D) * 0.02,
        "emb_code": randn(cfg.num_vq, cfg.num_audio_tokens, D) * 0.02,
        "head_text": randn(D, cfg.num_text_tokens) / math.sqrt(D),
        "head_code": randn(cfg.num_vq, D, cfg.num_audio_tokens) / math.sqrt(D),
    }


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D), ids (...,) -> (..., D), ids clamped into the table."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def embed_prompt(params: dict, ids: torch.Tensor, text_mask: torch.Tensor
                 ) -> torch.Tensor:
    """ids (B, T, num_vq), text_mask (B, T) bool -> (B, T, D): text
    positions embed ids[..., 0] through the text table, code positions the
    sum of the per-codebook tables."""
    tables = params["emb_code"]
    e_text = _lookup(params["emb_text"], ids[..., 0])
    e_code = _lookup(tables[0], ids[..., 0])
    for q in range(1, tables.shape[0]):
        e_code = e_code + _lookup(tables[q], ids[..., q])
    return torch.where(text_mask[..., None], e_text, e_code)


def embed_code_step(params: dict, ids_q: torch.Tensor) -> torch.Tensor:
    """Decode-step code embedding: ids_q (B, num_vq) -> (B, D)."""
    tables = params["emb_code"]
    out = tables[0][ids_q[:, 0]]
    for q in range(1, tables.shape[0]):
        out = out + tables[q][ids_q[:, q]]
    return out


def embed_text_step(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Decode-step text embedding: ids (B,) -> (B, D)."""
    return _lookup(params["emb_text"], ids)


def head_text(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """(..., D) -> text logits (..., V_text), f32."""
    return hidden.to(torch.float32) @ params["head_text"].to(torch.float32)


def head_code(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """(B, D) -> code logits (B, num_vq, V_audio), f32."""
    return torch.einsum("bd,qdv->bqv", hidden.to(torch.float32),
                        params["head_code"].to(torch.float32))


def torch_key_map(cfg: GPTConfig) -> dict:
    """Tree paths -> Embed.safetensors keys (after weight-norm folding).

    Stacked tensors are assembled by :func:`load_from_state` rather than
    mapped 1:1.
    """
    return {
        "emb_text": ("emb_text.weight", ""),
        "head_text": ("head_text.weight", "T"),
    }


def load_from_state(state: dict, cfg: GPTConfig) -> dict:
    """A folded reference Embed state dict (``utils/io.fold_weight_norm``)
    -> the tree of CPU tensors (``utils/io.to_tensor``): the per-codebook
    tables and heads stacked, the heads transposed to (D, V).  Leaves keep
    the checkpoint's float dtype (bf16 included)."""
    def t(key):
        return as_torch(state[key])

    return {
        "emb_text": to_tensor(t("emb_text.weight")),
        "emb_code": to_tensor(torch.stack([
            t(f"emb_code.{q}.weight") for q in range(cfg.num_vq)])),
        "head_text": to_tensor(t("head_text.weight").T),
        "head_code": to_tensor(torch.stack([
            t(f"head_code.{q}.weight").T for q in range(cfg.num_vq)])),
    }
