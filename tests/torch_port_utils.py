"""Helpers shared by the tests that hold chattts_tpu_torch against chattts_tpu.

Both packages run on the CPU here.  Data crosses between them as numpy
arrays: inputs and Gumbel noise are made once and handed to both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chattts_tpu_torch import config as port_config_mod
from chattts_tpu_torch.weights import from_numpy


def port_config(cfg):
    """A chattts_tpu config (tree of frozen dataclasses) -> the port's."""
    cls = getattr(port_config_mod, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def bridge(tree) -> dict:
    """A JAX parameter tree -> the same tree of CPU tensors."""
    return from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


class JaxGumbel:
    """The Gumbel noise the JAX Generator draws at each step.

    Its step body splits ``rng, sub = split(rng)`` from ``PRNGKey(seed)``
    and draws ``categorical(sub, s_asc)`` = argmax(s_asc + gumbel(sub)).
    Calling this with a step returns that step's noise as a tensor.
    """

    def __init__(self, seed: int, shape):
        self.shape = tuple(shape)
        self._keys = [jax.random.PRNGKey(seed)]
        self._subs = []

    def __call__(self, step: int) -> torch.Tensor:
        while len(self._subs) <= step:
            key, sub = jax.random.split(self._keys[-1])
            self._keys.append(key)
            self._subs.append(sub)
        g = jax.random.gumbel(self._subs[step], self.shape, jnp.float32)
        return torch.from_numpy(np.array(g))


def forced_tokens(num_vq: int, infer_text: bool, eos: int, max_new: int,
                  ids) -> np.ndarray:
    """(max_new, B, num_vq) tokens that replay a generation: each row's
    kept ids, then EOS from the step it finished on."""
    out = np.full((max_new, len(ids), num_vq), eos, np.int64)
    for b, seq in enumerate(ids):
        seq = seq[:, None] if infer_text else seq
        out[:len(seq), b] = seq
    return out


def gfsq_boundary_distance(jparams, x, cfg) -> np.ndarray:
    """Per (B, T, G*R) code of ``chattts_tpu.models.gfsq.quantize(jparams,
    x)``: how far the nearest of its bounded values lies from a rounding
    boundary (a half-integer), f32.  A code the port gives otherwise is a
    rounding flip only where this is tiny."""
    from chattts_tpu.models import gfsq

    lv = np.asarray(cfg.levels, np.float32)
    half_l = (lv - 1.0) * (1.0 + 1e-3) / 2.0
    offset = np.where(np.asarray(cfg.levels) % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)
    dpg = cfg.dim // cfg.groups
    scales = gfsq._scales(cfg)
    out = []
    for g in range(cfg.groups):
        gp = jparams["groups"][g]
        res = np.asarray(jnp.asarray(x[..., g * dpg:(g + 1) * dpg])
                         @ gp["project_in"]["w"] + gp["project_in"]["b"])
        for r in range(cfg.residuals):
            bounded = np.tanh(res / scales[r] + shift) * half_l - offset
            out.append(np.abs(np.abs(bounded - np.floor(bounded)) - 0.5)
                       .min(-1))
            codes, _ = gfsq._fsq_quantize(jnp.asarray(res / scales[r]), cfg)
            res = res - np.asarray(codes) * scales[r]
    return np.stack(out, -1)


def write_tokenizer(path: str, vocab_size: int) -> None:
    """A BERT WordPiece tokenizer of ``vocab_size`` ids saved by
    ``BertTokenizerFast.save_pretrained`` into ``path``: the special tokens,
    Latin letters, digits, punctuation, a few words and pieces, some CJK
    characters, padding entries, and the ChatTTS control tokens added last
    (so every one sits at or above ``[break_0]``), the first 20 as normal
    added tokens and the rest as special ones."""
    import os
    import tempfile

    from transformers import BertTokenizerFast

    from chattts_tpu_torch.models.tokenizer import CONTROL_TOKENS

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'\"-()[]_:;/")
    vocab += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    vocab += ["hello", "world", "the", "quick", "brown", "##ing", "##ed",
              "un", "##believ", "##able", "cafe", "naive", "speech"]
    vocab += list("你好世界中文语音合成我们")
    base = vocab_size - len(CONTROL_TOKENS)
    if len(vocab) > base:
        raise ValueError(f"vocab_size {vocab_size} is too small")
    vocab += [f"[unused{i}]" for i in range(base - len(vocab))]
    with tempfile.TemporaryDirectory() as d:
        vf = os.path.join(d, "vocab.txt")
        with open(vf, "w", encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")
        tok = BertTokenizerFast(vocab_file=vf)
        tok.add_tokens(CONTROL_TOKENS[:20])
        tok.add_special_tokens(
            {"additional_special_tokens": CONTROL_TOKENS[20:]})
        assert len(tok) == vocab_size
        tok.save_pretrained(path)


def write_tiny_tree(base: str, cfg, dtype, rng) -> dict:
    """A ChatTTS asset tree in the reference layout under ``base/asset``,
    for the JAX config ``cfg``: each checkpoint a random state dict in the
    torch formats the reference writes (as
    ``test_weight_loading._synth_state`` builds them), stored as ``dtype``
    with ``safetensors``; the Embed heads as weight-norm pairs, the GPT with
    HF LlamaModel names; ``gpt/config.json`` and a tokenizer of
    ``cfg.gpt.num_text_tokens`` ids.  Returns the state dicts by file."""
    import json
    import os

    from safetensors.numpy import save_file

    from chattts_tpu.models import dvae as jdvae
    from chattts_tpu.models import vocos as jvocos
    from test_weight_loading import _synth_state

    a = os.path.join(base, "asset")
    os.makedirs(os.path.join(a, "gpt"))
    key = jax.random.PRNGKey(0)
    states = {
        "DVAE": _synth_state(jdvae.init_dvae_params(key, cfg.dvae),
                             jdvae.dvae_torch_key_map(cfg.dvae), rng),
        "Decoder": _synth_state(jdvae.init_decoder_params(key, cfg.decoder),
                                jdvae.decoder_torch_key_map(cfg.decoder),
                                rng),
        "Vocos": _synth_state(jvocos.init_params(key, cfg.vocos),
                              jvocos.torch_key_map(cfg.vocos), rng),
    }
    g = cfg.gpt
    D, Vt, Va = g.hidden_size, g.num_text_tokens, g.num_audio_tokens
    emb = {"emb_text.weight": rng.standard_normal((Vt, D))}

    def wn_pair(prefix, w):
        emb[f"{prefix}.parametrizations.weight.original0"] = (
            np.sqrt((w * w).sum(axis=1, keepdims=True))
            * rng.uniform(0.5, 2.0, (w.shape[0], 1)))
        emb[f"{prefix}.parametrizations.weight.original1"] = w

    wn_pair("head_text", rng.standard_normal((Vt, D)))
    for q in range(g.num_vq):
        emb[f"emb_code.{q}.weight"] = rng.standard_normal((Va, D))
        wn_pair(f"head_code.{q}", rng.standard_normal((Va, D)))
    states["Embed"] = emb
    HD, I = g.num_attention_heads * g.head_dim, g.intermediate_size
    gpt = {"model.norm.weight": 1 + 0.1 * rng.standard_normal(D)}
    for i in range(g.num_hidden_layers):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (HD, D)),
                            ("self_attn.k_proj", (HD, D)),
                            ("self_attn.v_proj", (HD, D)),
                            ("self_attn.o_proj", (D, HD)),
                            ("mlp.gate_proj", (I, D)),
                            ("mlp.up_proj", (I, D)),
                            ("mlp.down_proj", (D, I))):
            gpt[p + name + ".weight"] = 0.05 * rng.standard_normal(shape)
        for name in ("input_layernorm", "post_attention_layernorm"):
            gpt[p + name + ".weight"] = 1 + 0.1 * rng.standard_normal(D)
    states["gpt/model"] = gpt
    for name, state in states.items():
        state = {k: np.ascontiguousarray(np.asarray(v).astype(dtype))
                 for k, v in state.items()}
        states[name] = state
        save_file(state, os.path.join(a, f"{name}.safetensors"))
    with open(os.path.join(a, "gpt", "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaModel"], "hidden_size": D,
                   "intermediate_size": I,
                   "num_attention_heads": g.num_attention_heads,
                   "num_hidden_layers": g.num_hidden_layers}, f)
    write_tokenizer(os.path.join(a, "tokenizer"), g.num_text_tokens)
    return states
