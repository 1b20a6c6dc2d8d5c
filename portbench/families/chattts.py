"""ChatTTS (2noise/ChatTTS): its Llama decoder, the DVAE mel decoder and
Vocos, as the program's ``Chat`` runs them at two weight and cache tiers.

The weight trees have the layouts the program's ``Chat.load_params``
takes (the JAX package's, which the program keeps): the decoder's
matrices in bf16, (in, out); norms, embeddings, heads and the audio back
end in float32.  Norm scales, biases and layer scales are drawn too, so
that the comparison with the reference covers them.  The reference is
``reference/model.py``.
"""

from __future__ import annotations

import math
import types
from typing import List, Tuple

from harness.weights import Spec
from reference import model

LOWER_TIER = {0: 8, 8: 4}   # a weight tier -> the next below it


def _conv_stack(path, idim, odim, hidden, n_layer, bn_dim, kernel) -> List[Spec]:
    out = [(path + ("conv_in0", "w"), (3, idim, bn_dim), 0.0,
            1 / math.sqrt(3 * idim)),
           (path + ("conv_in0", "b"), (bn_dim,), 0.0, 0.02),
           (path + ("conv_in1", "w"), (3, bn_dim, hidden), 0.0,
            1 / math.sqrt(3 * bn_dim)),
           (path + ("conv_in1", "b"), (hidden,), 0.0, 0.02)]
    for i in range(n_layer):
        out += _block(path + ("blocks", i), hidden, 4 * hidden, kernel)
    out.append((path + ("conv_out", "w"), (1, hidden, odim), 0.0,
                1 / math.sqrt(hidden)))
    return out


def _block(path, dim, inter, kernel) -> List[Spec]:
    return [(path + ("dwconv", "w"), (kernel, 1, dim), 0.0,
             1 / math.sqrt(kernel)),
            (path + ("dwconv", "b"), (dim,), 0.0, 0.02),
            (path + ("norm", "scale"), (dim,), 1.0, 0.1),
            (path + ("norm", "bias"), (dim,), 0.0, 0.02),
            (path + ("pw1", "w"), (dim, inter), 0.0, 1 / math.sqrt(dim)),
            (path + ("pw1", "b"), (inter,), 0.0, 0.02),
            (path + ("pw2", "w"), (inter, dim), 0.0, 1 / math.sqrt(inter)),
            (path + ("pw2", "b"), (dim,), 0.0, 0.02),
            (path + ("gamma",), (dim,), 0.1, 0.02)]


def specs(cfg: dict) -> Tuple[List[Spec], List[Spec]]:
    """(bf16 leaves, float32 leaves) of a configuration: the
    {"gpt", "embed", "decoder", "vocos"} trees."""
    g = cfg["gpt"]
    D, I, H = g["hidden_size"], g["intermediate_size"], g["num_attention_heads"]
    Dh = D // H
    bf16, f32 = [], []
    for li in range(g["num_hidden_layers"]):
        p = ("gpt", "layers", li)
        bf16 += [(p + ("attn", "wqkv"), (D, 3, H, Dh), 0.0, 0.02),
                 (p + ("attn", "wo"), (H * Dh, D), 0.0, 0.02),
                 (p + ("mlp", "wgu"), (D, 2, I), 0.0, 0.02),
                 (p + ("mlp", "down"), (I, D), 0.0, 0.02)]
        f32 += [(p + ("ln1",), (D,), 1.0, 0.1), (p + ("ln2",), (D,), 1.0, 0.1)]
    f32.append((("gpt", "norm"), (D,), 1.0, 0.1))
    Vt, Va, Q = g["num_text_tokens"], g["num_audio_tokens"], g["num_vq"]
    f32 += [(("embed", "emb_text"), (Vt, D), 0.0, 0.02),
            (("embed", "emb_code"), (Q, Va, D), 0.0, 0.02),
            (("embed", "head_text"), (D, Vt), 0.0, 1 / math.sqrt(D)),
            (("embed", "head_code"), (Q, D, Va), 0.0, 1 / math.sqrt(D))]
    d = cfg["decoder"]
    s = d["stack"]
    f32.append((("decoder", "coef"), (d["n_mels"],), 0.5, 0.1))
    f32 += _conv_stack(("decoder", "decoder"), s["idim"], s["odim"],
                       s["hidden"], s["n_layer"], s["bn_dim"], s["kernel"])
    f32.append((("decoder", "out_conv", "w"), (3, s["odim"], d["n_mels"]),
                0.0, 1 / math.sqrt(3 * s["odim"])))
    v = cfg["vocos"]
    f32 += [(("vocos", "embed", "w"), (7, v["input_channels"], v["dim"]), 0.0,
             1 / math.sqrt(7 * v["input_channels"])),
            (("vocos", "embed", "b"), (v["dim"],), 0.0, 0.02),
            (("vocos", "norm", "scale"), (v["dim"],), 1.0, 0.1),
            (("vocos", "norm", "bias"), (v["dim"],), 0.0, 0.02)]
    for i in range(v["num_layers"]):
        f32 += _block(("vocos", "blocks", i), v["dim"], v["intermediate_dim"],
                      7)
    f32 += [(("vocos", "final_norm", "scale"), (v["dim"],), 1.0, 0.1),
            (("vocos", "final_norm", "bias"), (v["dim"],), 0.0, 0.02),
            (("vocos", "head", "w"), (v["dim"], v["n_fft"] + 2), 0.0,
             1 / math.sqrt(v["dim"])),
            (("vocos", "head", "b"), (v["n_fft"] + 2,), 0.0, 0.02)]
    return bf16, f32


def port_config(cfg: dict):
    """The program's ``Config`` of a configuration file."""
    from chattts_tpu_torch.config import (Config, ConvStackConfig,
                                          DecoderConfig, GPTConfig, MelConfig,
                                          VocosConfig)

    v = dict(cfg["vocos"])
    mel = MelConfig(sample_rate=v.pop("sample_rate"), n_fft=v["n_fft"],
                    hop_length=v["hop_length"], n_mels=v["input_channels"])
    d = cfg["decoder"]
    return Config(
        gpt=GPTConfig(**cfg["gpt"]),
        decoder=DecoderConfig(stack=ConvStackConfig(**d["stack"]),
                              n_mels=d["n_mels"]),
        vocos=VocosConfig(mel=mel, **v)).with_runtime(**cfg["runtime"])


def load_chat(cfg: dict, weights: dict, device, use_engine: bool = False):
    """A loaded ``Chat`` on the benchmark's weights, at the configuration's
    weight and cache tiers."""
    from chattts_tpu_torch.core import Chat

    chat = Chat(config=port_config(cfg))
    chat.load_params(gpt=weights["gpt"], embed=weights["embed"],
                     decoder=weights["decoder"], vocos=weights["vocos"],
                     device=device, use_engine=use_engine,
                     weight_bits=cfg["weight_bits"], kv_bits=cfg["kv_bits"])
    return chat


def lower_tier(weight_bits: int) -> int:
    """The weight tier one below ``weight_bits``: int8 for bf16 (0), int4
    for int8."""
    return LOWER_TIER[weight_bits]


def sizes(cfg: dict) -> dict:
    """The speaker vector's length (the decoder's width), a codebook's size
    and the text vocabulary."""
    g = cfg["gpt"]
    return {"speaker_dim": g["hidden_size"],
            "num_audio_tokens": g["num_audio_tokens"],
            "num_text_tokens": g["num_text_tokens"]}


def request_reference(weights: dict, cfg: dict, *args, **kwargs) -> dict:
    """``reference/model.py``'s ``request_reference``, handed the whole
    configuration: it reads the groups below, and the mel decoder pads to a
    quarter of the program's decode bucket."""
    ref_cfg = {"gpt": cfg["gpt"], "decoder": cfg["decoder"],
               "vocos": cfg["vocos"],
               "decode_pad": cfg["runtime"]["decode_bucket"] // 4}
    return model.request_reference(weights, ref_cfg, *args, **kwargs)


reference = types.SimpleNamespace(
    request_reference=request_reference, prompt_ids=model.prompt_ids,
    penalized=model.penalized, gaps=model.gaps,
    relative_error=model.relative_error, tf32_off=model.tf32_off)
