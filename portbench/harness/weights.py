"""Random weights for a configuration, drawn on the device from the seed.

The trees have the layouts the program's ``Chat.load_params`` takes (the
JAX package's, which the program keeps): the decoder's matrices in bf16,
(in, out); norms, embeddings, heads and the audio back end in float32.
They are drawn in two calls of ``torch.randn`` on a generator of the
device (one bf16 buffer for the decoder's matrices, one float32 buffer for
the rest), then scaled leaf by leaf in place: each leaf is a view of its
buffer.  Norm scales, biases and layer scales are drawn too, so that the
comparison with the reference covers them.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

# (path, shape, mean, std) of each leaf; the paths name the tree's keys
Spec = Tuple[tuple, tuple, float, float]


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
    """(bf16 leaves, float32 leaves) of a configuration."""
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


def _listed(node):
    """Nested dicts -> the tree: a dict keyed 0..n-1 becomes a list."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listed(node[i]) for i in range(len(node))]
    return {k: _listed(v) for k, v in node.items()}


def draw(cfg: dict, seed: int, device) -> dict:
    """{"gpt", "embed", "decoder", "vocos"} trees on ``device`` from
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for dtype, group in zip((torch.bfloat16, torch.float32), specs(cfg)):
        sizes = [math.prod(shape) for _, shape, _, _ in group]
        flat = torch.randn(sum(sizes), generator=gen, dtype=dtype,
                           device=device)
        for (path, shape, mean, std), part in zip(group,
                                                  flat.split(sizes)):
            leaf = part.view(shape)
            leaf.mul_(std)
            if mean:
                leaf.add_(mean)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return _listed(tree)
