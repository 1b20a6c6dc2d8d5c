"""1-D ConvNeXt blocks (port of ``chattts_tpu/models/convnext.py``).

Activations stay channels-last (B, T, C) and conv weights keep the JAX
layout (k, Cin // groups, Cout) at the public functions, so both packages
take the same trees; :func:`conv1d` moves to torch's (B, C, T) layout for
the convolution itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ConvStackConfig


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           *, stride: int = 1, dilation: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """x: (B, T, Cin), w: (k, Cin // groups, Cout) -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch ``nn.GELU()`` default)."""
    return F.gelu(x, approximate="none")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen)


def init_block(gen: torch.Generator, dim: int, intermediate: int, kernel: int,
               layer_scale: float = 1e-6) -> dict:
    return {
        "dwconv": {"w": _randn(gen, kernel, 1, dim) / math.sqrt(kernel),
                   "b": torch.zeros(dim)},
        "norm": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
        "pw1": {"w": _randn(gen, dim, intermediate) / math.sqrt(dim),
                "b": torch.zeros(intermediate)},
        "pw2": {"w": _randn(gen, intermediate, dim) / math.sqrt(intermediate),
                "b": torch.zeros(dim)},
        "gamma": torch.full((dim,), layer_scale),
    }


def apply_block(p: dict, x: torch.Tensor, *, kernel: int, dilation: int = 1
                ) -> torch.Tensor:
    """One ConvNeXt-1d block on (B, T, C)."""
    dim = x.shape[-1]
    pad = dilation * (kernel // 2)
    y = conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], dilation=dilation,
               padding=pad, groups=dim)
    y = layer_norm(y, p["norm"]["scale"], p["norm"]["bias"])
    y = gelu(y @ p["pw1"]["w"] + p["pw1"]["b"])
    y = y @ p["pw2"]["w"] + p["pw2"]["b"]
    if p.get("gamma") is not None:
        y = y * p["gamma"]
    return x + y


def init_stack(gen: torch.Generator, cfg: ConvStackConfig) -> dict:
    """conv_in (k3 conv -> GELU -> k3 conv) -> blocks -> k1 conv_out."""
    return {
        "conv_in0": {"w": _randn(gen, 3, cfg.idim, cfg.bn_dim)
                     / math.sqrt(3 * cfg.idim),
                     "b": torch.zeros(cfg.bn_dim)},
        "conv_in1": {"w": _randn(gen, 3, cfg.bn_dim, cfg.hidden)
                     / math.sqrt(3 * cfg.bn_dim),
                     "b": torch.zeros(cfg.hidden)},
        "blocks": [init_block(gen, cfg.hidden, cfg.hidden * 4, cfg.kernel)
                   for _ in range(cfg.n_layer)],
        "conv_out": {"w": _randn(gen, 1, cfg.hidden, cfg.odim)
                     / math.sqrt(cfg.hidden)},
    }


def apply_stack(p: dict, x: torch.Tensor, cfg: ConvStackConfig
                ) -> torch.Tensor:
    """(B, T, idim) -> (B, T, odim)."""
    y = conv1d(x, p["conv_in0"]["w"], p["conv_in0"]["b"], padding=1)
    y = gelu(y)
    y = conv1d(y, p["conv_in1"]["w"], p["conv_in1"]["b"], padding=1)
    for bp in p["blocks"]:
        y = apply_block(bp, y, kernel=cfg.kernel, dilation=cfg.dilation)
    return conv1d(y, p["conv_out"]["w"], None)
