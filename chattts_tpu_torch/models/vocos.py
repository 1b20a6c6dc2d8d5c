"""Vocos vocoder (port of ``decode`` in ``chattts_tpu/models/vocos.py``).

mel -> ConvNeXt backbone -> (log-magnitude, phase) -> complex spectrum ->
inverse STFT -> 24 kHz waveform.  Channels-last (B, T, C).
"""

from __future__ import annotations

import math

import torch

from ..config import VocosConfig
from ..ops.stft import istft
from . import convnext


def init_params(gen: torch.Generator, cfg: VocosConfig) -> dict:
    out_dim = cfg.n_fft + 2
    embed_w = (torch.randn((7, cfg.input_channels, cfg.dim), generator=gen)
               / math.sqrt(7 * cfg.input_channels))
    blocks = [convnext.init_block(gen, cfg.dim, cfg.intermediate_dim, kernel=7,
                                  layer_scale=1.0 / cfg.num_layers)
              for _ in range(cfg.num_layers)]
    head_w = torch.randn((cfg.dim, out_dim), generator=gen) / math.sqrt(cfg.dim)
    return {
        "embed": {"w": embed_w, "b": torch.zeros(cfg.dim)},
        "norm": {"scale": torch.ones(cfg.dim), "bias": torch.zeros(cfg.dim)},
        "blocks": blocks,
        "final_norm": {"scale": torch.ones(cfg.dim),
                       "bias": torch.zeros(cfg.dim)},
        "head": {"w": head_w, "b": torch.zeros(out_dim)},
    }


def decode(params: dict, mel: torch.Tensor, cfg: VocosConfig) -> torch.Tensor:
    """mel (B, T, n_mels) -> waveform (B, (T - 1) * hop)."""
    x = convnext.conv1d(mel, params["embed"]["w"], params["embed"]["b"],
                        padding=3)
    x = convnext.layer_norm(x, params["norm"]["scale"], params["norm"]["bias"])
    for bp in params["blocks"]:
        x = convnext.apply_block(bp, x, kernel=7, dilation=1)
    x = convnext.layer_norm(x, params["final_norm"]["scale"],
                            params["final_norm"]["bias"])
    h = x @ params["head"]["w"] + params["head"]["b"]  # (B, T, n_fft + 2)
    nf = cfg.n_fft // 2 + 1
    mag = torch.clamp(torch.exp(h[..., :nf]), max=1e2)
    phase = h[..., nf:]
    spec = torch.polar(mag, phase).transpose(1, 2)  # (B, nf, T)
    return istft(spec, cfg.n_fft, cfg.hop_length)


def torch_key_map(cfg: VocosConfig) -> dict:
    """Tree paths -> vocos-package state-dict keys."""
    m = {
        "embed/w": ("backbone.embed.weight", "C"),
        "embed/b": ("backbone.embed.bias", ""),
        "norm/scale": ("backbone.norm.weight", ""),
        "norm/bias": ("backbone.norm.bias", ""),
        "final_norm/scale": ("backbone.final_layer_norm.weight", ""),
        "final_norm/bias": ("backbone.final_layer_norm.bias", ""),
        "head/w": ("head.out.weight", "T"),
        "head/b": ("head.out.bias", ""),
    }
    for i in range(cfg.num_layers):
        bp = f"backbone.convnext.{i}."
        m.update(
            {
                f"blocks/{i}/dwconv/w": (f"{bp}dwconv.weight", "D"),
                f"blocks/{i}/dwconv/b": (f"{bp}dwconv.bias", ""),
                f"blocks/{i}/norm/scale": (f"{bp}norm.weight", ""),
                f"blocks/{i}/norm/bias": (f"{bp}norm.bias", ""),
                f"blocks/{i}/pw1/w": (f"{bp}pwconv1.weight", "T"),
                f"blocks/{i}/pw1/b": (f"{bp}pwconv1.bias", ""),
                f"blocks/{i}/pw2/w": (f"{bp}pwconv2.weight", "T"),
                f"blocks/{i}/pw2/b": (f"{bp}pwconv2.bias", ""),
                f"blocks/{i}/gamma": (f"{bp}gamma", ""),
            }
        )
    return m
