"""DVAE: speech codes <-> mel spectrogram (port of
``chattts_tpu/models/dvae.py``), in its three roles:

* decode from transformer hiddens (the no-VQ "Decoder" instance, the
  default audio path): 2-group channel-to-time interleave -> ConvNeXt stack
  -> k3 out conv -> per-mel-bin ``coef``;
* decode from code indices (``use_decoder=False``): GFSQ embed, then the
  same tail on the full DVAE's own decoder stack;
* encode audio to code indices (voice clone): log-mel / ``coef`` -> k3 conv
  and a stride-2 k4 conv, each with GELU -> ConvNeXt encoder -> GFSQ
  quantize.

Channels-last (B, T, C) throughout.  The convolutions are cuDNN's on the
card, as they are XLA's in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import codecs
from ..config import ConvStackConfig, DecoderConfig, DVAEConfig, MelConfig
from ..ops.stft import log_mel_spectrogram
from . import convnext, gfsq


def interleave_groups(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, 2T, C//2): timestep t expands to [first-half(t),
    second-half(t)]."""
    B, T, C = x.shape
    return torch.stack([x[..., : C // 2], x[..., C // 2:]], dim=2).reshape(
        B, 2 * T, C // 2)


def init_decoder_params(gen: torch.Generator, cfg: DecoderConfig,
                        coef: Optional[np.ndarray] = None) -> dict:
    stack = convnext.init_stack(gen, cfg.stack)
    out_w = (torch.randn((3, cfg.stack.odim, cfg.n_mels), generator=gen)
             / math.sqrt(3 * cfg.stack.odim))
    if coef is None:
        coef_t = torch.rand((cfg.n_mels,), generator=gen)
    else:
        coef_t = torch.as_tensor(np.asarray(coef, np.float32))
    return {"coef": coef_t, "decoder": stack, "out_conv": {"w": out_w}}


def init_dvae_params(gen: torch.Generator, cfg: DVAEConfig,
                     coef: Optional[np.ndarray] = None) -> dict:
    """The full DVAE: downsample convs, encoder, GFSQ and decoder."""
    dim = cfg.decoder.idim

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    params = {
        "downsample": {
            "conv0": {"w": randn(3, cfg.n_mels, dim)
                      / math.sqrt(3 * cfg.n_mels), "b": torch.zeros(dim)},
            "conv1": {"w": randn(4, dim, dim) / math.sqrt(4 * dim),
                      "b": torch.zeros(dim)},
        },
        "encoder": convnext.init_stack(gen, cfg.encoder),
        "decoder": convnext.init_stack(gen, cfg.decoder),
        "out_conv": {"w": randn(3, cfg.decoder.odim, cfg.n_mels)
                     / math.sqrt(3 * cfg.decoder.odim)},
        "vq": gfsq.init_params(gen, cfg.vq),
    }
    params["coef"] = (torch.rand((cfg.n_mels,), generator=gen) if coef is None
                      else torch.as_tensor(np.asarray(coef, np.float32)))
    return params


def _decode_stack(params: dict, feats: torch.Tensor,
                  stack_cfg: ConvStackConfig) -> torch.Tensor:
    """The tail both decoders share: interleave -> ConvNeXt -> out_conv ->
    x coef."""
    y = interleave_groups(feats)
    y = convnext.apply_stack(params["decoder"], y, stack_cfg)
    mel = convnext.conv1d(y, params["out_conv"]["w"], None, padding=1)
    return mel * params["coef"][None, None, :]


def decode_from_hidden(params: dict, hidden: torch.Tensor, cfg: DecoderConfig
                       ) -> torch.Tensor:
    """Transformer hiddens (B, T, D) -> mel (B, 2T, n_mels)."""
    return _decode_stack(params, hidden, cfg.stack)


def decode_from_indices(params: dict, indices: torch.Tensor, cfg: DVAEConfig
                        ) -> torch.Tensor:
    """Code indices (B, T, num_vq) -> mel (B, 2T, n_mels)."""
    return _decode_stack(params, gfsq.embed(params["vq"], indices, cfg.vq),
                         cfg.decoder)


def encode_audio(params: dict, audio: torch.Tensor, cfg: DVAEConfig,
                 mel_cfg: MelConfig) -> torch.Tensor:
    """Waveform (B, N) f32 -> code indices (B, T, num_vq) int32, T = (1 +
    N // hop) // 2 (the stride-2 conv with padding 1)."""
    mel = log_mel_spectrogram(audio, mel_cfg)                # (B, n_mels, F)
    x = mel.transpose(1, 2) / params["coef"][None, None, :]
    ds = params["downsample"]
    x = convnext.gelu(convnext.conv1d(x, ds["conv0"]["w"], ds["conv0"]["b"],
                                      padding=1))
    x = convnext.gelu(convnext.conv1d(x, ds["conv1"]["w"], ds["conv1"]["b"],
                                      stride=2, padding=1))
    x = convnext.apply_stack(params["encoder"], x, cfg.encoder)
    return gfsq.quantize(params["vq"], x, cfg.vq)


def decoder_stream_offset(cfg: DecoderConfig) -> int:
    """Mel-stream offset of decode_from_hidden_stream (stack + out_conv)."""
    return convnext.stack_stream_offset(cfg.stack) + 1


def decoder_stream_init(batch: int, cfg: DecoderConfig, device=None) -> dict:
    return {
        "stack": convnext.stack_stream_init(batch, cfg.stack, device=device),
        "out": convnext.conv_stream_init(batch, 3, 1, cfg.stack.odim,
                                         device=device),
    }


def decode_from_hidden_stream(params: dict, hidden: torch.Tensor,
                              state: dict, cfg: DecoderConfig,
                              t0: int | None = None
                              ) -> tuple[torch.Tensor, dict, int]:
    """Streaming hidden -> mel: (B, Fh, D) new positions -> (B, 2 * Fh,
    n_mels) mel stream frames, the new state and the cumulative offset
    downstream.

    ``t0`` is the MEL-frame stream index of this chunk's first frame (2x
    the hidden position); the interleave is frame-local, so it adds no
    state and no offset.  ``coef`` scales after ``out_conv``."""
    y = interleave_groups(hidden)  # (B, 2 * Fh, idim)
    y, stack_state, cum = convnext.apply_stack_stream(
        params["decoder"], y, state["stack"], cfg.stack, t0=t0)
    mel, out_c = convnext.conv1d_stream(
        y, state["out"], params["out_conv"]["w"], None, t0=t0, cum_off=cum)
    cum += 1
    mel = mel * params["coef"][None, None, :]
    return mel, {"stack": stack_state, "out": out_c}, cum


def coef_string(params: dict) -> str:
    """Portable b14 form of the mel coefficients."""
    return codecs.encode_coef(params["coef"].cpu().to(torch.float32).numpy())


# ---------------------------------------------------------------------------
# Checkpoint key maps (reference safetensors -> the trees above)
# ---------------------------------------------------------------------------


def decoder_torch_key_map(cfg: DecoderConfig) -> dict:
    m = convnext.stack_torch_key_map("decoder", "decoder.", cfg.stack)
    m["coef"] = ("coef", "SQUEEZE")  # stored (1, 100, 1)
    m["out_conv/w"] = ("out_conv.weight", "C")
    return m


def dvae_torch_key_map(cfg: DVAEConfig) -> dict:
    m = convnext.stack_torch_key_map("decoder", "decoder.", cfg.decoder)
    m.update(convnext.stack_torch_key_map("encoder", "encoder.", cfg.encoder))
    m["coef"] = ("coef", "SQUEEZE")
    m["out_conv/w"] = ("out_conv.weight", "C")
    m["downsample/conv0/w"] = ("downsample_conv.0.weight", "C")
    m["downsample/conv0/b"] = ("downsample_conv.0.bias", "")
    m["downsample/conv1/w"] = ("downsample_conv.2.weight", "C")
    m["downsample/conv1/b"] = ("downsample_conv.2.bias", "")
    m.update(
        {
            f"vq/{k}": v
            for k, v in gfsq.torch_key_map("vq_layer.quantizer.", cfg.vq).items()
        }
    )
    return m
