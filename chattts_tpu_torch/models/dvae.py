"""Hidden-state -> mel decoder (port of the ``decode_from_hidden`` part of
``chattts_tpu/models/dvae.py``).

The no-VQ "Decoder" instance: 2-group channel-to-time interleave -> ConvNeXt
stack -> k3 out conv -> per-mel-bin ``coef``.  Channels-last throughout.
The GFSQ decode from code indices and the audio encoder belong to the voice
clone slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import codecs
from ..config import DecoderConfig
from . import convnext


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


def decode_from_hidden(params: dict, hidden: torch.Tensor, cfg: DecoderConfig
                       ) -> torch.Tensor:
    """Transformer hiddens (B, T, D) -> mel (B, 2T, n_mels)."""
    y = interleave_groups(hidden)
    y = convnext.apply_stack(params["decoder"], y, cfg.stack)
    mel = convnext.conv1d(y, params["out_conv"]["w"], None, padding=1)
    return mel * params["coef"][None, None, :]


def coef_string(params: dict) -> str:
    """Portable b14 form of the mel coefficients."""
    return codecs.encode_coef(params["coef"].cpu().numpy().astype(np.float32))
