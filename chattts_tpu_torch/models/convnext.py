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


# ---------------------------------------------------------------------------
# Streaming (stateful) apply: O(new frames) a call, exact in steady state
#
# Every SAME-padded conv keeps a cache of its last (k - 1) * dilation INPUT
# frames.  Feeding F new frames and convolving [cache | x] with no padding
# emits exactly F output frames, at a stream offset of dilation * (k // 2)
# frames a conv (a layer's stream frame j is its full-decode frame j -
# cum_off).  Exactness at the stream's head needs one more rule: a layer's
# input frames whose FULL-decode index is negative are zeroed before the
# conv, because the full decode pads each layer's input with its own zeros
# where the upstream stream supplies its (nonzero) left-edge outputs.
# ``t0``, the stream index of the chunk's first frame, is a host integer
# here, so the mask is applied only while it can zero a frame.  The stream's
# end is flushed by the caller with a right-aligned full-window decode.
# ---------------------------------------------------------------------------


def conv_stream_init(batch: int, k: int, dilation: int, cin: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((batch, (k - 1) * dilation, cin), dtype=dtype,
                       device=device)


def _mask_head(ext: torch.Tensor, t0: int, m: int, cum_off: int
               ) -> torch.Tensor:
    """Zero ext frames whose full-decode index (stream - cum_off) is < 0.

    ext frame e sits at stream index t0 + e - m (m = cache length)."""
    first = t0 - m - cum_off  # full-decode index of ext frame 0
    if first >= 0:
        return ext
    e = torch.arange(ext.shape[1], device=ext.device)
    return torch.where((first + e >= 0)[None, :, None], ext, 0.0)


def conv1d_stream(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, dilation: int = 1,
                  groups: int = 1, t0: int | None = None, cum_off: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid conv over [cache | x]; returns (F new frames, new cache)."""
    F_new = x.shape[1]
    ext = torch.cat([cache, x], dim=1)
    if t0 is not None:
        ext = _mask_head(ext, t0, cache.shape[1], cum_off)
    y = conv1d(ext, w, b, dilation=dilation, groups=groups)
    return y, ext[:, F_new:]


def apply_block_stream(p: dict, x: torch.Tensor, cache: torch.Tensor, *,
                       kernel: int, dilation: int = 1, t0: int | None = None,
                       cum_off: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming ConvNeXt block: the residual taps the input stream at the
    conv's offset, so both terms sit at the same full-decode index."""
    dim = x.shape[-1]
    F_new = x.shape[1]
    pad = dilation * (kernel // 2)
    ext = torch.cat([cache, x], dim=1)  # (B, F + 2 * pad, C)
    if t0 is not None:
        ext = _mask_head(ext, t0, cache.shape[1], cum_off)
    y = conv1d(ext, p["dwconv"]["w"], p["dwconv"]["b"], dilation=dilation,
               groups=dim)  # valid: (B, F, C)
    y = layer_norm(y, p["norm"]["scale"], p["norm"]["bias"])
    y = gelu(y @ p["pw1"]["w"] + p["pw1"]["b"])
    y = y @ p["pw2"]["w"] + p["pw2"]["b"]
    if p.get("gamma") is not None:
        y = y * p["gamma"]
    return ext[:, pad:pad + F_new] + y, ext[:, F_new:]


def stack_stream_offset(cfg: ConvStackConfig) -> int:
    """Cumulative stream offset (frames) of apply_stack_stream's output."""
    return 1 + 1 + cfg.n_layer * cfg.dilation * (cfg.kernel // 2)


def stack_stream_init(batch: int, cfg: ConvStackConfig, dtype=torch.float32,
                      device=None) -> dict:
    return {
        "in0": conv_stream_init(batch, 3, 1, cfg.idim, dtype, device),
        "in1": conv_stream_init(batch, 3, 1, cfg.bn_dim, dtype, device),
        "blocks": [conv_stream_init(batch, cfg.kernel, cfg.dilation,
                                    cfg.hidden, dtype, device)
                   for _ in range(cfg.n_layer)],
    }


def apply_stack_stream(p: dict, x: torch.Tensor, state: dict,
                       cfg: ConvStackConfig, t0: int | None = None,
                       cum_off: int = 0) -> tuple[torch.Tensor, dict, int]:
    """(B, F, idim) new frames -> (B, F, odim) stream frames, the new
    state, and the cumulative offset downstream (chained stacks keep
    masking with it)."""
    bpad = cfg.dilation * (cfg.kernel // 2)
    y, c_in0 = conv1d_stream(x, state["in0"], p["conv_in0"]["w"],
                             p["conv_in0"]["b"], t0=t0, cum_off=cum_off)
    y = gelu(y)
    cum_off += 1
    y, c_in1 = conv1d_stream(y, state["in1"], p["conv_in1"]["w"],
                             p["conv_in1"]["b"], t0=t0, cum_off=cum_off)
    cum_off += 1
    new_blocks = []
    for bp, bc in zip(p["blocks"], state["blocks"]):
        y, nc = apply_block_stream(bp, y, bc, kernel=cfg.kernel,
                                   dilation=cfg.dilation, t0=t0,
                                   cum_off=cum_off)
        new_blocks.append(nc)
        cum_off += bpad
    y = conv1d(y, p["conv_out"]["w"], None)  # k 1: no state
    return y, {"in0": c_in0, "in1": c_in1, "blocks": new_blocks}, cum_off


def stack_torch_key_map(path: str, prefix: str, cfg: ConvStackConfig) -> dict:
    """Tree path -> (reference state-dict key, transform) for a stack.

    Transforms (``utils/io._transform``): 'C' = conv weight (out,in,k) ->
    (k,in,out); 'D' = depthwise (dim,1,k) -> (k,1,dim); 'T' = linear
    transpose; '' = as-is.
    """
    m = {
        f"{path}/conv_in0/w": (f"{prefix}conv_in.0.weight", "C"),
        f"{path}/conv_in0/b": (f"{prefix}conv_in.0.bias", ""),
        f"{path}/conv_in1/w": (f"{prefix}conv_in.2.weight", "C"),
        f"{path}/conv_in1/b": (f"{prefix}conv_in.2.bias", ""),
        f"{path}/conv_out/w": (f"{prefix}conv_out.weight", "C"),
    }
    for i in range(cfg.n_layer):
        bp = f"{prefix}decoder_block.{i}."
        m.update(
            {
                f"{path}/blocks/{i}/dwconv/w": (f"{bp}dwconv.weight", "D"),
                f"{path}/blocks/{i}/dwconv/b": (f"{bp}dwconv.bias", ""),
                f"{path}/blocks/{i}/norm/scale": (f"{bp}norm.weight", ""),
                f"{path}/blocks/{i}/norm/bias": (f"{bp}norm.bias", ""),
                f"{path}/blocks/{i}/pw1/w": (f"{bp}pwconv1.weight", "T"),
                f"{path}/blocks/{i}/pw1/b": (f"{bp}pwconv1.bias", ""),
                f"{path}/blocks/{i}/pw2/w": (f"{bp}pwconv2.weight", "T"),
                f"{path}/blocks/{i}/pw2/b": (f"{bp}pwconv2.bias", ""),
                f"{path}/blocks/{i}/gamma": (f"{bp}weight", ""),
            }
        )
    return m
