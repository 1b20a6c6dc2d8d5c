"""Grouped-residual finite scalar quantization (port of
``chattts_tpu/models/gfsq.py``).

The feature dim is split into ``G`` groups; each group runs ``R`` residual
FSQ stages.  One stage projects the group's features to ``len(levels)``
scalars, bounds them with tanh, rounds each to one of ``levels[k]``
uniformly spaced values and packs the digits into one code index; stage
``r`` works on the remaining error at scale ``(levels - 1) ** -r``.  With
levels (5, 5, 5, 5), G 2 and R 2 that gives the 4 codebooks of 625 codes
the decoder samples.  Everything is float32, as in the reference: the index
is an f32 sum of digit times basis cast to int32, and rounding is half to
even (``torch.round`` and ``jnp.round`` both).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import GFSQConfig

_BOUND_EPS = 1e-3  # FSQ tanh bound epsilon


def _levels_np(cfg: GFSQConfig) -> np.ndarray:
    return np.asarray(cfg.levels, dtype=np.int32)


def _basis_np(cfg: GFSQConfig) -> np.ndarray:
    lv = _levels_np(cfg)
    return np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int32)


def init_params(gen: torch.Generator, cfg: GFSQConfig) -> dict:
    """Random per-group projections (the JAX package's scales, drawn from
    ``gen``)."""
    dpg = cfg.dim // cfg.groups
    cd = len(cfg.levels)
    groups = []
    for _ in range(cfg.groups):
        w_in = torch.randn((dpg, cd), generator=gen) / math.sqrt(dpg)
        w_out = torch.randn((cd, dpg), generator=gen) / math.sqrt(cd)
        groups.append({"project_in": {"w": w_in, "b": torch.zeros(cd)},
                       "project_out": {"w": w_out, "b": torch.zeros(dpg)}})
    return {"groups": groups}


def codebook(cfg: GFSQConfig) -> torch.Tensor:
    """Implicit FSQ codebook (codebook_size, len(levels)) f32: entry ``i``
    holds ``(digits(i) - half_width) / half_width`` per level."""
    lv = _levels_np(cfg)
    half = lv // 2
    idx = np.arange(int(np.prod(lv)))[:, None]
    digits = (idx // _basis_np(cfg)[None, :]) % lv[None, :]
    return torch.from_numpy(((digits - half[None, :]) / half[None, :])
                            .astype(np.float32))


def _scales(cfg: GFSQConfig) -> np.ndarray:
    """Residual-stage scales (R, len(levels)): stage r uses (levels-1)**-r."""
    lv = _levels_np(cfg).astype(np.float64)
    return np.stack([(lv - 1.0) ** (-float(r))
                     for r in range(cfg.residuals)]).astype(np.float32)


def embed(params: dict, indices: torch.Tensor, cfg: GFSQConfig
          ) -> torch.Tensor:
    """Code indices (B, T, G*R), laid out [g0r0, g0r1, ..., g1r0, ...] ->
    features (B, T, dim) f32."""
    dev = params["groups"][0]["project_out"]["w"].device
    cb = codebook(cfg).to(dev)
    scales = torch.from_numpy(_scales(cfg)).to(dev)
    indices = indices.to(device=dev, dtype=torch.long)
    outs = []
    for g in range(cfg.groups):
        gp = params["groups"][g]
        acc = None
        for r in range(cfg.residuals):
            codes = cb[indices[..., g * cfg.residuals + r]] * scales[r]
            acc = codes if acc is None else acc + codes
        outs.append(acc @ gp["project_out"]["w"] + gp["project_out"]["b"])
    return torch.cat(outs, dim=-1)


def _fsq_quantize(z: torch.Tensor, cfg: GFSQConfig):
    """One FSQ stage, a bounded round: z (..., cd) f32 -> (codes_norm in
    [-1, 1], index int32)."""
    dev = z.device
    lv_i = _levels_np(cfg)
    lv = torch.from_numpy(lv_i.astype(np.float32)).to(dev)
    half_l = (lv - 1.0) * (1.0 + _BOUND_EPS) / 2.0
    offset = torch.from_numpy(np.where(lv_i % 2 == 0, 0.5, 0.0)
                              .astype(np.float32)).to(dev)
    shift = torch.atanh(offset / half_l)
    bounded = torch.tanh(z + shift) * half_l - offset
    half_width = torch.from_numpy((lv_i // 2).astype(np.float32)).to(dev)
    quantized = torch.round(bounded) / half_width
    digits = quantized * half_width + half_width
    basis = torch.from_numpy(_basis_np(cfg).astype(np.float32)).to(dev)
    index = torch.sum(digits * basis, dim=-1).to(torch.int32)
    return quantized, index


def quantize(params: dict, x: torch.Tensor, cfg: GFSQConfig) -> torch.Tensor:
    """Features (B, T, dim) f32 -> code indices (B, T, G*R) int32, laid out
    as :func:`embed` takes them."""
    dpg = cfg.dim // cfg.groups
    scales = torch.from_numpy(_scales(cfg)).to(x.device)
    inds = []
    for g in range(cfg.groups):
        gp = params["groups"][g]
        xg = x[..., g * dpg:(g + 1) * dpg]
        residual = (xg @ gp["project_in"]["w"]
                    + gp["project_in"]["b"]).to(torch.float32)
        for r in range(cfg.residuals):
            codes_norm, index = _fsq_quantize(residual / scales[r], cfg)
            residual = residual - codes_norm * scales[r]
            inds.append(index)
    return torch.stack(inds, dim=-1)
