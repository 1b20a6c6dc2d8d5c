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
