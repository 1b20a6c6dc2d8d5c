"""Parameter trees <-> one safetensors file (the params half of
``chattts_tpu/utils/checkpoint.py``; its training-state half comes with the
training slice).

Keys are the tree paths joined with '/', as in the JAX package, so the two
read each other's files.  bf16 leaves are widened to float32 on the way out
(numpy, and so the safetensors format here, has no bfloat16) and take the
template's dtype on the way in.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import io as io_utils


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix.rstrip("/")] = tree
        return out
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params(path: str, params: Any) -> None:
    """Tree -> one safetensors file with '/'-joined keys."""
    io_utils.save_safetensors(
        path, {k: _host(v) for k, v in _flatten(params).items()})


def load_params(path: str, template: Any) -> Any:
    """safetensors file -> the tree ``template`` (filled in place), each
    leaf a CPU tensor in the template leaf's dtype."""
    for key, arr in io_utils.load_safetensors(path).items():
        want = getattr(io_utils.get_path(template, key), "dtype", None)
        val = io_utils.to_tensor(arr)
        io_utils.set_path(template, key,
                          val if want is None else val.to(want))
    return template
