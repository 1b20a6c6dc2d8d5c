"""Checkpoints (port of ``chattts_tpu/utils/checkpoint.py``).

* :func:`save_params` / :func:`load_params`: a parameter tree <-> one
  safetensors file.  Keys are the tree paths joined with '/', as in the
  JAX package, so the two read each other's files.  bf16 leaves are
  widened to float32 on the way out (numpy, and so the safetensors format
  here, has no bfloat16) and take the template's dtype on the way in.
* :func:`save_train_state` / :func:`restore_train_state`: a whole
  ``train.TrainState`` (parameters, both moment trees, the optimizer's
  count, the step) as ``<ckpt_dir>/<step>/state.pt``, one ``torch.save``
  of its tensors by path, in their own dtypes.  The reference writes an
  orbax checkpoint; the two formats do not read each other.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from . import io as io_utils
from ..weights import tree_items, unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params(path: str, params: Any) -> None:
    """Tree -> one safetensors file with '/'-joined keys."""
    io_utils.save_safetensors(
        path, {k: _host(v) for k, v in tree_items(params)})


def load_params(path: str, template: Any) -> Any:
    """safetensors file -> the tree ``template`` (filled in place), each
    leaf a CPU tensor in the template leaf's dtype."""
    for key, arr in io_utils.load_safetensors(path).items():
        want = getattr(io_utils.get_path(template, key), "dtype", None)
        val = io_utils.to_tensor(arr)
        io_utils.set_path(template, key,
                          val if want is None else val.to(want))
    return template


STATE_FILE = "state.pt"


def save_train_state(ckpt_dir: str, state, step: int | None = None) -> str:
    """Write ``state`` (a ``train.TrainState``) to ``<ckpt_dir>/<step>/``
    (``step`` defaults to the state's own) and return that directory.
    Tensors are copied to the host first; values are kept bit for bit."""
    step = int(step if step is not None else state.step)
    path = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in tree_items(state)}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(flat, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_train_state(path: str, template):
    """A state saved by :func:`save_train_state`, in ``template``'s
    structure, dtypes and devices (``template`` is left as it was).  Raises
    when a leaf is missing, has another shape, or the file holds a tensor
    the template has no place for."""
    flat = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)
    leaves = []
    for key, want in tree_items(template):
        if key not in flat:
            raise KeyError(f"{key} is not in the checkpoint")
        val = flat.pop(key)
        if tuple(val.shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(val.shape)}, "
                             f"template {tuple(want.shape)}")
        leaves.append(val.to(device=want.device, dtype=want.dtype))
    if flat:
        raise KeyError(f"the template has no place for {sorted(flat)[:4]}")
    return unflatten(template, leaves)
