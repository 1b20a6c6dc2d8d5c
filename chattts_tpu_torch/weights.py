"""Parameter trees as torch tensors: the bridge from numpy, and the device.

The port keeps the JAX package's tree layouts (``models/*``), so bridging a
JAX tree is a leaf-by-leaf conversion: hand each leaf over as a numpy array
(``np.asarray`` of a JAX array) and :func:`from_numpy` returns the same tree
of tensors with the same dtypes.  bf16 numpy arrays (the ``bfloat16`` dtype
numpy extensions provide) are read by their bits, so no such extension is
imported here.  The kernel's own layout is made from the tree by
``ops.decode_step.pack_weights``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def _leaf(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def from_numpy(tree) -> dict:
    """A tree of numpy (or JAX) arrays -> the same tree of CPU tensors."""
    return map_tree(_leaf, tree)


def to_device(tree, device: torch.device):
    return map_tree(lambda t: _leaf(t).to(device), tree)
