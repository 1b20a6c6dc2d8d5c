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


def tree_items(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs of a tree of dicts, lists, tuples and
    NamedTuples (a train state, a batch), in ``jax.tree.leaves`` order:
    dict keys sorted, sequences and NamedTuple fields in order.  A path
    joins the keys, indices and field names with '/', as the JAX
    package's checkpoints do."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.rstrip("/"), tree)]
    return [kv for k, v in items for kv in tree_items(v, f"{prefix}{k}/")]


def tree_leaves(tree) -> list:
    """The leaves in :func:`tree_items` order."""
    return [leaf for _, leaf in tree_items(tree)]


def unflatten(template, leaves):
    """The inverse of :func:`tree_leaves`: a tree of ``template``'s
    structure holding ``leaves`` (an iterable, in that order)."""
    return _fill(template, iter(leaves))


def _fill(template, leaves):
    # a plain recursion, not a closure: a closure over ``leaves`` would be
    # a reference cycle, and an unfinished generator of leaves (holding
    # every tensor it zips) would outlive the call until the cyclic GC ran
    if isinstance(template, dict):
        filled = {k: _fill(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        out = [_fill(v, leaves) for v in template]
        return type(template)(*out) if hasattr(template, "_fields") else \
            type(template)(out)
    return next(leaves)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a tree (see :func:`tree_items`)."""
    return unflatten(tree, map(fn, tree_leaves(tree)))


def from_numpy(tree) -> dict:
    """A tree of numpy (or JAX) arrays -> the same tree of CPU tensors."""
    return map_tree(_leaf, tree)


def to_device(tree, device: torch.device):
    return map_tree(lambda t: _leaf(t).to(device), tree)
