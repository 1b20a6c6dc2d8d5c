"""Random weights for a configuration, drawn on the device from the seed.

The leaves and their layout are the configuration's family's
(``families/<name>.py``, ``specs``: the bf16 leaves and the float32
ones).  Every family's are drawn the same way: in two calls of
``torch.randn`` on a generator of the device (one bf16 buffer, one float32
buffer), then scaled leaf by leaf in place: each leaf is a view of its
buffer.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import family

# (path, shape, mean, std) of each leaf; the paths name the tree's keys
Spec = Tuple[tuple, tuple, float, float]


def _listed(node):
    """Nested dicts -> the tree: a dict keyed 0..n-1 becomes a list."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listed(node[i]) for i in range(len(node))]
    return {k: _listed(v) for k, v in node.items()}


def draw(cfg: dict, seed: int, device) -> dict:
    """The family's trees on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    for dtype, group in zip((torch.bfloat16, torch.float32),
                            family.of(cfg).specs(cfg)):
        sizes = [math.prod(shape) for _, shape, _, _ in group]
        flat = torch.randn(sum(sizes), generator=gen, dtype=dtype,
                           device=device)
        for (path, shape, mean, std), part in zip(group,
                                                  flat.split(sizes)):
            leaf = part.view(shape)
            leaf.mul_(std)
            if mean:
                leaf.add_(mean)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return _listed(tree)
