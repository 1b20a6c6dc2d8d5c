"""The device mesh and the sharding layouts (port of
``chattts_tpu/parallel/mesh.py``).

A mesh lays the ranks of the process group out as (dp, sp, tp):

* ``dp`` (data parallel): the serving engine's slots split across ranks,
  each running its own slots' decode steps; a training batch's rows;
* ``sp`` (sequence parallel): a training batch's time axis: a rank holds
  T/sp query positions and gathers every rank's keys and values in each
  layer (``train.make_train_step(mesh=)``; serving meshes keep ``sp = 1``);
* ``tp`` (tensor parallel): attention heads and MLP columns split across
  ranks, whose partial sums meet in an all_reduce after ``wo`` and after
  ``down`` in every layer; in training also the heads' vocab columns.

The layouts are trees of placements that mirror the JAX package's
``PartitionSpec`` trees leaf for leaf: a leaf is one placement per mesh
axis, in (dp, sp, tp) order, :class:`Shard` (the tensor dimension that axis
splits) or :class:`Replicate`, as ``torch.distributed.tensor`` writes
placements.  Every rank holds the same full weights (made from one seed, or
loaded), so :func:`shard_params` slices its own shards without a
collective.  Where the JAX package lets XLA insert the collectives from
the specs, the port's modules call them (:class:`Mesh` methods, over
``parallel/comm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import GPTConfig
from . import comm

AXES = ("dp", "sp", "tp")


@dataclass(frozen=True)
class Shard:
    """The mesh axis splits tensor dimension ``dim`` into equal parts."""

    dim: int


@dataclass(frozen=True)
class Replicate:
    """Every rank along the mesh axis holds the whole tensor."""


def spec(*names: Optional[str]) -> tuple:
    """The placements, along (dp, sp, tp), of a ``PartitionSpec(*names)``
    that names the mesh axis (or None) of each tensor dimension."""
    return tuple(Shard(names.index(ax)) if ax in names else Replicate()
                 for ax in AXES)


def is_spec(leaf) -> bool:
    return (isinstance(leaf, tuple) and len(leaf) == len(AXES)
            and all(isinstance(p, (Shard, Replicate)) for p in leaf))


class Mesh:
    """Ranks laid out as (dp, sp, tp), with this process's coordinates and
    its process group along each axis.

    ``coords`` is None when this process is not a rank of the mesh (a mesh
    described without a process group, for :func:`shard_params` with
    explicit coordinates).  ``groups`` is None without a process group: the
    collectives are then the identity, which is right for a mesh of one
    rank."""

    def __init__(self, ranks: np.ndarray, rank: Optional[int],
                 groups: Optional[Dict[str, object]]):
        self.ranks = ranks
        self.shape = dict(zip(AXES, ranks.shape))
        self.rank = rank
        self.coords = None
        if rank is not None and (ranks == rank).any():
            at = np.argwhere(ranks == rank)[0]
            self.coords = {ax: int(i) for ax, i in zip(AXES, at)}
        self.groups = groups

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"tp={self.shape['tp']}, coords={self.coords})")

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over the ranks that share this rank's other
        coordinates; returns it."""
        if self.groups is None:
            return t
        return comm.all_reduce(t, self.groups[axis])

    def _alone(self, axis: str) -> bool:
        """True without a process group (a mesh of one rank along ``axis``,
        whose collectives are the identity); raises for more ranks."""
        if self.groups is not None:
            return False
        if self.shape[axis] != 1:
            raise RuntimeError(f"a mesh of {self.shape[axis]} ranks along "
                               f"{axis} without a process group has no "
                               f"collectives")
        return True

    def reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """A new tensor, ``t`` summed over ``axis``; differentiable
        (:func:`comm.reduce_sum`)."""
        if self._alone(axis):
            return t
        return comm.reduce_sum(t, self.groups[axis])

    def copy(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t``, whose gradient is summed over ``axis``
        (:func:`comm.copy_to`)."""
        if self._alone(axis):
            return t
        return comm.copy_to(t, self.groups[axis])

    def gather_cat(self, part: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """Every rank's ``part`` along ``axis`` concatenated along ``dim``
        in axis order; differentiable (:func:`comm.gather_cat`)."""
        if self._alone(axis):
            return part
        return comm.gather_cat(part, dim, self.coords[axis],
                               self.shape[axis], self.groups[axis])

    def gather(self, part: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *part.shape) along ``axis``: every rank's ``part`` in axis
        order (:func:`comm.gather_padded`)."""
        if self._alone(axis):
            return part[None].clone()
        return comm.gather_padded(part, self.coords[axis], self.shape[axis],
                                  self.groups[axis])


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (dp, sp, tp) mesh over ``ranks`` (default: every rank of the
    process group, or one rank without a group); ``dp`` defaults to what
    ``tp`` and ``sp`` leave.  Raises ValueError unless dp * sp * tp equals
    the rank count.  With a process group every rank of the group must
    call this with the same arguments: it creates one group for each line
    of each axis (of size 1 too, so a one-rank mesh still runs its
    collectives through the backend)."""
    grouped = dist.is_initialized()
    if ranks is None:
        ranks = range(dist.get_world_size() if grouped else 1)
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    if dp is None:
        dp = n // (tp * sp)
    if dp < 1 or dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp={dp * sp * tp} != device count {n}")
    arr = np.asarray(ranks).reshape(dp, sp, tp)
    if not grouped:
        return Mesh(arr, 0 if n == 1 else None, None)
    me = dist.get_rank()
    groups = {}
    for i, ax in enumerate(AXES):
        lines = np.moveaxis(arr, i, -1).reshape(-1, arr.shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[ax] = g
    return Mesh(arr, me, groups if me in ranks else None)


def gpt_param_specs(cfg: GPTConfig) -> dict:
    """Placements of the decoder's tree: heads of ``wqkv`` (D, 3, H, Dh)
    and rows of ``wo`` (H Dh, D), columns of ``wgu`` (D, 2, I) and rows of
    ``down`` (I, D) over tp; the norms replicated."""
    layer = {
        "attn": {"wqkv": spec(None, None, "tp", None),
                 "wo": spec("tp", None)},
        "mlp": {"wgu": spec(None, None, "tp"), "down": spec("tp", None)},
        "ln1": spec(None),
        "ln2": spec(None),
    }
    return {"layers": [layer] * cfg.num_hidden_layers, "norm": spec(None)}


def embed_param_specs(cfg: GPTConfig) -> dict:
    """Embedding tables replicated (gathered by token id), the heads' vocab
    columns over tp.  The serving engine keeps the heads whole (see
    ``engine/batching.py``)."""
    return {
        "emb_text": spec(None, None),
        "emb_code": spec(None, None, None),
        "head_text": spec(None, "tp"),
        "head_code": spec(None, None, "tp"),
    }


def train_batch_specs():
    """Placements of a ``train.TrainBatch``: rows over dp, the time axis
    over sp; a TrainBatch of placements, so :func:`shard_params` slices a
    batch with it."""
    from ..train import TrainBatch

    return TrainBatch(ids=spec("dp", "sp", None), attn_mask=spec("dp", "sp"),
                      text_mask=spec("dp", "sp"))


def state_specs(cfg: GPTConfig) -> dict:
    """The JAX Generator's decode state: batch over dp, the heads of each
    layer's (B, T, H, Dh) cache over tp."""
    leaf = spec("dp", None, "tp", None)
    L = cfg.num_hidden_layers
    return {
        "cache": {"k": tuple(leaf for _ in range(L)),
                  "v": tuple(leaf for _ in range(L))},
        "ids": spec("dp", None, None),
        "key_valid": spec("dp", None),
        "hidden": spec("dp", None),
        "cur": spec(),
        "pos_next": spec("dp"),
        "finish": spec("dp"),
        "end_idx": spec("dp"),
        "hiddens": spec("dp", None, None),
        "step": spec(),
        "rng": spec(),
    }


def map_specs(fn, tree, specs):
    """``fn(leaf, placements)`` over a tree and its spec tree (dicts, lists,
    tuples and NamedTuples, walked in parallel)."""
    if is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in tree}
    out = [map_specs(fn, t, s) for t, s in zip(tree, specs, strict=True)]
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def local_shape(shape: Sequence[int], placements: tuple, mesh: Mesh
                ) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape``; raises
    ValueError where an axis does not divide its dimension."""
    out = list(shape)
    for ax, p in zip(AXES, placements):
        if isinstance(p, Shard):
            n = mesh.shape[ax]
            if out[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does "
                                 f"not split over {ax}={n}")
            out[p.dim] //= n
    return tuple(out)


def shard_params(params, specs, mesh: Mesh,
                 coords: Union[None, Sequence[int], Dict[str, int]] = None):
    """The shards of a tree that the rank at ``coords`` ((dp, sp, tp), or
    a dict by axis; default this process's) holds: each leaf sliced along
    every dimension its placements shard, with no collective.  Replicated
    leaves are returned as they are."""
    if coords is None:
        coords = mesh.coords
        if coords is None:
            raise ValueError("this process is not a rank of the mesh: pass "
                             "coords")
    if not isinstance(coords, dict):
        coords = dict(zip(AXES, coords))

    def local(t, placements):
        shape = local_shape(t.shape, placements, mesh)
        for ax, p in zip(AXES, placements):
            if isinstance(p, Shard):
                size = shape[p.dim]
                t = t.narrow(p.dim, coords[ax] * size, size)
        return t.contiguous()

    return map_specs(local, params, specs)
