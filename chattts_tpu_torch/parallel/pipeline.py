"""GPipe over ``pp`` ranks (port of ``chattts_tpu/parallel/pipeline.py``).

The transformer's layers are stacked into leading-axis-``L`` leaves
(:func:`stack_layers`) and split over a one-axis ``("pp",)`` mesh
(:func:`make_pp_mesh`): stage s, rank s of the mesh, holds layers [s L/pp,
(s + 1) L/pp).  The batch is cut into ``n_micro`` microbatches; stage s
runs microbatch m after stage s - 1 hands it over, so the stages overlap
(fill, steady state, drain: ``n_micro + pp - 1`` ticks, a bubble of
``(pp - 1) / (n_micro + pp - 1)``).  Each hand-off is a ``broadcast`` in the
two-rank group of the stages it joins.  As in the JAX package, the pp mesh
does not compose with (dp, sp, tp).

The JAX package differentiates its shard_map with one ``jax.grad``.  Here
the stages build different autograd graphs, so one graph across the
hand-offs would leave autograd to choose each rank's order of backward
collectives, and two ranks could then wait on different ones or exchange
two microbatches' gradients of one shape.  :func:`make_pp_train_step`
drives the order itself: every microbatch forward, then the loss on the
last stage, then each microbatch's backward in reverse order, each stage
receiving its output's gradient from the next stage and sending its
input's to the previous one.

Where the JAX package runs the embedding, the final norm and the heads
replicated, here the embedding runs on stage 0 (per microbatch) and the
final norm, heads and loss on the last stage, whose loss every rank then
receives.  Every rank holds those leaves whole and updates them alike: the
gradients of the embedding tables (stage 0's) and of the heads and the norm
(the last stage's) are summed over pp, and the clip's global norm sums each
stage's own layers over pp and counts the whole leaves once.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import train
from ..config import GPTConfig
from ..models import embed as embed_mod
from ..models import llama
from ..weights import (map_tree, resolve_device, to_device, tree_leaves,
                       unflatten)
from . import comm

# the dtype of the layer stack's activations, as in ``llama.prefill``
DTYPE = torch.bfloat16


def stack_layers(layers: list) -> dict:
    """A list of per-layer trees -> one tree of (L, ...) stacked leaves."""
    return unflatten(layers[0], [torch.stack(xs) for xs in
                                 zip(*map(tree_leaves, layers))])


def unstack_layers(stacked: dict, n_layers: int) -> list:
    """The inverse of :func:`stack_layers`."""
    return [map_tree(lambda x: x[i], stacked) for i in range(n_layers)]


class PPMesh:
    """Ranks laid out along one ``pp`` axis: ``coords["pp"]`` is this
    rank's stage (None off the mesh), ``group`` the whole line's process
    group and ``hops[s]`` the two-rank group of stages s and s + 1 (None
    without a process group: one stage)."""

    def __init__(self, ranks: np.ndarray, rank: Optional[int], group,
                 hops: list):
        self.ranks = ranks
        self.shape = {"pp": int(ranks.size)}
        self.coords = None
        if rank is not None and (ranks == rank).any():
            self.coords = {"pp": int(np.argwhere(ranks == rank)[0, 0])}
        self.group, self.hops = group, hops

    def __repr__(self) -> str:
        return f"PPMesh(pp={self.shape['pp']}, coords={self.coords})"

    def send(self, t: torch.Tensor) -> None:
        """``t`` to the next stage."""
        s = self.coords["pp"]
        comm.broadcast(t.contiguous(), int(self.ranks[s]), self.hops[s])

    def recv(self, shape, dtype, device) -> torch.Tensor:
        """The previous stage's :meth:`send`."""
        s = self.coords["pp"]
        out = torch.empty(shape, dtype=dtype, device=device)
        return comm.broadcast(out, int(self.ranks[s - 1]), self.hops[s - 1])

    def send_back(self, t: torch.Tensor) -> None:
        """``t`` to the previous stage."""
        s = self.coords["pp"]
        comm.broadcast(t.contiguous(), int(self.ranks[s]), self.hops[s - 1])

    def recv_back(self, shape, dtype, device) -> torch.Tensor:
        """The next stage's :meth:`send_back`."""
        s = self.coords["pp"]
        out = torch.empty(shape, dtype=dtype, device=device)
        return comm.broadcast(out, int(self.ranks[s + 1]), self.hops[s])

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last stage's ``t`` on every stage, in place."""
        if self.group is None:
            return t
        return comm.broadcast(t, int(self.ranks[-1]), self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the stages, in place."""
        if self.group is None:
            return t
        return comm.all_reduce(t, self.group)


def make_pp_mesh(pp: int) -> PPMesh:
    """A ``("pp",)`` mesh of ``pp`` stages over the first ``pp`` ranks of
    the process group (one rank without a group).  With a process group
    every rank of the group calls this with the same ``pp`` (it creates
    the line's group and one group a hand-off)."""
    if pp < 1:
        raise ValueError(f"pp={pp}")
    ranks = list(range(pp))
    arr = np.asarray(ranks)
    if not dist.is_initialized():
        if pp != 1:
            raise ValueError(f"pp={pp} needs a process group")
        return PPMesh(arr, 0, None, [])
    group = dist.new_group(ranks)
    hops = [dist.new_group(ranks[s:s + 2]) for s in range(pp - 1)]
    return PPMesh(arr, dist.get_rank(), group, hops)


def pp_params(gpt: dict, mesh: PPMesh) -> dict:
    """The stage's ``{"stacked", "norm"}`` tree from a whole ``gpt`` tree:
    its L/pp layers stacked, the final norm whole."""
    L = len(gpt["layers"])
    n, s = L // _check_layers(L, mesh), mesh.coords["pp"]
    return {"stacked": stack_layers(gpt["layers"][s * n:(s + 1) * n]),
            "norm": gpt["norm"]}


def _check_layers(n_layers: int, mesh: PPMesh) -> int:
    """pp, once it divides ``n_layers``."""
    pp = mesh.shape["pp"]
    if n_layers % pp:
        raise ValueError(f"layers {n_layers} not divisible by pp={pp}")
    return pp


def _stage(stacked: dict, x, bias, cos, sin, cfg: GPTConfig):
    """The stage's layers over ``x``."""
    for i in range(tree_leaves(stacked)[0].shape[0]):
        lp = map_tree(lambda t: t[i], stacked)
        x, _, _ = llama.prefill_block(lp, x, bias, cos, sin, cfg, DTYPE)
    return x


def _micro_inputs(cfg: GPTConfig, attn_mask, positions, n_micro: int):
    """Per microbatch (rows, bias, cos, sin); the O(T^2) bias is built for
    one microbatch at a time."""
    B = attn_mask.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    mb = B // n_micro
    cos_t, sin_t = llama.rope_tables_torch(cfg, attn_mask.device)
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        yield (rows, llama.prefill_bias(attn_mask[rows]),
               cos_t[positions[rows]], sin_t[positions[rows]])


def _forward(stacked, first_input, micro, mesh: PPMesh, cfg,
             shape) -> List[tuple]:
    """GPipe's forward on this stage: for each microbatch, its input
    (``first_input(rows)`` on stage 0, the previous stage's output
    elsewhere, a leaf that takes a gradient), the stage's layers, the
    output sent on.  Returns [(input, output)] by microbatch."""
    s, last = mesh.coords["pp"], mesh.shape["pp"] - 1
    out = []
    for rows, bias, cos, sin in micro:
        if s == 0:
            x = first_input(rows)
        else:
            x = mesh.recv(shape, DTYPE, bias.device)
            x.requires_grad_(torch.is_grad_enabled())
        y = _stage(stacked, x, bias, cos, sin, cfg)
        if s < last:
            mesh.send(y.detach())
        out.append((x, y))
    return out


def make_pp_forward(cfg: GPTConfig, mesh: PPMesh, n_micro: int):
    """``fwd(stacked_layers, emb, attn_mask, positions) -> hidden``: the
    residual stream after every layer (before the final norm), as
    ``llama.prefill``'s layer stack gives it, (B, T, D) in :data:`DTYPE` on
    every stage.  ``stacked_layers`` is the stage's L/pp layers
    (:func:`pp_params`); ``emb`` (B, T, D) is read on stage 0.  Forward
    only (no gradient); :func:`make_pp_train_step` drives the backward.
    Raises ValueError unless pp divides the layers and ``n_micro`` the
    batch."""
    pp = _check_layers(cfg.num_hidden_layers, mesh)

    @torch.no_grad()
    def fwd(stacked_layers, emb, attn_mask, positions):
        B, T, D = emb.shape
        micro = _micro_inputs(cfg, attn_mask, positions, n_micro)
        shape = (B // n_micro, T, D)
        outs = _forward(stacked_layers, lambda rows: emb[rows].to(DTYPE),
                        micro, mesh, cfg, shape)
        if mesh.coords["pp"] == pp - 1:
            hidden = torch.cat([y for _, y in outs])
        else:
            hidden = torch.empty((B, T, D), dtype=DTYPE, device=emb.device)
        return mesh.from_last(hidden)

    return fwd


def pp_loss_fn(stacked_layers, norm, embed_params, batch, cfg: GPTConfig,
               fwd) -> torch.Tensor:
    """The objective of ``train.loss_fn`` with the layer stack pipelined
    (``fwd`` from :func:`make_pp_forward`); its value on every stage."""
    emb = embed_mod.embed_prompt(embed_params, batch.ids, batch.text_mask)
    x = fwd(stacked_layers, emb, batch.attn_mask,
            train.rope_positions(batch.attn_mask))
    hidden = llama.rms_norm(x, norm, cfg.rms_norm_eps).to(torch.float32)
    return train.loss_from_hidden(embed_params, hidden, batch)


def init_pp_state(gen: torch.Generator, cfg: GPTConfig, optimizer,
                  mesh: PPMesh, device=None):
    """``train.init_train_state``'s draws (``gen``, on the CPU, the whole
    model in its order) with ``gpt`` as the stage's ``{"stacked", "norm"}``
    (:func:`pp_params`) and ``embed`` whole, on ``device`` (CUDA unless the
    caller asks for the CPU); the optimizer's state made from them."""
    dev = resolve_device(device)
    gpt = llama.init_params(gen, cfg)
    emb = to_device(embed_mod.init_params(gen, cfg), dev)
    gpt_pp = to_device(pp_params(gpt, mesh), dev)
    return train.TrainState(gpt_pp, emb, optimizer.init((gpt_pp, emb)),
                            torch.zeros((), dtype=torch.int64, device=dev))


def _share(grads, mesh: PPMesh):
    """The gradients of the leaves every stage holds whole, summed over
    pp (a stage where a leaf takes no part holds zeros)."""
    return train._sum_leaves(grads, mesh.all_reduce)


def make_pp_train_step(cfg: GPTConfig, optimizer, mesh: PPMesh,
                       n_micro: int):
    """The pipelined counterpart of ``train.make_train_step``:
    ``step(state, batch) -> (state, {"loss"})`` with ``state.gpt`` the
    stage's ``{"stacked", "norm"}`` (:func:`init_pp_state`) and the batch
    whole on every stage.  Each microbatch's gradients are added in f32
    and rounded once to the leaf's dtype.  The loss is the whole batch's,
    on every stage; the step returns a new state, nothing in place."""
    _check_layers(cfg.num_hidden_layers, mesh)

    def train_step(state, batch):
        s, pp = mesh.coords["pp"], mesh.shape["pp"]
        first, last = s == 0, s == pp - 1
        stacked, norm, embed = map_tree(
            lambda t: t.detach().requires_grad_(True),
            (state.gpt["stacked"], state.gpt["norm"], state.embed))
        B, T = batch.attn_mask.shape
        micro = _micro_inputs(cfg, batch.attn_mask,
                              train.rope_positions(batch.attn_mask), n_micro)
        shape = (B // n_micro, T, cfg.hidden_size)

        def embed_rows(rows):
            return embed_mod.embed_prompt(embed, batch.ids[rows],
                                          batch.text_mask[rows]).to(DTYPE)

        outs = _forward(stacked, embed_rows, micro, mesh, cfg, shape)

        # the stage's layers, the embedding tables (stage 0) and the heads
        # (the last stage), their gradients added in f32
        own = tree_leaves((stacked, embed))
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for t in own]
        norm_g = torch.zeros_like(norm)
        loss = torch.zeros((), dtype=torch.float32, device=norm.device)
        if last:
            h_in = torch.cat([y.detach() for _, y in outs]).requires_grad_()
            hidden = llama.rms_norm(h_in, norm, cfg.rms_norm_eps).to(
                torch.float32)
            loss = train.loss_from_hidden(embed, hidden, batch)
            g_out, norm_g, *heads = torch.autograd.grad(
                loss, [h_in, norm] + tree_leaves(embed), allow_unused=True)
            g_out = g_out.split(shape[0])
            for a, g in zip(acc[len(own) - len(heads):], heads):
                if g is not None:
                    a += g
        for m in reversed(range(n_micro)):
            x, y = outs[m]
            g = g_out[m] if last else mesh.recv_back(shape, DTYPE, y.device)
            got = torch.autograd.grad(y, own + ([] if first else [x]), g,
                                      allow_unused=True)
            for a, gl in zip(acc, got):
                if gl is not None:
                    a += gl
            if not first:
                mesh.send_back(got[-1])
        del outs
        with torch.no_grad():
            stacked_g, embed_g = unflatten((stacked, embed), [
                a.to(t.dtype) for a, t in zip(acc, own)])
            norm_g, embed_g = _share((norm_g, embed_g), mesh)
            loss = mesh.from_last(loss.detach().clone())
            grads = ({"norm": norm_g, "stacked": stacked_g}, embed_g)
            split = tree_leaves(({"norm": False,
                                  "stacked": map_tree(lambda _: pp > 1,
                                                      stacked_g)},
                                 map_tree(lambda _: False, embed_g)))
            g_norm = train.global_norm(grads, split, mesh.all_reduce)
            old = (state.gpt, state.embed)
            updates, opt_state = optimizer.update(grads, state.opt_state, old,
                                                  g_norm)
            gpt, emb = train.apply_updates(old, updates)
        return (train.TrainState(gpt, emb, opt_state, state.step + 1),
                {"loss": loss})

    return train_step
