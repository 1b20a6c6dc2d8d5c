"""Rank functions of the port's sharded and pipelined training tests
(``tests/test_torch_train_mesh.py``), run in spawned processes of one
process group (``chattts_tpu_torch.parallel.comm.spawn``).  They import the
port only; inputs come as trees of CPU tensors, results go back as numpy
arrays."""

from __future__ import annotations

import contextlib

import torch

from chattts_tpu_torch import train
from chattts_tpu_torch.parallel import comm
from chattts_tpu_torch.parallel import mesh as mesh_mod
from chattts_tpu_torch.parallel import pipeline as pl
from chattts_tpu_torch.weights import tree_leaves

LR, WARMUP = 3e-3, 1

# faults planted in a rank's step, each of which the tests' limits reject
MESH_FAULTS = ("dp gradients not summed", "copy onto tp: backward left out",
               "sp gather: backward not summed")
PP_FAULTS = ("pp embedding gradient not shared",)


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` planted for the duration (or as it is)."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "dp gradients not summed":
        real = train._sum_over_data

        class OnlySp:  # the mesh as _sum_over_data sees it, dp left out
            def __init__(self, mesh):
                self.mesh = mesh

            def all_reduce(self, t, axis):
                return t if axis == "dp" else self.mesh.all_reduce(t, axis)

        patch(train, "_sum_over_data", lambda g, mesh: real(g, OnlySp(mesh)))
    elif fault == "copy onto tp: backward left out":
        patch(comm._CopyTo, "backward", staticmethod(lambda ctx, g: (g, None)))
    elif fault == "sp gather: backward not summed":
        patch(comm._GatherCat, "backward", staticmethod(
            lambda ctx, g: (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size),
                            None, None, None, None)))
    elif fault == "pp embedding gradient not shared":
        real = pl._share

        def share(grads, mesh):  # the tables keep the stage's own gradient
            norm, embed = real(grads, mesh)
            own = grads[1]
            return norm, dict(embed, emb_text=own["emb_text"],
                              emb_code=own["emb_code"])

        patch(pl, "_share", share)
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def _np(tree) -> list:
    return [t.detach().to(torch.float32).numpy() for t in tree_leaves(tree)]


def _mesh_job(job):
    """``job["steps"]`` sharded steps on make_mesh(dp, sp, tp): this rank's
    losses and final (gpt, embed) shards."""
    cfg = job["cfg"]
    mesh = mesh_mod.make_mesh(dp=job["dp"], sp=job["sp"], tp=job["tp"])
    opt = train.make_optimizer(lr=LR, warmup=WARMUP)
    gpt = mesh_mod.shard_params(job["gpt"], mesh_mod.gpt_param_specs(cfg),
                                mesh)
    emb = mesh_mod.shard_params(job["embed"],
                                mesh_mod.embed_param_specs(cfg), mesh)
    state = train.TrainState(gpt, emb, opt.init((gpt, emb)),
                             torch.zeros((), dtype=torch.int64))
    batch = mesh_mod.shard_params(job["batch"], mesh_mod.train_batch_specs(),
                                  mesh)
    step = train.make_train_step(cfg, opt, mesh)
    losses = []
    with planted(job.get("fault")):
        for _ in range(job["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return {"coords": tuple(mesh.coords[a] for a in mesh_mod.AXES),
            "losses": losses, "leaves": _np((state.gpt, state.embed))}


class _Log:
    """Records the pp mesh's hand-offs in the order a rank makes them."""

    def __init__(self, mesh):
        self.events = []
        for name in ("send", "recv", "send_back", "recv_back"):
            setattr(self, name, self._logged(name, getattr(mesh, name)))
        self.mesh = mesh

    def _logged(self, name, fn):
        def call(*args):
            self.events.append(name)
            return fn(*args)
        return call

    def __getattr__(self, name):
        return getattr(self.mesh, name)


def _pp_forward_job(job):
    mesh = pl.make_pp_mesh(job["pp"])
    if mesh.coords is None:
        return None
    fwd = pl.make_pp_forward(job["cfg"], mesh, job["n_micro"])
    out = fwd(pl.pp_params(job["gpt"], mesh)["stacked"], job["emb"],
              job["attn"], job["positions"])
    return {"hidden": out.to(torch.float32).numpy()}


def _pp_train_job(job):
    mesh = pl.make_pp_mesh(job["pp"])
    if mesh.coords is None:
        return None
    log = _Log(mesh)
    opt = train.make_optimizer(lr=LR, warmup=WARMUP)
    gpt = pl.pp_params(job["gpt"], mesh)
    emb = job["embed"]
    state = train.TrainState(gpt, emb, opt.init((gpt, emb)),
                             torch.zeros((), dtype=torch.int64))
    step = pl.make_pp_train_step(job["cfg"], opt, log, job["n_micro"])
    batch = job["batch"]
    with torch.no_grad():
        loss_fn = float(pl.pp_loss_fn(
            gpt["stacked"], gpt["norm"], emb, batch, job["cfg"],
            pl.make_pp_forward(job["cfg"], mesh, job["n_micro"])))
    losses = []
    with planted(job.get("fault")):
        for i in range(job["steps"]):
            if i == 1:
                log.events.clear()  # one step's hand-offs
            state, m = step(state, batch)
            if i == 1:
                events = list(log.events)
            losses.append(float(m["loss"]))
    return {"stage": mesh.coords["pp"], "losses": losses, "events": events,
            "loss_fn": loss_fn, "leaves": _np((state.gpt, state.embed))}


def _collectives_job(rank, n):
    """The three differentiable collectives on the world group: forward
    and the gradient of sum(w * out) for a rank-dependent w."""
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10 * rank
    out = {}
    for name, fn in (("reduce", lambda t: comm.reduce_sum(t, None)),
                     ("copy", lambda t: comm.copy_to(t, None)),
                     ("gather", lambda t: comm.gather_cat(t, 1, rank, n,
                                                          None))):
        t = x.clone().requires_grad_()
        y = fn(t)
        w = torch.full(y.shape, float(rank + 1), dtype=torch.float64)
        w += torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape)
        (g,) = torch.autograd.grad((y * w).sum(), t)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def train_mesh_rank(rank: int, n: int, jobs):
    """Run ``jobs`` in order on every rank; returns their results (None
    where this rank is not on a job's mesh)."""
    out = []
    for job in jobs:
        if job["kind"] == "mesh":
            out.append(_mesh_job(job))
        elif job["kind"] == "pp_forward":
            out.append(_pp_forward_job(job))
        elif job["kind"] == "pp_train":
            out.append(_pp_train_job(job))
        elif job["kind"] == "collectives":
            out.append(_collectives_job(rank, n))
        else:
            raise ValueError(job["kind"])
    return out
