"""Training step for the speech-token LM (port of ``chattts_tpu/train.py``).

Next-token cross-entropy over the mixed text/audio-code stream: text
positions score against the text head, code positions against all
``num_vq`` code heads, with AdamW behind a global-norm clip on a warmup +
cosine learning rate.  The trees keep the JAX package's layouts (``gpt`` as
``models/llama.init_params`` gives it, ``embed`` as
``models/embed.init_params``), so a JAX train state bridges leaf by leaf
(``weights.from_numpy``).

The forward, heads and loss are torch ops and the backward is autograd
(the reference's are XLA, not Pallas kernels).  ``make_optimizer`` writes
optax's chain out in torch ops, in optax's order and dtypes (see its
docstring); nothing here imports optax.

On one device, or sharded: ``make_train_step(cfg, opt, mesh)`` runs on the
shards that ``parallel/mesh.shard_params`` gives a rank of a (dp, sp, tp)
mesh (``gpt_param_specs``, ``embed_param_specs``, ``train_batch_specs``),
where the JAX package lets XLA shard one jitted step.  The pipelined step
is ``parallel/pipeline.py``'s.

    opt = make_optimizer(lr=3e-3, warmup=1)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opt)
    step = make_train_step(cfg, opt)
    batch = random_batch(torch.Generator().manual_seed(1), cfg, 8, 1024)
    state, metrics = step(state, batch)   # metrics["loss"]: () f32
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from .config import GPTConfig
from .models import embed as embed_mod
from .models import llama
from .weights import (map_tree, resolve_device, to_device, tree_leaves,
                      unflatten)


class TrainBatch(NamedTuple):
    ids: torch.Tensor        # (B, T, num_vq) integer ids
    attn_mask: torch.Tensor  # (B, T) bool
    text_mask: torch.Tensor  # (B, T) bool: True = text token position


class AdamWState(NamedTuple):
    """The optimizer's state: ``count`` () int32 updates taken (optax's
    ``ScaleByAdamState.count``; its schedule keeps a count of its own that
    always equals this one), ``mu`` and ``nu`` the moments, a tree like
    the parameters, each leaf in its parameter's dtype."""

    count: torch.Tensor
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    gpt: dict
    embed: dict
    opt_state: AdamWState
    step: torch.Tensor  # () int64


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation`` shape: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``; ``schedule`` maps
    a count to the learning rate."""

    init: Callable[[Any], AdamWState]
    update: Callable[[Any, AdamWState, Any], tuple]
    schedule: Callable[[torch.Tensor], torch.Tensor]


def rope_positions(attn_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) rope positions: the valid positions before each, counted
    along the whole time axis (0 at left padding)."""
    return (torch.cumsum(attn_mask.to(torch.int32), dim=1) - 1).clamp_min(0)


def _forward_hidden(gpt_params, embed_params, batch: TrainBatch,
                    cfg: GPTConfig, mesh=None, attn_mask=None,
                    start: int = 0) -> torch.Tensor:
    """The layer stack over the embedded batch -> (B, T, D) f32, the final
    norm applied.  ``llama.prefill_block`` layer by layer: ``prefill``
    would write a KV cache that training never reads.  Sharded (``mesh``):
    ``batch`` is the rank's (B/dp, T/sp) shard, whose positions begin at
    ``start`` of the rows' whole ``attn_mask`` (B/dp, T); the rope
    positions count the valid keys of the whole rows."""
    if attn_mask is None:
        attn_mask = batch.attn_mask
    emb = embed_mod.embed_prompt(embed_params, batch.ids, batch.text_mask)
    T = emb.shape[1]
    positions = rope_positions(attn_mask)[:, start:start + T]
    cos_t, sin_t = llama.rope_tables_torch(cfg, emb.device)
    cos, sin = cos_t[positions], sin_t[positions]
    bias = llama.prefill_bias(attn_mask, start, T)
    x = emb.to(torch.bfloat16)
    for lp in gpt_params["layers"]:
        x, _, _ = llama.prefill_block(lp, x, bias, cos, sin, cfg,
                                      torch.bfloat16, mesh=mesh)
    return llama.rms_norm(x, gpt_params["norm"],
                          cfg.rms_norm_eps).to(torch.float32)


def loss_fn(gpt_params, embed_params, batch: TrainBatch, cfg: GPTConfig
            ) -> torch.Tensor:
    """Mixed text/code next-token CE, averaged over valid target positions."""
    hidden = _forward_hidden(gpt_params, embed_params, batch, cfg)
    return loss_from_hidden(embed_params, hidden, batch)


def _nll(logp: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """-logp at ``ids`` along the last axis.  Ids past the vocabulary are
    clamped into it: the reference's gather fills them with NaN, and both
    only reach positions that ``loss_from_hidden`` discards (a text id at
    a code head, or a code id at a too-small text head)."""
    ids = ids.long().clamp(0, logp.shape[-1] - 1)
    return -torch.gather(logp, -1, ids)[..., 0]


def _nll_vocab_parallel(logits: torch.Tensor, ids: torch.Tensor, mesh
                        ) -> torch.Tensor:
    """``_nll(log_softmax(whole logits), ids)`` where the rank holds its
    tp shard of the vocabulary's columns, ``logits`` (..., V/tp): the max
    (no gradient: the result does not depend on it), the sum of
    exponentials and the target's logit are summed over tp, so no rank
    gathers the logits.  An id lies in one rank's columns or, past the
    vocabulary, in none (its target logit is then 0 and its value finite;
    such positions are the ones ``_nll`` clamps and the loss discards)."""
    V = logits.shape[-1]
    with torch.no_grad():
        top = mesh.gather(logits.amax(-1), "tp").amax(0)
    sumexp = mesh.reduce(torch.exp(logits - top[..., None]).sum(-1), "tp")
    local = ids[..., 0].long() - mesh.coords["tp"] * V
    inside = (local >= 0) & (local < V)
    z = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    z = mesh.reduce(torch.where(inside, z, 0.0), "tp")
    return torch.log(sumexp) + top - z


def _nll_sum(embed_params, h: torch.Tensor, tgt: TrainBatch, mesh=None):
    """(sum of the CE over valid targets, their count): ``h`` (B, n, D)
    predicts ``tgt``'s (B, n) ids.  Under tp > 1 the heads are the rank's
    vocab columns (:func:`_nll_vocab_parallel`), and ``h``'s gradient is
    summed over tp (each rank's heads send back a partial)."""
    tp = mesh is not None and mesh.shape["tp"] > 1
    if tp:
        h = mesh.copy(h, "tp")
    text_logits = embed_mod.head_text(embed_params, h)
    code_logits = torch.einsum(
        "btd,qdv->btqv", h.to(torch.float32),
        embed_params["head_code"].to(torch.float32))
    if tp:
        text_nll = _nll_vocab_parallel(text_logits, tgt.ids[..., :1], mesh)
        code_nll = _nll_vocab_parallel(code_logits, tgt.ids[..., None],
                                       mesh).sum(-1)
    else:
        text_nll = _nll(torch.log_softmax(text_logits, dim=-1),
                        tgt.ids[..., :1])
        code_nll = _nll(torch.log_softmax(code_logits, dim=-1),
                        tgt.ids[..., None]).sum(-1)
    nll = torch.where(tgt.text_mask, text_nll, code_nll)
    nll = torch.where(tgt.attn_mask, nll, 0.0)
    return nll.sum(), tgt.attn_mask.sum()


def loss_from_hidden(embed_params, hidden: torch.Tensor, batch: TrainBatch
                     ) -> torch.Tensor:
    """CE given the transformer's output hidden states (B, T, D) f32: the
    head/objective half of :func:`loss_fn`."""
    # predict position t+1 from t
    total, count = _nll_sum(embed_params, hidden[:, :-1],
                            TrainBatch(*(x[:, 1:] for x in batch)))
    return total / count.clamp_min(1)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int):
    """optax's ``warmup_cosine_decay_schedule`` (its ``end_value`` 0) in
    float32 torch ops: a linear ramp from ``init_value`` over
    ``warmup_steps`` counts, then a cosine from ``peak_value`` to 0 at
    ``decay_steps``.  The value at count 0 is ``init_value``."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps must exceed warmup_steps, got "
                         f"{decay_steps=}, {warmup_steps=}")
    f32 = torch.float32

    def cosine(count):
        count = torch.clamp_max(count.to(f32), float(span))
        return peak_value * (0.5 * (1 + torch.cos(math.pi * count
                                                  / float(span))))

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        if warmup_steps > 0:
            frac = 1 - count.clamp(0, warmup_steps).to(f32) / warmup_steps
            ramp = (init_value - peak_value) * frac + peak_value
        else:  # optax's ramp of no steps holds its start value
            ramp = torch.full_like(count, init_value, dtype=f32)
        return torch.where(count < warmup_steps, ramp,
                           cosine(count - warmup_steps))

    return schedule


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """A leaf's sum of squares as the reference's compiled global norm
    takes it: squared and summed in f32, the sum rounded to the leaf's
    dtype (``jnp.sum`` of a bf16 leaf is bf16), then widened to f32 for the
    sum over leaves."""
    sq = g.to(torch.float32)
    return torch.sum(sq * sq).to(g.dtype).to(torch.float32)


def global_norm(grads, split=None, reduce=None) -> torch.Tensor:
    """The norm over every leaf of ``grads`` (f32): each leaf's
    :func:`_sum_of_squares`, added in f32 in leaf order.  Sharded, each
    rank holds a part of some leaves: ``split`` marks them (a bool a leaf,
    in leaf order) and ``reduce`` sums their sums over the ranks that hold
    the parts (in place), so each counts whole; a leaf every rank holds
    whole counts once.  A part's sum rounds to its dtype on its own."""
    sums = [_sum_of_squares(g) for g in tree_leaves(grads)]
    if split is not None and any(split):
        parts = reduce(torch.stack([s for s, m in zip(sums, split) if m]))
        parts = iter(parts.unbind())
        sums = [next(parts) if m else s for s, m in zip(sums, split)]
    return torch.sqrt(sum(sums))


# optax's adamw defaults and the reference's clip
B1, B2, EPS, MAX_NORM = 0.9, 0.999, 1e-8, 1.0


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   warmup: int = 100) -> Optimizer:
    """The reference's ``optax.chain(clip_by_global_norm(1.0),
    adamw(warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000),
    weight_decay=0.01))`` as an :class:`Optimizer` (optax's init/update
    shape, not a ``torch.optim.Optimizer``), to optax's arithmetic:

    * the clip divides each leaf by the global norm, rounded to the leaf's
      dtype, when the norm is at least ``MAX_NORM``; the norm adds the
      leaves' sums of squares in f32, each rounded to its leaf's dtype;
    * moments take each leaf's dtype, and every constant is rounded to that
      dtype as a JAX weak-typed scalar is, so on bf16 leaves the moments,
      the bias corrections (computed in f32, then rounded), ``mu_hat /
      (sqrt(nu_hat) + eps)``, the decay term and the update are bf16 ops,
      each rounded;
    * the learning rate is read at the count before the update: the first
      update is ``init_value`` = 0, so it leaves the parameters as they
      are.

    ``update(grads, state, params, norm=None)``: ``norm`` is the global
    norm when ``grads`` are a rank's shards (:func:`global_norm` over the
    ranks), else it is taken from ``grads``.

    ``torch.optim.AdamW`` is not this: it interpolates the first moment
    and divides by ``sqrt(nu) / sqrt(bc2) + eps``, which rounds otherwise
    in bf16.  Nothing is updated in place."""
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup, 10_000)
    consts = {}

    def const(dtype):  # the chain's scalars in a leaf's dtype (host)
        if dtype not in consts:
            consts[dtype] = {
                k: torch.tensor(v, dtype=dtype) for k, v in (
                    ("1-b1", 1 - B1), ("b1", B1), ("1-b2", 1 - B2),
                    ("b2", B2), ("eps", EPS), ("wd", weight_decay),
                    ("max_norm", MAX_NORM))}
        return consts[dtype]

    def init(params) -> AdamWState:
        dev = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          map_tree(torch.zeros_like, params),
                          map_tree(torch.zeros_like, params))

    def update(grads, state: AdamWState, params, norm=None):
        g_norm = global_norm(grads) if norm is None else norm
        keep = g_norm < MAX_NORM
        count = state.count + 1
        step_size = -schedule(state.count)
        bc1 = 1 - torch.pow(B1, count.to(torch.float32))
        bc2 = 1 - torch.pow(B2, count.to(torch.float32))
        # the step's scalars, each rounded once to every leaf dtype present
        scalars = {dt: [x.to(dt) for x in (g_norm, bc1, bc2, step_size)]
                   for dt in {g.dtype for g in tree_leaves(grads)}}

        def leaf(g, m, v, p):
            c = const(g.dtype)
            norm, bc1_, bc2_, lr_ = scalars[g.dtype]
            g = torch.where(keep, g, g / norm * c["max_norm"])
            m = c["1-b1"] * g + c["b1"] * m
            v = c["1-b2"] * (g * g) + c["b2"] * v
            u = (m / bc1_) / (torch.sqrt(v / bc2_) + c["eps"])
            u = u + c["wd"] * p
            return lr_ * u, m, v

        out = [leaf(*xs) for xs in zip(*map(tree_leaves, (
            grads, state.mu, state.nu, params)))]
        u, m, v = (unflatten(grads, (o[i] for o in out)) for i in range(3))
        return u, AdamWState(count, m, v)

    return Optimizer(init, update, schedule)


def apply_updates(params, updates):
    """optax's ``apply_updates``: ``p + u`` in ``p``'s dtype."""
    return unflatten(params, ((p + u).to(p.dtype) for p, u in zip(
        tree_leaves(params), tree_leaves(updates))))


def init_train_state(gen: torch.Generator, cfg: GPTConfig,
                     optimizer: Optimizer, device=None) -> TrainState:
    """Seeded ``gpt`` (bf16) and ``embed`` (f32) trees, drawn in that order
    from ``gen`` on the CPU, and the optimizer's state, on ``device``
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gpt = to_device(llama.init_params(gen, cfg), dev)
    emb = to_device(embed_mod.init_params(gen, cfg), dev)
    return TrainState(gpt, emb, optimizer.init((gpt, emb)),
                      torch.zeros((), dtype=torch.int64, device=dev))


def _whole_rows(batch: TrainBatch, mesh) -> TrainBatch:
    """The rank's rows (B/dp) of the batch at every position: its (B/dp,
    T/sp) shards gathered over sp in one collective (ids and both masks
    packed as int64; small beside the activations)."""
    packed = torch.cat([batch.ids.long(), batch.attn_mask[..., None].long(),
                        batch.text_mask[..., None].long()], dim=-1)
    whole = torch.cat(mesh.gather(packed, "sp").unbind(0), dim=1)
    return TrainBatch(whole[..., :-2].to(batch.ids.dtype),
                      whole[..., -2].bool(), whole[..., -1].bool())


def _sum_leaves(tree, reduce):
    """Every leaf of ``tree`` summed over ranks in its dtype: each dtype's
    leaves flattened into one tensor, which ``reduce`` sums in place."""
    leaves = tree_leaves(tree)
    out = list(leaves)
    for dt in dict.fromkeys(g.dtype for g in leaves):
        idx = [i for i, g in enumerate(leaves) if g.dtype == dt]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        reduce(flat)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return unflatten(tree, out)


def _sum_over_data(grads, mesh):
    """Every leaf's gradient summed over dp and sp (the ranks that hold
    the same shard of it and different data)."""
    def reduce(flat):
        for axis in ("dp", "sp"):
            mesh.all_reduce(flat, axis)

    return _sum_leaves(grads, reduce)


def make_train_step(cfg: GPTConfig, optimizer: Optimizer, mesh=None):
    """Returns ``train_step(state, batch) -> (state, {"loss": loss})``.

    The step returns a new state and leaves the one it was given as it was
    (the reference donates its state to XLA; here nothing is written in
    place, so a caller may keep the old state).  Its regions are labelled
    for ``torch.profiler``: ``train.forward`` (embeddings and the layer
    stack), ``train.loss`` (heads and CE), ``train.backward`` and
    ``train.optimizer``.

    ``mesh`` (``parallel/mesh.make_mesh(dp, tp, sp)``; every rank of it
    calls the step on its shards): the state's trees are the rank's
    ``shard_params`` of ``gpt_param_specs`` and ``embed_param_specs`` (the
    optimizer's moments made from them), the batch its ``shard_params`` of
    ``train_batch_specs``.  The layers run on tp and sp shards
    (``llama.prefill_block``'s ``mesh``); the last position of an sp shard
    predicts the first id of the next (the rows are gathered over sp), the
    heads' vocab columns stay split over tp (a vocab-parallel CE), and the
    mean divides by the valid targets of the whole batch.  Every gradient
    is summed over dp and sp, the clip's norm is global (a tp-split leaf's
    sum of squares summed over tp, a whole one counted once), and AdamW
    updates each rank's shards.  The loss is the whole batch's on every
    rank.  At one rank the step is the unsharded one."""
    if mesh is not None:
        from .parallel import mesh as mesh_mod

        specs = (mesh_mod.gpt_param_specs(cfg),
                 mesh_mod.embed_param_specs(cfg))
        tp = mesh_mod.AXES.index("tp")
        # the leaves split over tp, in leaf order (global_norm's ``split``)
        split = tree_leaves(mesh_mod.map_specs(
            lambda _, p: mesh.shape["tp"] > 1
            and isinstance(p[tp], mesh_mod.Shard), specs, specs))

    def train_step(state: TrainState, batch: TrainBatch):
        params = map_tree(lambda t: t.detach().requires_grad_(True),
                          (state.gpt, state.embed))
        flat = tree_leaves(params)
        if mesh is None:
            with record_function("train.forward"):
                hidden = _forward_hidden(params[0], params[1], batch, cfg)
            with record_function("train.loss"):
                loss = loss_from_hidden(params[1], hidden, batch)
            norm = None
        else:
            with record_function("train.forward"):
                rows = _whole_rows(batch, mesh)
                T, Ts = rows.attn_mask.shape[1], batch.attn_mask.shape[1]
                start = mesh.coords["sp"] * Ts
                hidden = _forward_hidden(params[0], params[1], batch, cfg,
                                         mesh, rows.attn_mask, start)
            with record_function("train.loss"):
                n = min(Ts, T - 1 - start)  # the last position predicts none
                total, count = _nll_sum(params[1], hidden[:, :n], TrainBatch(
                    *(x[:, start + 1:start + 1 + n] for x in rows)), mesh)
                for axis in ("dp", "sp"):
                    count = mesh.all_reduce(count.clone(), axis)
                loss = total / count.clamp_min(1)
        with record_function("train.backward"):
            grads = unflatten(params, torch.autograd.grad(loss, flat))
        with record_function("train.optimizer"), torch.no_grad():
            if mesh is not None:
                grads = _sum_over_data(grads, mesh)
                loss = loss.detach().clone()
                for axis in ("dp", "sp"):
                    mesh.all_reduce(loss, axis)
                norm = global_norm(grads, split,
                                   lambda t: mesh.all_reduce(t, "tp"))
            old = (state.gpt, state.embed)
            sharded = () if norm is None else (norm,)
            updates, opt_state = optimizer.update(grads, state.opt_state, old,
                                                  *sharded)
            gpt, emb = apply_updates(old, updates)
        return (TrainState(gpt, emb, opt_state, state.step + 1),
                {"loss": loss.detach()})

    return train_step


def random_batch(gen: torch.Generator, cfg: GPTConfig, batch: int, seq: int,
                 device=None) -> TrainBatch:
    """Synthetic batch shaped like real data: a text prefix of ``seq // 2``
    (ids in [0, num_text_tokens)), a code suffix (ids in [0,
    num_audio_tokens - 1)), every position valid.  Drawn from ``gen`` on
    the CPU, placed on ``device`` (CUDA unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    shape = (batch, seq, cfg.num_vq)
    text_ids = torch.randint(0, cfg.num_text_tokens, shape, generator=gen)
    code_ids = torch.randint(0, cfg.num_audio_tokens - 1, shape,
                             generator=gen)
    text_mask = (torch.arange(seq) < seq // 2)[None, :].expand(batch, seq)
    ids = torch.where(text_mask[..., None], text_ids, code_ids)
    return TrainBatch(ids.to(dev),
                      torch.ones((batch, seq), dtype=torch.bool, device=dev),
                      text_mask.contiguous().to(dev))

