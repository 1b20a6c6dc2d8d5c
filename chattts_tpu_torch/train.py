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
docstring); nothing here imports optax.  On one device; the sharded and
pipelined steps of the JAX package are not ported yet.

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


def _forward_hidden(gpt_params, embed_params, batch: TrainBatch,
                    cfg: GPTConfig) -> torch.Tensor:
    """The layer stack over the embedded batch -> (B, T, D) f32, the final
    norm applied.  ``llama.prefill_block`` layer by layer: ``prefill``
    would write a KV cache that training never reads."""
    emb = embed_mod.embed_prompt(embed_params, batch.ids, batch.text_mask)
    positions = (torch.cumsum(batch.attn_mask.to(torch.int32), dim=1)
                 - 1).clamp_min(0)
    cos_t, sin_t = llama.rope_tables_torch(cfg, emb.device)
    cos, sin = cos_t[positions], sin_t[positions]
    bias = llama.prefill_bias(batch.attn_mask)
    x = emb.to(torch.bfloat16)
    for lp in gpt_params["layers"]:
        x, _, _ = llama.prefill_block(lp, x, bias, cos, sin, cfg,
                                      torch.bfloat16)
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


def loss_from_hidden(embed_params, hidden: torch.Tensor, batch: TrainBatch
                     ) -> torch.Tensor:
    """CE given the transformer's output hidden states (B, T, D) f32: the
    head/objective half of :func:`loss_fn`."""
    h = hidden[:, :-1]                      # predict position t+1 from t
    tgt_ids = batch.ids[:, 1:]              # (B, T-1, num_vq)
    tgt_text = batch.text_mask[:, 1:]
    tgt_valid = batch.attn_mask[:, 1:]

    text_lp = torch.log_softmax(embed_mod.head_text(embed_params, h), dim=-1)
    text_nll = _nll(text_lp, tgt_ids[..., :1])

    code_logits = torch.einsum(
        "btd,qdv->btqv", h.to(torch.float32),
        embed_params["head_code"].to(torch.float32))
    code_lp = torch.log_softmax(code_logits, dim=-1)
    code_nll = _nll(code_lp, tgt_ids[..., None]).sum(-1)

    nll = torch.where(tgt_text, text_nll, code_nll)
    nll = torch.where(tgt_valid, nll, 0.0)
    return nll.sum() / tgt_valid.sum().clamp_min(1)


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

    def update(grads, state: AdamWState, params):
        g_norm = torch.sqrt(sum(_sum_of_squares(g)
                                for g in tree_leaves(grads)))
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


def make_train_step(cfg: GPTConfig, optimizer: Optimizer):
    """Returns ``train_step(state, batch) -> (state, {"loss": loss})``.

    The step returns a new state and leaves the one it was given as it was
    (the reference donates its state to XLA; here nothing is written in
    place, so a caller may keep the old state).  Its regions are labelled
    for ``torch.profiler``: ``train.forward`` (embeddings and the layer
    stack), ``train.loss`` (heads and CE), ``train.backward`` and
    ``train.optimizer``."""

    def train_step(state: TrainState, batch: TrainBatch):
        params = map_tree(lambda t: t.detach().requires_grad_(True),
                          (state.gpt, state.embed))
        flat = tree_leaves(params)
        with record_function("train.forward"):
            hidden = _forward_hidden(params[0], params[1], batch, cfg)
        with record_function("train.loss"):
            loss = loss_from_hidden(params[1], hidden, batch)
        with record_function("train.backward"):
            grads = unflatten(params, torch.autograd.grad(loss, flat))
        with record_function("train.optimizer"), torch.no_grad():
            old = (state.gpt, state.embed)
            updates, opt_state = optimizer.update(grads, state.opt_state, old)
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

