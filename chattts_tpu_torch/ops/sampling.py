"""On-device sampling (port of ``chattts_tpu/ops/sampling.py``).

The reference chain, processor by processor: divide by temperature, windowed
repetition penalty, top-p (HF ascending-sort semantics, min_keep 3), top-k
(HF strict threshold, min_keep 3), EOS suppression while ``step < min_new``,
then a categorical draw.  The filters run in *sorted* space off one stable
ascending sort whose ties break by column index, as ``lax.sort`` over
``(scores, iota)`` breaks them, and the draw is ``argmax(s_asc + gumbel)``.

``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel(key))``,
so a test that hands :func:`sample` the Gumbel noise JAX drew gets the same
token.  In production the noise comes from a ``torch.Generator``
(Generator) or from ``ops/threefry.py`` (the engine's per-row noise).

Every knob but the temperature is a scalar (one generation call) or an (N,)
tensor (continuous batching: each row carries its own); ``step`` and
``eos_token`` likewise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

Rows = Union[int, float, torch.Tensor]  # a scalar, or one value per row


class SamplingParams(NamedTuple):
    """Sampling knobs: scalars for one call, or (N,) tensors per row."""

    temperature: torch.Tensor  # (num_streams,) or (N,) f32, tiled over rows
    top_p: Rows
    top_k: Rows
    repetition_penalty: Rows  # 1.0 disables
    min_new: Rows             # EOS is suppressed while step < min_new


def _per_row(v: Rows, N: int, dtype, device) -> torch.Tensor:
    """A scalar or (N,) value as an (N,) tensor on ``device`` (no host
    read, no host-to-device copy for a Python scalar)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).expand(N)
    return torch.full((N,), v, dtype=dtype, device=device)


def repetition_penalty(scores: torch.Tensor, window_ids: torch.Tensor,
                       window_mask: torch.Tensor, penalty: Rows,
                       max_penalized: int) -> torch.Tensor:
    """Scale negative scores by ``penalty**freq`` and divide positive ones,
    freq counting each column in the valid window; columns >= max_penalized
    are exempt."""
    N, V = scores.shape
    ids = window_ids.clamp(0, V - 1).long()
    freq = torch.zeros((N, V), dtype=torch.float32, device=scores.device)
    freq.scatter_add_(1, ids, window_mask.to(torch.float32))
    if max_penalized < V:
        freq[:, max_penalized:] = 0.0
    pen = _per_row(penalty, N, torch.float32, scores.device)
    alpha = torch.pow(pen[:, None], freq)
    return torch.where(scores < 0, scores * alpha, scores / alpha)


MIN_KEEP = 3  # top-p and top-k always keep the 3 largest scores


def _top_p_removed(s_asc: torch.Tensor, top_p: Rows) -> torch.Tensor:
    """Top-p in sorted space: over ascending scores (N, V), True where the
    ascending prefix whose cumulative mass is at most 1 - p goes (the
    ``MIN_KEEP`` largest stay); 1 - p in f32, as the reference computes
    it."""
    N, V = s_asc.shape
    cum = torch.cumsum(torch.softmax(s_asc, dim=-1), dim=-1)
    thr = 1.0 - _per_row(top_p, N, torch.float32, s_asc.device)[:, None]
    pos = torch.arange(V, device=s_asc.device)[None, :]
    return (cum <= thr) & (pos < V - MIN_KEEP)


def _top_k_removed(s_asc: torch.Tensor, top_k: Rows) -> torch.Tensor:
    """Top-k in sorted space: True where a score is strictly below the
    k-th largest, k at least ``MIN_KEEP``.  Applied after top-p it removes
    the same columns as on the masked scores (top-p removes an ascending
    prefix)."""
    N, V = s_asc.shape
    k = _per_row(top_k, N, torch.long, s_asc.device).clamp(MIN_KEEP, V)
    return s_asc < s_asc.gather(1, (V - k)[:, None])


def _unsorted(removed: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(removed).scatter(1, order, removed)


def top_p_mask(scores: torch.Tensor, top_p: Rows) -> torch.Tensor:
    """HF ``TopPLogitsWarper`` as a mask (True = remove), ascending-sort
    semantics; ``top_p`` is a scalar or one value per row.  The rule is
    :func:`sample`'s own (``_top_p_removed``)."""
    s_asc, order = torch.sort(scores, dim=-1, stable=True)
    return _unsorted(_top_p_removed(s_asc, top_p), order)


def top_k_mask(scores: torch.Tensor, top_k: Rows) -> torch.Tensor:
    """HF ``TopKLogitsWarper`` as a mask (True = remove); ``top_k`` is a
    scalar or one value per row.  The rule is :func:`sample`'s own
    (``_top_k_removed``)."""
    s_asc, order = torch.sort(scores, dim=-1, stable=True)
    return _unsorted(_top_k_removed(s_asc, top_k), order)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, params: SamplingParams,
           window_ids: torch.Tensor, window_mask: torch.Tensor, step: Rows,
           eos_token: Rows, max_penalized: int,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full sampling chain over logits (N, V) f32; returns ids (N,) int64.

    ``noise`` (N, V) is the Gumbel noise of the draw, row by row; without
    it the noise is drawn from ``generator``.  ``step`` and ``eos_token``
    are scalars or (N,) tensors, as the parameters are.
    """
    N, V = logits.shape
    temp = params.temperature.to(logits.device, torch.float32)
    if temp.shape[0] != N:  # per-codebook temperatures tiled over the batch
        temp = temp.repeat(N // temp.shape[0])
    scores = logits / temp[:, None]
    rp = params.repetition_penalty
    # per-row penalties always apply (a row with 1.0 is left as it is)
    if isinstance(rp, torch.Tensor) or rp != 1.0:
        scores = repetition_penalty(scores, window_ids, window_mask,
                                    params.repetition_penalty, max_penalized)

    s_asc, order = torch.sort(scores, dim=-1, stable=True)
    dev = logits.device
    removed = (_top_p_removed(s_asc, params.top_p)
               | _top_k_removed(s_asc, params.top_k))
    # EOS suppression while step < min_new, found by its sorted position
    eos_sup = (_per_row(step, N, torch.long, dev)
               < _per_row(params.min_new, N, torch.long, dev))
    eos_rows = _per_row(eos_token, N, torch.long, dev)
    removed |= eos_sup[:, None] & (order == eos_rows[:, None])
    # a Python scalar: no host-to-device copy, so a CUDA graph can
    # capture the draw
    s_asc = torch.where(removed, float("-inf"), s_asc)

    if noise is None:
        noise = gumbel((N, V), generator, logits.device)
    j = torch.argmax(s_asc + noise.to(logits.device), dim=-1)
    return order.gather(1, j[:, None])[:, 0]
