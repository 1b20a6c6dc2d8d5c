"""On-device sampling (port of ``chattts_tpu/ops/sampling.py``).

The reference chain, processor by processor: divide by temperature, windowed
repetition penalty, top-p (HF ascending-sort semantics, min_keep 3), top-k
(HF strict threshold, min_keep 3), EOS suppression while ``step < min_new``,
then a categorical draw.  The filters run in *sorted* space off one stable
ascending sort whose ties break by column index, as ``lax.sort`` over
``(scores, iota)`` breaks them, and the draw is ``argmax(s_asc + gumbel)``.

``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel(key))``,
so a test that hands :func:`sample` the Gumbel noise JAX drew gets the same
token.  In production the noise comes from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    """Sampling knobs of one generation call."""

    temperature: torch.Tensor  # (num_streams,) f32, tiled over the rows
    top_p: float
    top_k: int
    repetition_penalty: float
    min_new: int


def repetition_penalty(scores: torch.Tensor, window_ids: torch.Tensor,
                       window_mask: torch.Tensor, penalty: float,
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
    alpha = torch.pow(torch.tensor(penalty, dtype=torch.float32,
                                   device=scores.device), freq)
    return torch.where(scores < 0, scores * alpha, scores / alpha)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, params: SamplingParams,
           window_ids: torch.Tensor, window_mask: torch.Tensor, step: int,
           eos_token: int, max_penalized: int,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full sampling chain over logits (N, V) f32; returns ids (N,) int64.

    ``noise`` (N, V) is the Gumbel noise of the draw; without it the noise
    is drawn from ``generator``.
    """
    N, V = logits.shape
    temp = params.temperature.to(logits.device, torch.float32)
    if temp.shape[0] != N:  # per-codebook temperatures tiled over the batch
        temp = temp.repeat(N // temp.shape[0])
    scores = logits / temp[:, None]
    if params.repetition_penalty != 1.0:
        scores = repetition_penalty(scores, window_ids, window_mask,
                                    params.repetition_penalty, max_penalized)

    s_asc, order = torch.sort(scores, dim=-1, stable=True)
    pos = torch.arange(V, device=logits.device)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)

    # top-p: remove the ascending prefix whose cumulative mass <= 1 - p,
    # always keeping the 3 largest
    cum = torch.cumsum(torch.softmax(s_asc, dim=-1), dim=-1)
    # 1 - p in f32, as the reference computes it
    one = torch.ones((), dtype=torch.float32, device=logits.device)
    thr = one - torch.tensor(params.top_p, dtype=torch.float32,
                             device=logits.device)
    s_asc = torch.where((cum <= thr) & (pos < V - 3), neg_inf, s_asc)
    # top-k: strictly below the k-th largest goes (min_keep 3)
    k = min(max(params.top_k, 3), V)
    s_asc = torch.where(s_asc < s_asc[:, V - k:V - k + 1], neg_inf, s_asc)
    # EOS suppression while step < min_new, found by its sorted position
    if step < params.min_new:
        s_asc = torch.where(order == eos_token, neg_inf, s_asc)

    if noise is None:
        noise = gumbel((N, V), generator, logits.device)
    j = torch.argmax(s_asc + noise.to(logits.device), dim=-1)
    return order.gather(1, j[:, None])[:, 0]
