"""Counter-based noise for the continuous-batching engine (threefry2x32).

The reference keys every engine slot with
``fold_in(PRNGKey(seed), attempt)``, derived on the host, folds that key by
the request's global depth and by the codebook on the device, and draws
``gumbel(key, (V,))`` for the row (``chattts_tpu/engine/batching.py``,
``chattts_tpu/ops/sampling.py``).  So a row's noise is a pure function of
(request seed, attempt, global depth, codebook), never of the slot it sits
in, of the co-resident requests or of the engine's history.

This module keeps that property and the reference's bits: the host side in
plain integers (:func:`host_slot_key`), the device side in torch int64 ops
masked to 32 bits (:func:`fold_in`, :func:`gumbel_rows`), with no per-slot
host loop.  ``gumbel_rows`` follows the reference's generator as it is
configured by default (one threefry block per element, counter = the
element's index, the two output words xored; 23 mantissa bits to a uniform
in [tiny, 1); ``-log(-log(u))``).
"""

from __future__ import annotations

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32_host(key, count) -> np.ndarray:
    """One threefry-2x32 block in plain ints: (k0, k1), (c0, c1) -> uint32[2]."""
    ks0, ks1 = int(key[0]) & _M, int(key[1]) & _M
    ks = (ks0, ks1, ks0 ^ ks1 ^ _PARITY)
    x0, x1 = (int(count[0]) + ks0) & _M, (int(count[1]) + ks1) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return np.asarray([x0, x1], np.uint32)


def host_slot_key(seed: int, attempt: int) -> np.ndarray:
    """A request's slot key: the seed's (hi, lo) words as the key, folded by
    the retry attempt.  uint32[2]."""
    seed = int(seed)
    return threefry2x32_host(((seed >> 32) & _M, seed & _M), (0, attempt))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0: torch.Tensor,
                 c1: torch.Tensor):
    """The block on int64 tensors holding 32-bit words (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (c0 + k0) & _M, (c1 + k1) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """keys (N, 2), data (N,) non-negative -> folded keys (N, 2), int64."""
    zero = torch.zeros_like(data, dtype=torch.int64)
    x0, x1 = threefry2x32(keys[:, 0], keys[:, 1], zero,
                          data.to(torch.int64) & _M)
    return torch.stack([x0, x1], dim=1)


def random_bits_rows(keys: torch.Tensor, V: int) -> torch.Tensor:
    """keys (N, 2) -> (N, V) 32-bit words (int64), element j of a row from
    the counter (0, j)."""
    j = torch.arange(V, device=keys.device, dtype=torch.int64)[None, :]
    x0, x1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(j), j)
    return x0 ^ x1


def gumbel_rows(keys: torch.Tensor, V: int) -> torch.Tensor:
    """keys (N, 2) -> (N, V) f32 standard Gumbel noise, a row per key."""
    bits = random_bits_rows(keys, V)
    u = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))
