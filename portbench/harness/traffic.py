"""The traffic generator: texts, lengths, arrivals and speakers from a seed.

One generator serves every traffic mix; a mix is the parameters in its
workload file (``portbench/workloads/<name>.json``, key ``traffic``).

Every seed gets the same sizes and arrivals in the same order: the lengths
are fixed quantiles of their distribution, dealt out in cycles of a
shuffled order, and the arrival gaps fixed quantiles of the exponential
distribution in a shuffled order, both shuffles fixed by the mix and not
by the seed.  The seed draws what is said (the texts), the speaker, the
weights and the sampling.  So two seeds differ in their inputs and not in
how much work a window holds or when it comes: near a service's knee a
burst placed elsewhere moves a tail by more than the noise of a run.  The texts are made of a character set on which the program's
asset-free tokenizer maps every character to its own id (one token each).
"""

from __future__ import annotations

import lzma
import math
from dataclasses import dataclass
from typing import List

import numpy as np

CHARSET = "abcdefghijklmnopqrstuvwxyz ,."
WORDS = ("hello", "speech", "voice", "river", "morning", "light", "quiet",
         "story", "market", "window", "garden", "paper", "music", "table",
         "summer", "winter", "simple", "answer", "little", "question", "city",
         "train", "letter", "friend", "open", "sound", "listen", "read",
         "write", "walk", "near", "far", "bright", "slow", "fast", "warm",
         "cold", "green", "blue", "house", "road", "bridge", "the", "a",
         "of", "and", "to", "in", "we", "it", "was", "for", "on", "with")
PROMPT_TOKENS_AROUND_TEXT = 4   # [Stts] [spk_emb] [speed_5] ... [Ptts]


ORDER = 0   # the seed of every mix's shuffles of lengths and arrivals


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per use, from the run's seed (any
    non-negative integer, 64 bits and more)."""
    return np.random.default_rng([int(seed) % (1 << 64), int(seed) >> 64,
                                  *map(ord, stream)])


def quantiles_log_uniform(lo: int, hi: int, n: int) -> List[int]:
    """n lengths at the mid-quantiles of log-uniform [lo, hi]."""
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n
                               * (math.log(hi) - math.log(lo)))))
            for i in range(n)]


def quantiles_uniform(lo: int, hi: int, n: int) -> List[int]:
    return [int(round(lo + (i + 0.5) / n * (hi - lo))) for i in range(n)]


def dealt(values: List, count: int, rng: np.random.Generator) -> List:
    """``count`` values dealt from ``values`` in cycles, each cycle in its
    own shuffled order: every run of len(values) consecutive values holds
    each once."""
    out: List = []
    while len(out) < count:
        out += [values[i] for i in rng.permutation(len(values))]
    return out[:count]


def text_of_tokens(n_tokens: int, rng: np.random.Generator) -> str:
    """A text whose code prompt is ``n_tokens`` tokens long: words drawn
    from ``WORDS``, cut to the length, ending in a full stop."""
    n_chars = max(2, n_tokens - PROMPT_TOKENS_AROUND_TEXT)
    words: List[str] = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    return " ".join(words)[:n_chars - 1] + "."


def arrival_times(rate: float, count: int, rng: np.random.Generator
                  ) -> np.ndarray:
    """Due times (s from the window's start) of ``count`` Poisson
    arrivals at ``rate`` a second: the mid-quantiles of the exponential
    gap, in a shuffled order."""
    q = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-q) / rate
    return np.cumsum(gaps[rng.permutation(count)])


def speaker_vector(rng: np.random.Generator, dim: int) -> np.ndarray:
    """A random speaker: only its direction counts (the model
    L2-normalizes it); float16, as the speaker string carries it."""
    return rng.standard_normal(dim).astype(np.float16)


# -- the speaker string (ChatTTS's wire format: raw lzma2, base16384) ---------

_LZMA_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 9 | lzma.PRESET_EXTREME}]


def _b14_encode(data: bytes) -> str:
    arr = np.frombuffer(data, dtype=np.uint8)
    rem = len(data) % 7
    nchars = (len(data) // 7) * 4 + (-(-(8 * rem) // 14) if rem else 0)
    bits = np.unpackbits(arr, bitorder="big")
    bits = np.concatenate([bits, np.zeros(nchars * 14 - bits.size, np.uint8)])
    vals = (bits.reshape(nchars, 14).astype(np.uint32)
            * (1 << np.arange(13, -1, -1)).astype(np.uint32)).sum(1) + 0x4E00
    return "".join(map(chr, vals.tolist())) + (chr(0x3D00 + rem) if rem
                                               else "")


def speaker_string(vec: np.ndarray) -> str:
    """``spk_emb`` as ChatTTS passes it: the float16 vector, lzma2 raw,
    base16384."""
    raw = np.asarray(vec, np.float16).tobytes()
    return _b14_encode(lzma.compress(raw, format=lzma.FORMAT_RAW,
                                     filters=_LZMA_FILTERS))


@dataclass
class Item:
    """One synthesis request (or one text of a batch call)."""

    text: str
    steps: int         # forced length in code steps
    greedy: bool
    index: int


def batches(traffic: dict, seed: int, count: int) -> List[List[Item]]:
    """``count`` batch calls of ``traffic["batch"]`` texts: each call's
    forced length dealt from its quantiles, each text's prompt length
    likewise, every other call greedy."""
    rng_len = rng_for(ORDER, "lengths")
    rng_txt = rng_for(seed, "texts")
    B = traffic["batch"]
    steps = dealt(quantiles_log_uniform(*traffic["steps"],
                                        traffic["length_quantiles"]),
                  count, rng_len)
    prompts = dealt(quantiles_uniform(*traffic["prompt_tokens"],
                                      traffic["length_quantiles"]),
                    count * B, rng_len)
    return [[Item(text_of_tokens(prompts[c * B + b], rng_txt), steps[c],
                  c % 2 == 0, c * B + b) for b in range(B)]
            for c in range(count)]


def items(traffic: dict, seed: int, count: int) -> List[Item]:
    """``count`` requests of a mix: prompt lengths and step counts dealt
    from their quantiles, every other request greedy (greediness is not
    tied to a length: the lengths come in shuffled cycles)."""
    rng_len = rng_for(ORDER, "lengths")
    rng_txt = rng_for(seed, "texts")
    steps = dealt(quantiles_log_uniform(*traffic["steps"],
                                        traffic["length_quantiles"]),
                  count, rng_len)
    prompts = dealt(quantiles_uniform(*traffic["prompt_tokens"],
                                      traffic["length_quantiles"]),
                    count, rng_len)
    return [Item(text_of_tokens(p, rng_txt), s, i % 2 == 0, i)
            for i, (p, s) in enumerate(zip(prompts, steps))]
