"""Reproducible-RNG context (reference ``tools/seeder/ctx.py:4-15``; a copy
of ``chattts_tpu/utils/seeder.py``).

The reference saves/restores the torch RNG state so the WebUI can sample a
deterministic speaker timbre per seed.  Here the speaker's RNG state lives
on the Speaker object (a numpy Generator), so the context swaps that.
"""

from __future__ import annotations

import numpy as np


class SpeakerSeedContext:
    """with SpeakerSeedContext(speaker, seed): ... -> deterministic timbre."""

    def __init__(self, speaker, seed: int):
        self._speaker = speaker
        self._seed = seed
        self._saved = None

    def __enter__(self):
        self._saved = self._speaker._rng
        self._speaker._rng = np.random.default_rng(self._seed)
        return self._speaker

    def __exit__(self, *exc):
        self._speaker._rng = self._saved
        return False
