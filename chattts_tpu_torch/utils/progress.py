"""Host-side generation progress (a copy of ``chattts_tpu/utils/progress.py``).

The reference shows a tqdm bar over the per-token loop
(``ChatTTS/model/gpt.py:383-390``).  Here the hooks ride the host reads the
Generator and the Engine already make (``on_progress`` of
``GenerateRequest`` and ``EngineRequest``), so ``show_tqdm`` costs no extra
synchronisation with the device.  The bar is tqdm's where tqdm can be
imported; where it cannot, nothing is drawn, as in the JAX package.

``ProgressBar`` adds per-request step counts (a batch generates in
parallel slots) into one bar; it tolerates counts going backwards (the
empty-generation retry restarts an attempt from step 0).
"""

from __future__ import annotations

from typing import Dict


class ProgressBar:
    """tqdm-backed aggregate progress over one generation pass."""

    def __init__(self, total: int, desc: str = "generate"):
        self.total = total
        self._done: Dict[object, int] = {}
        self._bar = None
        if total > 0:
            try:
                from tqdm import tqdm

                self._bar = tqdm(total=total, desc=desc, unit="tok",
                                 leave=False, dynamic_ncols=True)
            except Exception:  # noqa: BLE001 - display is best-effort
                self._bar = None

    def report(self, key, done: int) -> None:
        """Set request ``key``'s progress to ``done`` steps (idempotent)."""
        if self._bar is None:
            return
        self._done[key] = int(done)
        n = min(sum(self._done.values()), self.total)
        if n != self._bar.n:
            self._bar.n = n
            self._bar.refresh()

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()
            self._bar = None
