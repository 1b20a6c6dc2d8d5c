"""Gap between consecutive audio chunks of a stream, 95th percentile over
every chunk of every stream of the window but each stream's first (that
is its time to first audio); a stream cut short adds the gap from its
last chunk to the time it was given up at (host clock)."""

import numpy as np

from harness.readers import p95


def read(s):
    gaps = []
    for r in s.records:
        t = list(r.chunks) + ([s.window_s] if r.end is None and r.chunks
                              else [])
        gaps += list(1e3 * np.diff(t))
    return p95(gaps)
