"""Time to first audio, 95th percentile: from when each request of the
window was due to its first non-empty chunk; a request that never sent
audio counts with the time it was given up at (host clock)."""

from harness.readers import p95


def read(s):
    return p95([1e3 * ((r.first if r.first is not None else s.window_s)
                       - r.due) for r in s.records])
