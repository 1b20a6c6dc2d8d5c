"""Device milliseconds of the decode step's own kernels (the gemvs, the
attention pair, the kv4 append) per decode step, over the traced calls."""

from harness import readers, trace


def read(s):
    steps = s.counters.get("decode_steps")
    if s.tracer.trace is None or not steps:
        return None
    n, us = trace.family_us(s.tracer.trace, readers.DECODE_STEP_KERNELS)
    return us / 1e3 / steps if n else None
