"""CUDA kernel launches in the traced calls per decode step run there
(the launches from the device trace, the steps from the program's
``decode_step.launches`` counter)."""


def read(s):
    steps = s.counters.get("decode_steps")
    if s.tracer.trace is None or not steps:
        return None
    return len(s.tracer.trace.kernels()) / steps
