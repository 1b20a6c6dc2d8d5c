"""The service's engine thread: the benchmark's span around each ``step()``
of the capacity engine, summed over the window, per decode step the
engine ran (its ``stats["steps"]``)."""


def read(s):
    steps = s.counters.get("decode_steps")
    if not steps:
        return None
    return 1e3 * s.counters["engine_step_s"] / steps
