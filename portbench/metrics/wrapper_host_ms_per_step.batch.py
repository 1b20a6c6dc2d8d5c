"""Host milliseconds of the decode-step wrapper per call: the program's
``decode_step`` spans in the traced calls, summed, over their count (the
wrapper's checks, buffers and launch; one call a decode step)."""

from harness import spans


def read(s):
    steps = spans.inside(s, "decode_step")
    if not steps:
        return None
    return spans.dur_us(steps) / 1e3 / len(steps)
