"""Host milliseconds of the Generator's step loop per decode step: the
program's ``generator.steps`` spans (each a stretch of steps enqueued
between two host reads) in the traced calls, summed, over the
``decode_step`` spans inside them."""

from harness import spans


def read(s):
    stretches = spans.inside(s, "generator.steps")
    if not stretches:
        return None
    ids = {sp.index for sp in stretches}
    steps = [sp for sp in spans.inside(s, "decode_step") if sp.parent in ids]
    if not steps:
        return None
    return spans.dur_us(stretches) / 1e3 / len(steps)
