"""The share of the Generator's decode steps in the traced calls that ran
as a replay of a captured CUDA graph: the ``graphed`` attribute of the
program's ``generator.steps`` spans, summed, over their ``steps``, in
percent.  A program whose spans carry no ``graphed`` reads nothing."""

from harness import spans


def read(s):
    stretches = spans.inside(s, "generator.steps")
    if not stretches or any("graphed" not in sp.attrs for sp in stretches):
        return None
    steps = sum(sp.attrs["steps"] for sp in stretches)
    if steps <= 0:
        return None
    return 100.0 * sum(sp.attrs["graphed"] for sp in stretches) / steps
