"""The attention pair's share of its roofline: the least time of each
step's scores and values launches (the rows each row sees at that step)
over their device time, over the traced calls."""

from harness import readers


def read(s):
    return readers.roofline_pct(s, ("attention pair",),
                                ("attend_scores_kernel",
                                 "attend_values_kernel"))
