"""The gemvs' share of their roofline: the sum of each launch's least time
(``harness/roofline.py``) over the sum of its device time, over the
traced calls."""

from harness import readers


def read(s):
    return readers.roofline_pct(s, readers.GEMVS, ("gemv_kernel",))
