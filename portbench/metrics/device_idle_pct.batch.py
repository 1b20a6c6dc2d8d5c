"""The share of the traced seconds in which no kernel, copy or fill ran
on the card (the union of their intervals)."""

from harness import readers


def read(s):
    return readers.idle_pct(s)
