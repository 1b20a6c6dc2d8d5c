"""Prefill spent on recompute: of the prompt tokens the Engine prefilled
in the traced stretch (the program's ``engine.prefill`` spans, one a
wave), the share that resumed requests preempted by recompute (their
prompts and the tokens made before the preemption), in percent."""

from harness import spans


def read(s):
    waves = spans.inside(s, "engine.prefill")
    tokens = sum(sp.attrs.get("tokens", 0) for sp in waves or ())
    if not tokens:
        return None
    resumed = sum(sp.attrs.get("resumed_tokens", 0) for sp in waves)
    return 100.0 * resumed / tokens
