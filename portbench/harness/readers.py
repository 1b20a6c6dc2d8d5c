"""Arithmetic the metric readers share (``portbench/metrics/*.py``)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import roofline, trace

DECODE_STEP_KERNELS = ("gemv_kernel", "attend_scores_kernel",
                       "attend_values_kernel", "kv4_append_kernel")
GEMVS = ("gemv qkv", "gemv wo", "gemv gate/up", "gemv down")


def p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None


def idle_pct(s) -> Optional[float]:
    tr = s.tracer.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)


def traced_steps(s):
    """[(B, steps, prompt lengths)] of the whole calls a batch run traced,
    or None where it traced none."""
    batches = s.state.get("traced_batches")
    if not batches or s.tracer.trace is None:
        return None
    return [(len(b), b[0].steps, [len(it.text) + 4 for it in b])
            for b in batches]


def seen(prompts: List[int], k: int) -> List[int]:
    """Keys each row sees at decode step k (its own appended one too)."""
    return [n + k + 1 for n in prompts]


def bound_ms(s, rows) -> float:
    """Least time of the kernels named ``rows`` over the traced steps."""
    gpt = s.config["gpt"]
    L = gpt["num_hidden_layers"]
    total = 0.0
    for B, steps, prompts in traced_steps(s):
        for k in range(steps):
            b = roofline.kernel_bounds(gpt, seen(prompts, k),
                                       s.config["kv_bits"],
                                       s.config["weight_bits"])
            total += L * sum(b[r][0] for r in rows)
    return total


def roofline_pct(s, rows, kernels) -> Optional[float]:
    if traced_steps(s) is None:
        return None
    n, us = trace.family_us(s.tracer.trace, kernels)
    if not n:
        return None
    return 100.0 * bound_ms(s, rows) / (us / 1e3)
