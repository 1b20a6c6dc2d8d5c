"""The whole model step's share of the card's dense bf16 peak: the model
operations of the traced calls' prefills and decode steps, counted from
shapes (``harness/roofline.py``), over the traced seconds times 989
TFLOP/s."""

from harness import readers, roofline


def read(s):
    calls = readers.traced_steps(s)
    if calls is None or s.tracer.trace.window_s <= 0:
        return None
    gpt = s.config["gpt"]
    flops = 0.0
    for B, steps, prompts in calls:
        flops += roofline.prefill_flops(gpt, prompts)
        flops += sum(roofline.decode_step_flops(gpt, readers.seen(prompts, k))
                     for k in range(steps))
    return 100.0 * flops / (s.tracer.trace.window_s
                            * roofline.BF16_FLOP_PER_S)
