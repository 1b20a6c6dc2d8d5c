"""Batch synthesis through ``Chat.infer``: a closed loop of calls.

Each call synthesizes ``traffic["batch"]`` texts with the refine pass
skipped and no text splitting, at one random speaker a run, on the
Generator route; its length is forced (``min_new_token`` equals
``max_new_token``), since random weights end on EOS by chance and not by
meaning.  Every other call is greedy (a temperature far below any gap
between logits), so the comparison with the reference can judge its
tokens; the others sample at ChatTTS's default temperature.  The next call
starts when the last returns; the window holds every call that started
before ``--seconds`` ran out.
"""

from __future__ import annotations

from harness import program, serve, traffic

CALLS = 256   # calls made ready, used in turn; a window uses tens


def _params(chat, s, batch, seed):
    spk, steps, greedy = s.state["spk"], batch[0].steps, batch[0].greedy
    return chat.InferCodeParams(
        prompt="[speed_5]", spk_emb=spk,
        temperature=serve.GREEDY_TEMPERATURE if greedy else 0.3,
        top_P=0.7, top_K=20, repetition_penalty=1.05,
        max_new_token=steps, min_new_token=steps, manual_seed=seed,
        show_tqdm=False)


def _call(s, batch, index, keys=None):
    chat = s.state["chat"]
    s.outputs.local.keys = keys
    p = _params(chat, s, batch, (s.seed + 7919 * index) % (1 << 31))
    chat.infer([it.text for it in batch], skip_refine_text=True,
               split_text=False, params_infer_code=p)
    s.outputs.local.keys = None


def setup(s) -> None:
    rng = traffic.rng_for(s.seed, "speaker")
    vec = traffic.speaker_vector(rng, s.config["gpt"]["hidden_size"])
    s.state["spk_vec"] = vec
    s.state["spk"] = traffic.speaker_string(vec)
    chat = program.load_chat(s.config, s.weights, s.device)
    program.record_decodes(chat, s.outputs)
    s.state["chat"] = chat
    s.state["calls"] = traffic.batches(s.traffic, s.seed, CALLS)
    # every shape the window will use: one call at each forced length, at
    # the batch width, on prompts as long as the window's longest
    warm = traffic.batches(dict(s.traffic, prompt_tokens=[
        s.traffic["prompt_tokens"][1]] * 2), s.seed + 1,
        s.traffic["length_quantiles"])
    for i, batch in enumerate(warm):
        _call(s, batch, -1 - i)


def run(s) -> None:
    from chattts_tpu_torch.ops import decode_step as k1

    from harness.session import Record

    calls = s.state["calls"]
    trace_s = s.workload.get("trace_seconds", 3.0)
    traced = []
    s.open_window()
    i = 0
    while s.now() < s.seconds:
        batch = calls[i % len(calls)]
        if s.traced and i == 1:  # whole calls, from the second on
            s.tracer.start()
            trace_from, steps0 = s.now(), k1.decode_step.launches
        start = s.now()
        keys = [(i, b) for b in range(len(batch))]
        _call(s, batch, i, keys=keys)
        n = sum(len(s.outputs.codes.get(k, ())) for k in keys)
        s.records.append(Record(key=i, due=start, start=start, end=s.now(),
                                audio_s=s.audio_seconds(n), ok=n > 0,
                                items=batch))
        if s.tracer.running:
            traced.append(batch)
            if s.now() - trace_from >= trace_s:
                s.tracer.stop()
                s.counters["decode_steps"] = k1.decode_step.launches - steps0
        i += 1
    if s.tracer.running:
        s.tracer.stop()
        s.counters["decode_steps"] = k1.decode_step.launches - steps0
    s.window_s = s.records[-1].end
    s.state["traced_batches"] = traced
    rates = [r.items[0].steps / (r.end - r.start) for r in s.records]
    s.say(f"calls: {len(rates)}, steps/s a call p10 / p50 / p90 "
          f"{_q(rates, 0.1):.1f} / {_q(rates, 0.5):.1f} / {_q(rates, 0.9):.1f};"
          f" first half {_mean(rates[:len(rates) // 2]):.1f}, second half "
          f"{_mean(rates[len(rates) // 2:]):.1f}")


def _q(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def _mean(xs):
    return sum(xs) / len(xs) if xs else float("nan")


def teardown(s) -> None:
    s.state.pop("chat", None)


def judged(s):
    """(text, codes, program wav) of the greedy rows finished in the
    window, by key."""
    out = {}
    for rec in s.records:
        for b, it in enumerate(rec.items):
            key = (rec.key, b)
            if it.greedy and key in s.outputs.wavs:
                codes = s.outputs.codes[key]
                out[key] = (it.text, codes, s.outputs.wavs[key][
                    :len(codes) * s.samples_per_step])
    return out

