"""Saturated serving: a closed loop of ``traffic["callers"]`` callers, each
calling the blocking ``TTSService.synthesize`` again as soon as its last
call returns, with the refine pass skipped and a forced length.  There are
more callers than the capacity engine's slots, so a backlog is always
waiting: continuous batching refills slots as requests finish and
preempts (by recompute) a long runner when work has waited.  The window
holds every call that started before ``--seconds`` ran out.
"""

from __future__ import annotations

import threading

from harness import serve, traffic
from harness.session import Record


def setup(s) -> None:
    service = serve.start_service(s)
    serve.warm(s, lambda it: service.synthesize(
        it.text, params_code=serve.params(s, it), skip_refine_text=True))
    n = int(s.traffic["callers"] * (s.seconds + 30)) + 64
    s.state["items"] = traffic.items(s.traffic, s.seed, n)


def _caller(s, lock, nxt) -> None:
    service = s.state["service"]
    while True:
        with lock:
            if s.now() >= s.seconds or nxt[0] >= len(s.state["items"]):
                return
            i = nxt[0]
            nxt[0] += 1
            rec = Record(key=i, due=s.now(), start=s.now(),
                         items=[s.state["items"][i]])
            s.records.append(rec)
        item = rec.items[0]
        s.outputs.local.keys = [i]
        try:
            service.synthesize(item.text, params_code=serve.params(s, item),
                               skip_refine_text=True)
            rec.end = s.now()
            codes = s.outputs.codes.get(i)
            rec.ok = codes is not None and len(codes) > 0
            rec.audio_s = s.audio_seconds(len(codes)) if rec.ok else 0.0
        except (TimeoutError, InterruptedError) as e:
            s.say(f"request {i} failed: {e!r}")


def run(s) -> None:
    lock, nxt = threading.Lock(), [0]
    callers = [threading.Thread(target=_caller, args=(s, lock, nxt),
                                daemon=True)
               for _ in range(s.traffic["callers"])]
    s.open_window()
    stats0 = serve.code_stats(s)
    for t in callers:
        t.start()
    trace_at = s.workload.get("trace_after_s", 2.0)
    trace_s = s.workload.get("trace_seconds", 3.0)
    if s.traced:
        import time

        time.sleep(trace_at)
        s.tracer.start()
        time.sleep(trace_s)
        s.tracer.stop()
    for t in callers:
        t.join(timeout=serve.TIMEOUT_S + 10)
    stats1 = serve.code_stats(s)
    for k in ("steps", "tokens_generated", "preemptions", "prefills"):
        s.counters[k] = stats1.get(k, 0) - stats0.get(k, 0)
    s.counters["slots"] = stats1["slots"]
    done = [r.end for r in s.records if r.end is not None]
    s.window_s = max(done) if done else s.now()


def teardown(s) -> None:
    serve.stop_service(s)


def judged(s):
    """(text, codes, program wav) of the greedy requests that finished."""
    out = {}
    for rec in s.records:
        it = rec.items[0]
        if it.greedy and rec.ok and rec.key in s.outputs.wavs:
            codes = s.outputs.codes[rec.key]
            out[rec.key] = (it.text, codes, s.outputs.wavs[rec.key][
                :len(codes) * s.samples_per_step])
    return out
