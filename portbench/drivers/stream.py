"""Streaming listeners of the server: an open loop of Poisson arrivals into
one in-process ``TTSService``.

Each request is ``synthesize_stream(text, params)`` from a thread of its
own, started when it is due, with the server's default cadence and a
forced length.  Requests due in the window are the attempted ones; the
loop stops sending when ``--seconds`` run out and waits up to
``traffic["drain_s"]`` for the streams in flight.  Each request is timed
from when it was due, so a late sender counts against the service, and
the sender's lateness is printed.
"""

from __future__ import annotations

import threading
import time

from harness import serve, traffic
from harness.session import Record


def setup(s) -> None:
    service = serve.start_service(s)

    def one(item):
        for _ in service.synthesize_stream(item.text, serve.params(s, item)):
            pass

    serve.warm(s, one)
    plan(s)


def plan(s) -> None:
    """The window's requests and when each is due, at the mix's rate; the
    engines' statistics start afresh, so their percentiles count the
    window's requests only."""
    service = s.state["service"]
    with service._mu:
        for eng in service._engines():
            eng.reset_stats()
    n = int(s.traffic["rate"] * s.seconds * 1.5) + 16
    s.state["items"] = traffic.items(s.traffic, s.seed, n)
    s.state["due"] = traffic.arrival_times(
        s.traffic["rate"], n, traffic.rng_for(traffic.ORDER, "arrivals"))


def _listen(s, rec: Record, item) -> None:
    service = s.state["service"]
    s.outputs.local.keys = [rec.key]
    pcm = []
    try:
        for chunk in service.synthesize_stream(item.text,
                                               serve.params(s, item)):
            if chunk.size:
                t = s.now()
                if rec.first is None:
                    rec.first = t
                rec.chunks.append(t)
                pcm.append(chunk.reshape(-1))
        rec.end = s.now()
        rec.ok = rec.first is not None
    except (TimeoutError, InterruptedError) as e:
        s.say(f"request {rec.key} failed: {e!r}")
    s.state["pcm"][rec.key] = pcm


def run(s) -> None:
    import numpy as np

    items, due = s.state["items"], s.state["due"]
    s.state["pcm"] = {}
    threads = []
    late = []
    s.open_window()
    if s.traced:
        eng = s.state["service"]._engs[0]
        s.counters["steps_before"] = eng.stats["steps"]
        _time_steps(s, eng)
    trace_at = s.workload.get("trace_after_s", 2.0)
    trace_s = s.workload.get("trace_seconds", 3.0)
    i = 0
    while i < len(items) and due[i] < s.seconds:
        wait = due[i] - s.now()
        if s.traced and not s.tracer.running and s.tracer.trace is None \
                and s.now() >= trace_at:
            s.tracer.start()
        if s.tracer.running and s.now() >= trace_at + trace_s:
            s.tracer.stop()
        if wait > 0:
            time.sleep(min(wait, 0.05))
            continue
        late.append(-wait)
        rec = Record(key=i, due=float(due[i]), start=s.now(),
                     items=[items[i]])
        s.records.append(rec)
        t = threading.Thread(target=_listen, args=(s, rec, items[i]),
                             daemon=True)
        t.start()
        threads.append(t)
        i += 1
    if s.tracer.running:
        s.tracer.stop()
    sent = s.now()
    deadline = time.perf_counter() + s.traffic["drain_s"]
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    s.window_s = s.now()
    s.counters["queue_delay_p90_s"] = serve.code_stats(s).get(
        "queue_delay_p90_s", float("nan"))
    if s.traced:
        eng = s.state["service"]._engs[0]
        s.counters["decode_steps"] = eng.stats["steps"] - s.counters[
            "steps_before"]
    s.state["service"].interrupt()   # requests past the drain fail
    for t in threads:
        t.join(timeout=10.0)
    ttfa = [1e3 * (r.first - r.due) for r in s.records if r.first is not None]
    gaps = [1e3 * g for r in s.records for g in np.diff(r.chunks)]
    if ttfa and gaps:
        s.say("first audio ms p50 / p90 / p95 / max "
              + " / ".join(f"{np.percentile(ttfa, q):.1f}"
                           for q in (50, 90, 95, 100))
              + "; chunk gaps ms p50 / p90 / p95 "
              + " / ".join(f"{np.percentile(gaps, q):.1f}"
                           for q in (50, 90, 95)))
    s.say(f"sender: {len(threads)} requests due in {s.seconds} s, stopped "
          f"at {sent:.3f} s, lateness p50 {np.median(late) * 1e3:.3f} ms "
          f"max {max(late) * 1e3:.3f} ms; window closed at "
          f"{s.window_s:.3f} s")


def _time_steps(s, eng) -> None:
    """The benchmark's span around each step of the capacity engine: its
    seconds summed (traced runs only)."""
    inner = eng.step
    s.counters["engine_step_s"] = 0.0

    def step(*a, **kw):
        t = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            s.counters["engine_step_s"] += time.perf_counter() - t

    eng.step = step


def teardown(s) -> None:
    serve.stop_service(s)


def judged(s):
    """(text, codes, streamed samples but the silence-stripped tail) of
    the greedy requests that finished, by key."""
    import numpy as np

    out = {}
    for rec in s.records:
        it = rec.items[0]
        pcm = s.state["pcm"].get(rec.key)
        if it.greedy and rec.end is not None and rec.key in s.outputs.codes \
                and pcm:
            body = np.concatenate(pcm[:-1]) if len(pcm) > 1 else \
                np.zeros(0, np.float32)
            out[rec.key] = (it.text, s.outputs.codes[rec.key], body)
    return out
