"""The service's engine thread in the device's idle time: of the traced
stretch's idle intervals (no kernel, copy or fill running), the share
during which the engine thread was inside ``service.step`` (its pass over
the engines under the mutex) and outside ``engine.ingest`` (its wait on a
chunk's status and the host read), in percent."""

from harness import spans


def read(s):
    got = spans.stretch(s)
    idle = spans.device_idle(s)
    if got is None or idle is None:
        return None
    rec = got[0]
    steps = [sp for sp in rec if sp.name == "service.step"]
    if not steps:
        return None
    tids = {sp.tid for sp in steps}
    ingest = [spans.us(sp) for sp in rec
              if sp.name == "engine.ingest" and sp.tid in tids]
    busy = spans.minus([spans.us(sp) for sp in steps], ingest)
    total = spans.length(idle)
    if total <= 0:
        return None
    return 100.0 * spans.length(spans.intersect(idle, busy)) / total
