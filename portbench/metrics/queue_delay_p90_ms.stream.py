"""The capacity engine's queue delay, submit to admission, 90th
percentile over the window's requests: the program's own counter,
``TTSService.stats()["code"]["queue_delay_p90_s"]``."""


def read(s):
    v = s.counters.get("queue_delay_p90_s")
    return None if v is None or v != v else 1e3 * v
