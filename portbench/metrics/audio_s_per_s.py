"""Audio seconds per second: the audio of every call or request completed
in the run over the time from the window's start to the end of the last
call that started before ``--seconds`` ran out (host clock)."""


def read(s):
    done = [r for r in s.records if r.start < s.seconds and r.ok]
    if not done or s.window_s <= 0:
        return None
    return sum(r.audio_s for r in done) / s.window_s
