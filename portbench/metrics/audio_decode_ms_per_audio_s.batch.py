"""Milliseconds of the audio back end per second of audio it made: the
program's ``chat.decode_to_wavs`` spans in the traced calls (the mel
decoder, Vocos and the copy to the host), summed, over the audio seconds
of their ``frames`` (the rows' decoded steps, 2 x hop_length samples
each)."""

from harness import spans


def read(s):
    calls = spans.inside(s, "chat.decode_to_wavs")
    frames = sum(sp.attrs.get("frames", 0) for sp in calls or ())
    if not frames:
        return None
    v = s.config["vocos"]
    audio_s = frames * 2 * v["hop_length"] / v["sample_rate"]
    return spans.dur_us(calls) / 1e3 / audio_s
