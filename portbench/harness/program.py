"""The hooks that record what the timed path produced, the same for every
family (the program's ``Chat`` is built by the configuration's family,
``families/<name>.py``, ``load_chat``).

The hooks are instance wrappers: they call the program's own method and
keep its return value (or the tokens it streamed) for the comparison with
the reference after the window; they change nothing the program does.
"""

from __future__ import annotations

import threading
from typing import Dict


class Outputs:
    """What the timed path produced, by request key: the generated codes of
    each row and, where the path decodes whole wavs, each row's wav before
    the facade strips its near-silent samples."""

    def __init__(self):
        self.codes: Dict = {}
        self.wavs: Dict = {}
        self.resumes: Dict = {}   # key -> generated lengths at each resume
        self.rid_key: Dict = {}   # the Engine's request_id -> key
        self.local = threading.local()
        self._mu = threading.Lock()

    def keep(self, key, codes, wav=None):
        with self._mu:
            self.codes[key] = codes
            if wav is not None:
                self.wavs[key] = wav


def record_decodes(chat, out: Outputs) -> None:
    """Wrap ``chat._decode_to_wavs`` (every non-streaming synthesis ends
    there): the calling thread names its request keys in
    ``out.local.keys``, one per row."""
    inner = chat._decode_to_wavs

    def decode_to_wavs(result, use_decoder):
        wavs = inner(result, use_decoder)
        keys = getattr(out.local, "keys", None)
        if keys is not None:
            for k, ids, wav in zip(keys, result.ids, wavs):
                out.keep(k, ids.copy(), wav)
        return wavs

    chat._decode_to_wavs = decode_to_wavs


def record_streamed_codes(service, out: Outputs) -> None:
    """Wrap ``service._code_reqs`` so each request's streamed code tokens
    are kept under the key its calling thread names in
    ``out.local.keys``."""
    import numpy as np

    inner = service._code_reqs

    def code_reqs(texts, params, on_tokens=None):
        reqs = inner(texts, params, on_tokens=on_tokens)
        keys = getattr(out.local, "keys", None)
        if keys is None or on_tokens is None:
            return reqs
        for key, r in zip(keys, reqs):
            got = []

            def tap(rid, new_ids, new_hid, finished, _got=got, _key=key,
                    _cb=r.on_tokens):
                if new_ids is not None:
                    _got.append(np.asarray(new_ids).copy())
                if finished and _got:
                    out.keep(_key, np.concatenate(_got))
                return _cb(rid, new_ids, new_hid, finished)

            r.on_tokens = tap
        return reqs

    service._code_reqs = code_reqs


def record_resumes(service, out: Outputs) -> None:
    """Keep, for each request key, the generated length at which each of
    the service's engines preempted it (by recompute): wraps
    ``service._code_reqs`` to learn each request's key and every engine's
    ``_maybe_preempt`` to see whom it took out of its slots."""
    inner = service._code_reqs

    def code_reqs(texts, params, on_tokens=None):
        reqs = inner(texts, params, on_tokens=on_tokens)
        for key, r in zip(getattr(out.local, "keys", None) or [], reqs):
            with out._mu:
                out.rid_key[r.request_id] = key
        return reqs

    service._code_reqs = code_reqs
    for eng in service._engines():
        _watch_preemptions(eng, out)


def _watch_preemptions(eng, out: Outputs) -> None:
    inner = eng._maybe_preempt

    def maybe_preempt():
        held = [r for r in eng.slots if r is not None]
        inner()
        kept = {id(r) for r in eng.slots if r is not None}
        for r in held:
            if id(r) not in kept:
                with out._mu:
                    key = out.rid_key.get(r.request_id)
                    if key is not None:
                        out.resumes.setdefault(key, []).append(r.resume_len)

    eng._maybe_preempt = maybe_preempt
