"""File hashing for asset verification (the part of
``chattts_tpu/utils/native.py`` the port needs, on ``hashlib``: the JAX
package's own path when its C++ library is not built).  ``float_to_int16``
lives in ``utils/audio.py``."""

from __future__ import annotations

import hashlib


def sha256_file(path: str) -> str:
    """Hex sha256 of a file, read in 1 MiB chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
