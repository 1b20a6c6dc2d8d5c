"""Asset verification: checksums of a ChatTTS asset tree (port of
``chattts_tpu/utils/dl.py``).

Every asset is verified against the TRUSTED sha256 map vendored in the
package (``res/sha256_map.json``, a byte-for-byte copy of the JAX package's,
whose keys and values are the reference's ``ChatTTS/res/sha256_map.json``) -
never against a map shipped beside the assets, which would be
self-attested.  Trees are located by ``utils/io.find_assets_dir``; nothing is
downloaded here.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Dict, Optional

from .native import sha256_file

logger = logging.getLogger(__name__)

_VENDORED_MAP = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "res", "sha256_map.json")

# the nine reference assets
ASSET_FILES = [
    "asset/Decoder.safetensors",
    "asset/DVAE.safetensors",
    "asset/Embed.safetensors",
    "asset/Vocos.safetensors",
    "asset/gpt/config.json",
    "asset/gpt/model.safetensors",
    "asset/tokenizer/special_tokens_map.json",
    "asset/tokenizer/tokenizer_config.json",
    "asset/tokenizer/tokenizer.json",
]


def _map_key(rel_path: str) -> str:
    """Key format of the reference map: extension joins with '_'
    (e.g. asset/gpt/config.json -> sha256_asset_gpt_config_json)."""
    name = rel_path[len("asset/"):].replace("/", "_").replace(".", "_")
    return f"sha256_asset_{name}"


@functools.lru_cache(maxsize=1)
def trusted_sha256_map() -> Dict[str, str]:
    """The vendored known-good checksum map."""
    with open(_VENDORED_MAP) as f:
        return json.load(f)


def generate_sha256_map(base_dir: str) -> Dict[str, str]:
    """Recompute the checksum map over a local asset tree."""
    out = {}
    for rel in ASSET_FILES:
        p = os.path.join(base_dir, rel)
        if os.path.isfile(p):
            out[_map_key(rel)] = sha256_file(p)
    return out


def check_asset(base_dir: str, rel_path: str, expected: Optional[str]) -> bool:
    p = os.path.join(base_dir, rel_path)
    if not os.path.isfile(p):
        logger.warning("missing asset %s", p)
        return False
    if expected is None:
        logger.warning("no trusted checksum for %s", rel_path)
        return False
    got = sha256_file(p)
    if got != expected:
        logger.warning("checksum mismatch for %s: %s != %s", p, got, expected)
        return False
    return True


def check_all_assets(base_dir: str,
                     sha256_map: Optional[Dict[str, str]] = None) -> bool:
    """Verify the full asset tree against the TRUSTED vendored map.

    Pass an explicit ``sha256_map`` only for self-generated asset trees
    (e.g. re-exported weights hashed via :func:`generate_sha256_map`).
    """
    if sha256_map is None:
        sha256_map = trusted_sha256_map()
    ok = True
    for rel in ASSET_FILES:
        if not check_asset(base_dir, rel, sha256_map.get(_map_key(rel))):
            ok = False
    return ok
