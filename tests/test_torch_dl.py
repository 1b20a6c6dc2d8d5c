"""``chattts_tpu_torch.utils.dl`` and ``utils.native`` against
``chattts_tpu.utils.dl``: the vendored trusted map, its key format, and
verification of a synthetic tree (refused by the trusted map, passed by its
own, failed by one flipped byte)."""

import hashlib
import shutil
from pathlib import Path

import numpy as np
import pytest

from chattts_tpu.utils import dl as jdl
from chattts_tpu.utils import native as jnative
from chattts_tpu_torch.utils import dl as tdl
from chattts_tpu_torch.utils import native as tnative

REPO = Path(__file__).resolve().parents[1]


def test_vendored_map_is_byte_identical():
    ours = (REPO / "chattts_tpu_torch" / "res" / "sha256_map.json").read_bytes()
    assert ours == (REPO / "chattts_tpu" / "res" / "sha256_map.json").read_bytes()
    assert tdl.trusted_sha256_map() == jdl.trusted_sha256_map()
    assert set(tdl.trusted_sha256_map()) == {tdl._map_key(r)
                                             for r in tdl.ASSET_FILES}


def test_asset_files_and_map_keys_match_jax():
    assert tdl.ASSET_FILES == jdl.ASSET_FILES
    for rel in tdl.ASSET_FILES + ["asset/a/b.c.d"]:
        assert tdl._map_key(rel) == jdl._map_key(rel)


@pytest.mark.parametrize("size", [0, 5, (1 << 20), (1 << 20) + 17])
def test_sha256_file_matches_hashlib_and_jax(tmp_path, size):
    data = np.random.default_rng(size).integers(0, 256, size,
                                                np.uint8).tobytes()
    p = tmp_path / "f.bin"
    p.write_bytes(data)
    assert tnative.sha256_file(str(p)) == hashlib.sha256(data).hexdigest()
    assert tnative.sha256_file(str(p)) == jnative.sha256_file(str(p))


@pytest.fixture()
def fake_tree(tmp_path):
    rng = np.random.default_rng(0)
    for rel in tdl.ASSET_FILES:
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rng.integers(0, 256, 1000, np.uint8).tobytes())
    return tmp_path


def test_trusted_map_refuses_a_synthetic_tree(fake_tree):
    assert tdl.check_all_assets(str(fake_tree)) is False
    assert jdl.check_all_assets(str(fake_tree)) is False


def test_own_map_passes_and_a_flipped_byte_fails(fake_tree, tmp_path_factory):
    own = tdl.generate_sha256_map(str(fake_tree))
    assert own == jdl.generate_sha256_map(str(fake_tree))
    assert len(own) == len(tdl.ASSET_FILES)
    assert tdl.check_all_assets(str(fake_tree), sha256_map=own)
    copy = tmp_path_factory.mktemp("flipped")
    shutil.copytree(fake_tree, copy, dirs_exist_ok=True)
    victim = copy / "asset" / "gpt" / "model.safetensors"
    data = bytearray(victim.read_bytes())
    data[500] ^= 1
    victim.write_bytes(bytes(data))
    assert not tdl.check_all_assets(str(copy), sha256_map=own)
    assert not jdl.check_all_assets(str(copy), sha256_map=own)


def test_missing_file_or_checksum_fails(fake_tree):
    own = tdl.generate_sha256_map(str(fake_tree))
    (fake_tree / "asset" / "Vocos.safetensors").unlink()
    assert not tdl.check_asset(str(fake_tree), "asset/Vocos.safetensors",
                               own["sha256_asset_Vocos_safetensors"])
    assert not tdl.check_asset(str(fake_tree), "asset/DVAE.safetensors", None)
    assert "sha256_asset_Vocos_safetensors" not in tdl.generate_sha256_map(
        str(fake_tree))
