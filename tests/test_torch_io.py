"""``chattts_tpu_torch.utils.io`` and ``utils.checkpoint`` against the
``safetensors`` package and ``chattts_tpu.utils.io``.

The port reads and writes safetensors on numpy alone; here ``safetensors``
(which the port never imports) is the oracle for both directions.  The
transforms, the key-map application and its errors, the weight-norm fold
and the asset-directory search are held to the JAX package's functions.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file, save_file

from chattts_tpu.utils import io as jio
from chattts_tpu_torch.utils import checkpoint as tck
from chattts_tpu_torch.utils import io as tio


def _arrays(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i32": rng.integers(-9, 9, (2, 2, 3)).astype(np.int32),
        "i64": rng.integers(-2**40, 2**40, (4,)).astype(np.int64),
        "f64": rng.standard_normal((2, 3)),
        "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
        "i8": rng.integers(-128, 127, (3,)).astype(np.int8),
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "scalar_f32": np.array(1.5, np.float32),
        "scalar_i64": np.array(-3, np.int64),
        "empty_f32": np.zeros((0, 4), np.float32),
        "empty_i32": np.zeros((0,), np.int32),
    }


def test_reader_matches_safetensors(tmp_path, rng):
    arrays = _arrays(rng)
    path = str(tmp_path / "a.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    want = load_file(path)
    got = tio.load_safetensors(path)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_writer_is_read_by_safetensors(tmp_path, rng):
    arrays = _arrays(rng)
    tensors = dict(arrays, torch_f32=torch.arange(6.0).reshape(2, 3),
                   strided=arrays["f32"].T)
    path = str(tmp_path / "b.safetensors")
    tio.save_safetensors(path, tensors)
    got = load_file(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with safe_open(path, framework="np") as f:
        assert f.metadata() is None
    # and the port reads its own file back
    back = tio.load_safetensors(path)
    for k in tensors:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)


def test_bf16_raises_as_safetensors_numpy_does(tmp_path):
    """A BF16 tensor raises a TypeError naming it, as ``safetensors.numpy``
    does in a process where numpy has no bfloat16 (run here in a fresh
    interpreter).  The JAX package's own process registers bfloat16 with
    numpy (ml_dtypes, imported by JAX), so its loader reads the tensor as
    bf16: a known difference (ROADMAP Queue 3)."""
    import subprocess
    import sys

    from safetensors.torch import save_file as save_torch

    path = str(tmp_path / "bf16.safetensors")
    save_torch({"w": torch.ones(3, dtype=torch.bfloat16),
                "ok": torch.ones(2)}, path)
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; from safetensors.numpy import "
         "load_file; load_file(sys.argv[1])", path],
        capture_output=True, text=True, timeout=120)
    assert probe.returncode != 0 and "TypeError" in probe.stderr
    with pytest.raises(TypeError, match="BF16"):
        tio.load_safetensors(path)
    assert str(jio.load_safetensors(path)["w"].dtype) == "bfloat16"
    with pytest.raises(TypeError, match="(?i)bfloat16"):
        tio.save_safetensors(str(tmp_path / "x.safetensors"),
                             {"w": torch.ones(2, dtype=torch.bfloat16)})


def test_reader_rejects_offsets_that_do_not_fit(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(16))
    with pytest.raises(ValueError, match="offsets"):
        tio.load_safetensors(str(path))


@pytest.mark.parametrize("how,shape", [("", (3, 4)), ("T", (3, 4)),
                                       ("C", (5, 3, 2)), ("D", (6, 1, 7)),
                                       ("SQUEEZE", (1, 9, 1))])
def test_transforms_match_jax(rng, how, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(tio._transform(a, how),
                                  jio._transform(a, how))
    assert tio._transform(a, how).shape == jio._transform(a, how).shape


def test_unknown_transform_raises():
    with pytest.raises(ValueError, match="unknown transform"):
        tio._transform(np.zeros(2), "X")


def test_paths_match_jax():
    for mod in (tio, jio):
        tree = {"a": [{"b": 1}, {"b": 2}], "c": {"d": 3}}
        mod.set_path(tree, "a/1/b", 5)
        mod.set_path(tree, "c/d", 7)
        assert mod.get_path(tree, "a/1/b") == 5
        assert tree == {"a": [{"b": 1}, {"b": 5}], "c": {"d": 7}}


def _errors(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("fault", ["missing", "many_missing", "shape"])
def test_apply_key_map_errors_match_jax(rng, fault):
    """Missing keys raise KeyError and a wrong shape ValueError, with the
    JAX package's texts."""
    key_map = {f"l/{i}/w": (f"layer.{i}.weight", "T") for i in range(10)}
    state = {f"layer.{i}.weight": rng.standard_normal((4, 3)).astype(
        np.float32) for i in range(10)}
    if fault == "missing":
        del state["layer.3.weight"]
    elif fault == "many_missing":
        state = {}
    else:
        state["layer.5.weight"] = state["layer.5.weight"].T

    def tmpl(zeros):
        return {"l": [{"w": zeros((3, 4))} for _ in range(10)]}

    got = _errors(lambda: tio.apply_key_map(tmpl(torch.zeros), state,
                                            key_map))
    want = _errors(lambda: jio.apply_key_map(tmpl(np.zeros), state, key_map))
    assert got is not None and got == want


def test_apply_key_map_leaves_are_jax_dtypes(rng):
    state = {"a": rng.standard_normal((2, 3)),                  # f64
             "b": rng.integers(0, 9, (3,)).astype(np.int64),
             "c": rng.standard_normal((3, 2)).astype(np.float16)}
    key_map = {"a": ("a", "T"), "b": ("b", ""), "c": ("c", "")}
    got = tio.apply_key_map({"a": None, "b": None, "c": None}, state,
                            key_map)
    want = jio.apply_key_map({"a": None, "b": None, "c": None}, state,
                             key_map)
    for k in key_map:
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
        assert got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_fold_weight_norm_matches_jax(rng, dtype):
    state = {"emb.weight": rng.standard_normal((5, 3)).astype(dtype)}
    for name, shape in (("head", (11, 6)), ("conv", (4, 3, 2))):
        v = rng.standard_normal(shape).astype(dtype)
        g = rng.uniform(0.5, 2, (shape[0],) + (1,) * (len(shape) - 1))
        state[f"{name}.parametrizations.weight.original0"] = g.astype(dtype)
        state[f"{name}.parametrizations.weight.original1"] = v
    got, want = tio.fold_weight_norm(state), jio.fold_weight_norm(state)
    assert set(got) == set(want) == {"emb.weight", "head.weight",
                                     "conv.weight"}
    for k in want:
        assert got[k].dtype == want[k].dtype == dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_find_assets_dir_matches_jax(tmp_path, monkeypatch):
    def tree(name):
        d = tmp_path / name / "asset"
        d.mkdir(parents=True)
        (d / "Embed.safetensors").write_bytes(b"x")
        return str(tmp_path / name)

    custom, env, cwd = tree("custom"), tree("env"), tree("cwd")
    monkeypatch.delenv("CHATTTS_ASSETS", raising=False)
    monkeypatch.chdir(tmp_path)  # no ./asset here
    assert tio.find_assets_dir(None) is None is jio.find_assets_dir(None)
    monkeypatch.chdir(cwd)
    for mod in (tio, jio):
        assert mod.find_assets_dir(None) == cwd
    monkeypatch.setenv("CHATTTS_ASSETS", env)
    for mod in (tio, jio):
        assert mod.find_assets_dir(None) == env
        assert mod.find_assets_dir(custom) == custom
        assert mod.find_assets_dir(os.path.join(custom, "asset")) == custom
        assert mod.find_assets_dir(str(tmp_path / "nowhere")) == env


def test_to_tensor_takes_jax_dtypes():
    import jax.numpy as jnp

    for a in (np.zeros(3), np.zeros(3, np.int64), np.zeros(3, np.float16),
              np.zeros(3, np.int32), np.zeros(3, np.uint8)):
        assert str(tio.to_tensor(a).dtype) == f"torch.{jnp.asarray(a).dtype}"


def _tree(rng):
    return {"layers": [{"w": torch.from_numpy(rng.standard_normal(
                            (4, 3)).astype(np.float32)).to(torch.bfloat16),
                        "n": torch.from_numpy(rng.standard_normal(4).astype(
                            np.float32))} for _ in range(2)],
            "emb": torch.from_numpy(rng.standard_normal((5, 2)).astype(
                np.float32)),
            "ids": torch.arange(3, dtype=torch.int32)}


def test_checkpoint_round_trip(tmp_path, rng):
    src = _tree(rng)
    path = str(tmp_path / "p.safetensors")
    tck.save_params(path, src)
    assert load_file(path)["layers/0/w"].dtype == np.float32  # widened
    template = _tree(np.random.default_rng(99))
    got = tck.load_params(path, template)
    assert got is template
    for a, b in zip(tck._flatten(got).values(), tck._flatten(src).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_files_cross_with_jax(tmp_path, rng):
    """The JAX package reads the port's file and the port reads the JAX
    package's, leaf for leaf."""
    import jax.numpy as jnp

    from chattts_tpu.utils import checkpoint as jck

    src = _tree(rng)
    port_file = str(tmp_path / "port.safetensors")
    tck.save_params(port_file, src)
    jtemplate = {"layers": [{"w": jnp.zeros((4, 3), jnp.bfloat16),
                             "n": jnp.zeros(4)} for _ in range(2)],
                 "emb": jnp.zeros((5, 2)), "ids": jnp.zeros(3, jnp.int32)}
    jgot = jck.load_params(port_file, jtemplate)
    jax_file = str(tmp_path / "jax.safetensors")
    jck.save_params(jax_file, jgot)
    tgot = tck.load_params(jax_file, _tree(np.random.default_rng(7)))
    for a, b in zip(tck._flatten(tgot).values(), tck._flatten(src).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
