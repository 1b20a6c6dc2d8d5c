"""Checkpoint I/O: reference safetensors -> parameter trees of CPU tensors
(port of ``chattts_tpu/utils/io.py``).

The reference ships five torch safetensors checkpoints and an HF-format GPT
directory.  This module reads and writes the safetensors format itself, on
numpy alone: an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets"}}`` (plus ``__metadata__``), then
the raw bytes.  F64, F32, F16 and the integer and bool types are read and
written as numpy arrays.  numpy has no bfloat16, so a BF16 tensor is read as
its uint16 bits and handed on as a ``torch.bfloat16`` tensor of those bits:
the leaves the JAX package's loader gives (its process has numpy's bfloat16
registered by ``ml_dtypes``).  Every function below takes both kinds.

Per-module key maps (``models/*``) say where each checkpoint tensor goes:
``tree_path -> (torch_key, transform)``, the transform turning torch's
layouts into the trees' (convs to (k, in, out), linears to (in, out)).
Leaves come out as CPU tensors in the dtype ``jnp.asarray`` gives the JAX
package with 64-bit types off: float64 becomes float32, int64 int32, bf16
stays bf16.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 << 20  # the safetensors format's own bound on the header


def _np_dtype(name: str, key: str) -> np.dtype:
    if name == "BF16":  # its bits; load_safetensors makes the bf16 tensor
        return np.dtype("<u2")
    if name not in _DTYPES:
        raise TypeError(f"safetensors dtype {name} of tensor {key!r} is not "
                        "read: numpy has no such type")
    return np.dtype(_DTYPES[name]).newbyteorder("<")


def load_safetensors(path: str) -> Dict[str, object]:
    """A safetensors file -> {name: numpy array}, in the file's dtypes; a
    BF16 tensor comes as a ``torch.bfloat16`` tensor over its bits.

    The data is read once into one buffer; the arrays are views of it.
    Raises ``TypeError`` for a dtype neither can hold (F8) and
    ``ValueError`` for a header or offsets that do not fit the file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        header = json.loads(f.read(n))
        buf = np.fromfile(f, dtype=np.uint8)
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dt = _np_dtype(info["dtype"], key)
        shape = tuple(int(s) for s in info["shape"])
        lo, hi = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= lo <= hi <= buf.size or hi - lo != count * dt.itemsize:
            raise ValueError(f"{path}: tensor {key!r} offsets {lo}..{hi} do "
                             f"not hold {info['dtype']} {list(shape)} in "
                             f"{buf.size} data bytes")
        arr = (np.frombuffer(buf, dtype=dt, count=count, offset=lo)
               if count else np.zeros(0, dt)).reshape(shape)
        if info["dtype"] == "BF16":
            arr = torch.from_numpy(arr.astype(np.uint16)).view(
                torch.bfloat16)
        out[key] = arr
    return out


def save_safetensors(path: str, tensors: Mapping[str, object]) -> None:
    """{name: array} -> a safetensors file that ``safetensors`` reads.
    Tensors are laid out widest dtype first, then by name, so each starts
    aligned to its element size.  A dtype with no name here (bfloat16 among
    them) raises ``TypeError``."""
    arrays = {k: np.asarray(v, order="C") for k, v in tensors.items()}
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header: dict = {}
    offset = 0
    for k in order:
        a = arrays[k]
        name = _NAMES.get(a.dtype.newbyteorder("="))
        if name is None:
            raise TypeError(f"tensor {k!r}: dtype {a.dtype} has no "
                            "safetensors name here")
        header[k] = {"dtype": name, "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            f.write(arrays[k].astype(arrays[k].dtype.newbyteorder("<"),
                                     copy=False).tobytes())


def as_torch(arr) -> torch.Tensor:
    """A numpy array or a tensor (a bf16 leaf) -> a tensor over the same
    memory, in the same dtype."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.asarray(arr))


def to_tensor(arr) -> torch.Tensor:
    """A numpy array or a tensor -> a contiguous CPU tensor of its own, in
    the dtype ``jnp.asarray`` gives with 64-bit types off."""
    t = as_torch(arr)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.contiguous().clone()


def _transform(arr, how: str):
    if how == "":
        return arr
    if how == "T":  # torch Linear (out, in) -> (in, out)
        return arr.T
    if how == "C":  # torch Conv1d (out, in, k) -> (k, in, out)
        return as_torch(arr).permute(2, 1, 0)
    if how == "D":  # torch depthwise Conv1d (dim, 1, k) -> (k, 1, dim)
        return as_torch(arr).permute(2, 1, 0)
    if how == "SQUEEZE":
        return arr.reshape(-1)
    raise ValueError(f"unknown transform {how!r}")


def set_path(tree, path: str, value):
    """Set ``a/b/0/c``-style path in a nested dict/list tree."""
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    last = keys[-1]
    if isinstance(node, (list, tuple)):
        node[int(last)] = value
    else:
        node[last] = value


def get_path(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return node


def apply_key_map(
    params: dict,
    state: Mapping[str, object],
    key_map: Dict[str, Tuple[str, str]],
) -> dict:
    """Fill ``params`` (in place) from a torch state dict using ``key_map``;
    each leaf is checked against the template's shape and becomes a tensor
    through :func:`to_tensor`.  Any missing key raises ``KeyError``."""
    missing = []
    for tree_path, (torch_key, how) in key_map.items():
        if torch_key not in state:
            # torch weight_norm parametrizations store two tensors; handled
            # by fold_weight_norm before we get here.
            missing.append(torch_key)
            continue
        arr = _transform(as_torch(state[torch_key]), how)
        expected = get_path(params, tree_path)
        if expected is not None and tuple(expected.shape) != tuple(arr.shape):
            raise ValueError(
                f"shape mismatch at {tree_path}: checkpoint "
                f"{tuple(arr.shape)} vs "
                f"model {tuple(expected.shape)}"
            )
        set_path(params, tree_path, to_tensor(arr))
    if missing:
        raise KeyError(f"missing checkpoint keys: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    return params


def _float64(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float64).numpy()
    return np.asarray(arr, dtype=np.float64)


def fold_weight_norm(state: Mapping[str, object]) -> Dict[str, object]:
    """Fold torch ``weight_norm`` parametrizations into plain weights.

    The reference Embed heads are weight-normed; their checkpoints carry
    ``<name>.parametrizations.weight.original0`` (g) and ``...original1``
    (v) with ``weight = g * v / ||v||`` (norm over dim 1+), computed here in
    float64 and cast back to the checkpoint's dtype.  A bf16 weight is
    rounded from float64 through float32, as ``ml_dtypes`` rounds it for
    the JAX package (1 + 2^-8 + 2^-30 becomes 1.0), and torch's cast does.
    """
    out = dict(state)
    for key in list(state.keys()):
        marker = ".parametrizations.weight.original0"
        if key.endswith(marker):
            base = key[: -len(marker)]
            g = _float64(state[key])
            v = _float64(state[base + ".parametrizations.weight.original1"])
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
            w = g * v / norm
            out[base + ".weight"] = (
                torch.from_numpy(w).to(state[key].dtype)
                if isinstance(state[key], torch.Tensor)
                else w.astype(state[key].dtype))
            del out[key]
            del out[base + ".parametrizations.weight.original1"]
    return out


def find_assets_dir(custom_path: str | None = None) -> str | None:
    """Locate a ChatTTS asset directory: ``custom_path``, then the
    ``CHATTTS_ASSETS`` environment variable, then ``./asset``.  Returns the
    directory that holds ``asset/``, or None."""
    candidates = []
    if custom_path:
        candidates.append(custom_path)
    env = os.environ.get("CHATTTS_ASSETS")
    if env:
        candidates.append(env)
    candidates.append(os.path.join(os.getcwd(), "asset"))
    for c in candidates:
        probe = c if os.path.basename(c) == "asset" else os.path.join(c, "asset")
        if os.path.isfile(os.path.join(probe, "Embed.safetensors")):
            return os.path.dirname(probe)
    return None
