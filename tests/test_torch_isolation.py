"""The port stands alone: no JAX, no chattts_tpu, and CUDA by default.

The import check reads the source (AST), not ``sys.modules``: the test
process has JAX loaded already, and so may any interpreter here.
"""

import ast
from pathlib import Path

import pytest
import torch

import chattts_tpu_torch
from chattts_tpu_torch import Chat
from chattts_tpu_torch.weights import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chattts_tpu")


def _port_files():
    files = sorted((REPO / "chattts_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 10
    assert {"kv_quant.py", "threefry.py", "batching.py", "decode_step.py",
            "streaming.py", "serving.py", "api_server.py", "audio.py",
            "logger.py", "seeder.py", "train.py", "checkpoint.py",
            "comm.py", "mesh.py", "graft_entry.py", "exporter.py",
            "stream_player.py", "chip_smoke.py"} <= {p.name
                                                          for p in files}
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_port_keeps_its_own_resources():
    res = Path(chattts_tpu_torch.__file__).parent / "res"
    assert (res / "spk_stat.b14").exists()
    assert (res / "homophones_map.json").exists()
    assert (res / "sha256_map.json").exists()
    assert (Path(chattts_tpu_torch.__file__).parent / "csrc"
            / "decode_step.cu").exists()


# packages the JAX package reads checkpoints and tokenizers with; the port
# reads both formats itself
LOADER_PACKAGES = ("safetensors", "transformers", "tokenizers",
                   "huggingface_hub", "tqdm")


# the modules that may import one of them, inside the call that needs it:
# ``Chat.download_models(source="huggingface")``, and the progress bar,
# which draws with tqdm where it is installed and nothing where not
OPTIONAL_IMPORTS = {"huggingface_hub": "core.py", "tqdm": "progress.py"}


def test_port_imports_no_loader_package():
    """Only ``Chat.download_models(source="huggingface")`` may import
    ``huggingface_hub`` and only ``utils/progress.py`` ``tqdm``, each inside
    the call."""
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in LOADER_PACKAGES and OPTIONAL_IMPORTS.get(top) != \
                    path.name:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_loading_a_tree_pulls_in_no_reference_or_loader_package(
        tiny_config, tmp_path):
    """In a fresh interpreter: import the port, read a tree with
    ``_load_assets`` and run its tokenizer; none of JAX, chattts_tpu or the
    loader packages is imported on the way (tqdm aside: torch itself may
    import it)."""
    import json
    import subprocess
    import sys

    import numpy as np

    from torch_port_utils import port_config, write_tiny_tree

    write_tiny_tree(str(tmp_path), tiny_config, np.float32,
                    np.random.default_rng(0))
    g = port_config(tiny_config).gpt
    script = f"""
import json, sys
before = set(sys.modules)
from chattts_tpu_torch import Chat
from chattts_tpu_torch import config as C
cfg = eval({repr(repr(port_config(tiny_config)))}, vars(C))
chat = Chat(config=cfg)
chat._load_assets(sys.argv[1], device="cpu")
ids = chat.tokenizer.encode(["[Stts]hello, world[uv_break]"], {g.num_vq})[0]
assert chat.has_loaded() and ids.size
new = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in {json.dumps(list(FORBIDDEN + LOADER_PACKAGES[:4]))})
print(json.dumps(new))
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cuda_sources_stand_alone():
    """Every CUDA source has a plain C interface: it includes no PyTorch or
    pybind header (those take minutes to compile) and no header of a package
    of finished kernels, and holds every kernel the wrappers launch."""
    import re

    csrc = Path(chattts_tpu_torch.__file__).parent / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert [p.name for p in sources] == ["decode_step.cu"]
    for path in sources:
        text = path.read_text()
        includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', text)
        assert set(includes) <= {"cuda_runtime.h", "cuda_bf16.h", "stdint.h"}
        assert 'extern "C"' in text
    text = (csrc / "decode_step.cu").read_text()
    for kernel in ("gemv_kernel", "attend_scores_kernel",
                   "attend_values_kernel", "kv4_append_kernel",
                   "decode_step_launch", "decode_step_attend"):
        assert kernel in text
    assert "rope_append_attend_kernel" not in text  # replaced by the pair
    for tier in ("W_INT8", "W_INT4", "KV_INT8", "KV_INT4"):
        assert tier in text


def test_port_pyproject_packages_complete():
    """The port's own pyproject.toml lists every subpackage and ships its
    resources and CUDA sources (a missing entry breaks the installed
    package)."""
    import tomllib

    pkg = REPO / "chattts_tpu_torch"
    cfg = tomllib.loads((pkg / "pyproject.toml").read_text())
    listed = set(cfg["tool"]["setuptools"]["packages"])
    found = {"chattts_tpu_torch"} | {
        f"chattts_tpu_torch.{p.parent.name}" for p in pkg.glob("*/__init__.py")}
    assert listed == found
    data = cfg["tool"]["setuptools"]["package-data"]["chattts_tpu_torch"]
    for sub, pattern in (("res", "*"), ("csrc", "*.cu")):
        for f in (pkg / sub).glob(pattern):
            assert any(f.match(g.split("/")[-1]) for g in data
                       if g.startswith(f"{sub}/")), f.name


def test_entry_points_default_to_cuda(tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Chat().load(source="random", seed=0)
    assert resolve_device("cpu").type == "cpu"
