"""Each configuration's family: that it resolves to a module with the whole
interface, that ChatTTS's family draws the weights the harness drew before
families existed, and that a configuration of a new family runs through
its own module when nothing but two files are added."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from harness import family, weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TINY = os.path.join(HERE, "fixtures", "tiny-config.json")
SEED = 18446744073709551629
# ``weights.draw`` of the tiny configuration at SEED on the CPU, hashed by
# ``digest`` below, on the harness as it stood before the weight layout
# moved into ``families/chattts.py`` (commit 9de33b6)
TINY_DIGEST = "ea16cc59672ec5c5d68b99f1cd4db008b6dd396576ea4b5d368a4f1c25fed957"


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from leaves(v, path + (k,))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from leaves(v, path + (i,))
    else:
        yield path, node


def digest(tree) -> str:
    """SHA-256 over every leaf's path and bytes, in path order."""
    h = hashlib.sha256()
    for path, leaf in sorted(leaves(tree), key=lambda x: x[0]):
        h.update("/".join(map(str, path)).encode())
        h.update(leaf.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_every_configuration_has_a_whole_family(name):
    entry = {c["name"]: c for c in bench()["configs"]}[name]
    cfg = config(entry["file"])
    fam = family.of(cfg)
    assert family.missing(fam) == []
    bf16, f32 = fam.specs(cfg)
    paths = [p for p, _, _, _ in bf16 + f32]
    assert bf16 and f32 and len(paths) == len(set(paths))
    for _, shape, _, std in bf16 + f32:
        assert shape and all(isinstance(n, int) and n > 0 for n in shape)
        assert std > 0
    sizes = fam.sizes(cfg)
    assert set(sizes) == {"speaker_dim", "num_audio_tokens",
                          "num_text_tokens"}
    assert all(isinstance(n, int) and n > 0 for n in sizes.values())
    wb = cfg["weight_bits"]
    lower = fam.lower_tier(wb)
    assert lower and (wb == 0 or lower < wb)
    assert isinstance(cfg["kv_bits"], int) and cfg["vocos"]["hop_length"]


def test_a_configuration_without_a_family_key_is_chatttss():
    assert "family" not in config(TINY)
    assert family.of(config(TINY)).__name__ == "families.chattts"


@pytest.mark.parametrize("name", ["nowhere", "../harness/weights", "a.b", 7])
def test_an_unknown_family_fails_plainly(name):
    with pytest.raises(family.Unknown, match="unknown family"):
        family.of({"family": name})


def test_an_incomplete_family_names_what_it_lacks():
    partial = types.SimpleNamespace(
        specs=len, load_chat=len, lower_tier=len,
        reference=types.SimpleNamespace(gaps=len, tf32_off=len))
    assert family.missing(partial) == [
        "sizes", "reference.request_reference", "reference.prompt_ids",
        "reference.penalized", "reference.relative_error"]


def test_the_weights_are_the_parents_bit_for_bit():
    tree = weights.draw(config(TINY), SEED, torch.device("cpu"))
    assert digest(tree) == TINY_DIGEST


# a family of its own that is ChatTTS's, and says on standard error what
# the harness called of it
PROBE = '''"""ChatTTS's family, reporting every call."""

import sys
import types

from families import chattts


def _told(name, fn):
    def call(*args, **kwargs):
        print(f"probe: {name}", file=sys.stderr, flush=True)
        return fn(*args, **kwargs)
    return call


specs = _told("specs", chattts.specs)
load_chat = _told("load_chat", chattts.load_chat)
lower_tier = _told("lower_tier", chattts.lower_tier)
sizes = _told("sizes", chattts.sizes)
reference = types.SimpleNamespace(**{
    n: _told("reference." + n, getattr(chattts.reference, n))
    for n in ("request_reference", "prompt_ids", "penalized", "gaps",
              "relative_error", "tf32_off")})
'''
ADDED = {os.path.join("families", "probe.py"),
         os.path.join("configs", "tiny-probe.json")}


def files(top):
    """{path under top: SHA-256} of every file, caches left out."""
    out = {}
    for base, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_a_new_family_needs_only_new_files(tmp_path):
    """A checkout of the benchmark with one family module and one
    configuration added, and nothing edited: its CPU dry run takes the
    weights, the program and the judge from the new family, and is
    correct."""
    ck = tmp_path / "checkout"
    shutil.copytree(HERE, ck / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), ck)
    os.symlink(os.path.join(ROOT, "chattts_tpu_torch"),
               ck / "chattts_tpu_torch")
    (ck / "portbench" / "families" / "probe.py").write_text(PROBE)
    (ck / "portbench" / "configs" / "tiny-probe.json").write_text(
        json.dumps(dict(config(TINY), family="probe"), indent=1))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gen-b8-bf16w-kv8", "--seed", "4294967311", "--seconds", "3",
         "--device", "cpu", "--config-file", "portbench/configs/"
         "tiny-probe.json", "--workload-file",
         "portbench/fixtures/tiny-gen.json"], cwd=ck, capture_output=True,
        text=True, timeout=900, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, out.stderr[-2000:]
    called = {ln.split(": ", 1)[1] for ln in out.stderr.splitlines()
              if ln.startswith("probe: ")}
    assert {"specs", "load_chat", "sizes", "reference.tf32_off",
            "reference.request_reference", "reference.penalized",
            "reference.gaps", "reference.relative_error"} <= called, called
    before, after = files(HERE), files(ck / "portbench")
    assert set(after) == set(before) | ADDED
    assert {k: after[k] for k in before} == before
