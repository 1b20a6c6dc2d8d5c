"""BENCHMARK.json against its contract, and every name in it resolved to
its files: each cell to its configuration, traffic mix and driver, each
metric to its reader.  What a metric is (unit, layer, what it moves, its
cells) is said in BENCHMARK.json alone."""

import importlib.util
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# widths: a key that names one may never be reduced
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                   r"head|expan|experts_per_tok)")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(path):
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert b["command"][1].startswith(tuple(b["paths"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys(kind):
    b = bench()
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    for e in b[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[kind] <= set(e) <= ENTRY_KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_every_name_is_unique_across_kinds_of_metric():
    b = bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in bench()["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench()["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    cfg = {c["name"]: c for c in b["configs"]}[w["config"]]
    assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert os.path.exists(os.path.join(ROOT, cfg["file"]))
    assert cfg["file"].startswith(tuple(p + "/" for p in b["paths"]))
    with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
        mix = json.load(f)
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       f"{mix['driver']}.py"))
    assert set(mix["limits"]) == {"logit_gap", "wav_rel_err"}
    reported = [m for m in b["end_to_end"]
                if cell in m.get("workloads", [cell])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])
    assert w["traffic"] == cell


def test_configurations_are_used_once_and_never_cut_in_width():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


def test_four_chip_cells_are_at_most_a_quarter():
    cells = bench()["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["end_to_end"]
                                    + bench()["per_layer"]])
def test_metric_resolves_to_its_reader(metric):
    mod = load(os.path.join(HERE, "metrics", f"{metric}.py"))
    assert callable(mod.read)


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_a_per_layer_metric_moves_a_metric_of_its_cells(metric):
    b = bench()
    entry = {m["name"]: m for m in b["per_layer"]}[metric]
    moved = {m["name"]: m for m in b["end_to_end"]}[entry["moves"]]
    cells = {w["name"] for w in b["workloads"]}
    for cell in entry.get("workloads", sorted(cells)):
        assert cell in cells
        assert cell in moved.get("workloads", [cell])


def test_layers_are_named_in_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in bench()["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_no_file_under_paths_is_named_outside_the_name_characters():
    for base, _, files in os.walk(HERE):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH.match(rel), rel

