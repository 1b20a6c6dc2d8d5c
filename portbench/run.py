"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1] [--device cpu]

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; it names a configuration (``portbench/configs/``), and
its traffic mix (``portbench/workloads/<name>.json``) names the driver
(``portbench/drivers/<driver>.py``) that runs it.  The configuration's
family (``portbench/families/<name>.py``, named by its ``"family"`` key)
gives the weight layout, the program's loader and the plain reference.
Each metric is read by its own reader (``portbench/metrics/<metric>.py``).
The run draws the weights and inputs from ``--seed``, builds the program
and warms up every shape its traffic uses (``setup_s``), measures for
``--seconds``, then compares a sample of what the window produced with
the family's plain reference (``portbench/reference/``) and prints one
JSON line last: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled stretch of the
window.

``--control 1`` judges the control in the program's place (the reference
one weight tier lower), so its run comes out not correct; the program's
own readings are printed beside it.  ``--device cpu`` is the dry run of
the tests: a tiny configuration on the CPU, no device metric.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "chattts_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot, so the port's own
    ``chattts_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, name: str, config_file=None, workload_file=None):
    """(cell entry, configuration, workload file) of a cell, by name; the
    dry run and the knee sweep may pass files of their own, and then a
    name that is no cell yet (one chip)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells and not (config_file and workload_file):
        fail(f"no workload {name!r} in BENCHMARK.json")
    cell = cells.get(name, {"name": name, "chips": 1})
    cfgs = {c["name"]: c for c in bench["configs"]}
    path = config_file or os.path.join(ROOT, cfgs[cell["config"]]["file"])
    with open(path) as f:
        config = json.load(f)
    with open(workload_file
              or os.path.join(HERE, "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    return cell, config, workload


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` that this cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metrics(entries: list, s) -> dict:
    out = {}
    for m in entries:
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "metric_" + m["name"].replace(".", "_"))
        value = reader.read(s)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e!r})"


def caches_in_checkout() -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths, so that only a checkout's first run builds."""
    build = os.path.join(ROOT, "build")
    os.environ["CHATTTS_TORCH_BUILD_DIR"] = os.path.join(build,
                                                         "chattts_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.pop("CHATTTS_PIPELINED_DECODE", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # load from one process with few threads: the host runs the decode
    # loop, and a CPU pool only contends with it
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--config-file", default=None,
                   help="another configuration file (the CPU dry run's)")
    p.add_argument("--workload-file", default=None,
                   help="another traffic mix (the CPU dry run's)")
    a = p.parse_args(argv)
    if a.seed < 0:
        fail("--seed must be a non-negative integer")
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_path):
        fail("no BENCHMARK.json at the checkout's root")
    with open(bench_path) as f:
        bench = json.load(f)
    cell, config, workload = cell_spec(bench, a.workload, a.config_file,
                                       a.workload_file)
    caches_in_checkout()
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    try:
        import torch
        import chattts_tpu_torch  # noqa: F401 - the program under test
    except ImportError as e:
        fail(f"cannot import the program: {e!r}")
    if a.device == "cuda":
        if not torch.cuda.is_available():
            fail("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            fail(f"{cell['name']} needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} found")
    elif a.trace:
        fail("a CPU dry run reads no device trace")
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    device = torch.device(a.device)

    from harness import family, judge, weights
    from harness.session import Session

    try:
        family.of(config)
    except family.Unknown as e:
        fail(str(e))

    driver = importlib.import_module("drivers." + workload["driver"])
    s = Session(name=a.workload, seed=a.seed, seconds=a.seconds,
                traced=bool(a.trace), device=device, config=config,
                workload=workload)
    s.weights = weights.draw(config, a.seed, device)
    driver.setup(s)
    s.tracer.prepare()
    if device.type == "cuda":
        torch.cuda.synchronize()
    # what set-up made lives to the end: out of the collector's passes, so
    # that a pass in the window costs the same whatever set-up left
    gc.collect()
    gc.freeze()
    s.setup_s = time.time() - PROCESS_START
    driver.run(s)
    dev = card(device)
    driver.teardown(s)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    attempted = len(s.records)
    failed = sum(not r.ok for r in s.records)
    samples = driver.judged(s)
    checks = judge.compare(s, samples, control=bool(a.control))
    ok = judge.correct(checks, s.counters["judged_requests"])
    kind = "per_layer" if a.trace else "end_to_end"
    # a CPU run measures no device: it prints no metric
    metrics = (read_metrics(metrics_of(bench, a.workload, kind), s)
               if device.type == "cuda" else {})
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if a.trace and s.tracer.trace is not None:
        from harness import trace

        tr = s.tracer.trace
        result["device"]["busy_s"] = trace.busy_s(tr)
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(tr),
                               "idle_gaps": trace.idle_gaps(tr)}
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}")
    s.say(f"card: {power_limit() if device.type == 'cuda' else 'cpu'}; "
          f"setup {s.setup_s!r} s, window {s.window_s!r} s, {attempted} "
          f"attempted, {failed} failed, judged "
          f"{s.counters['judged_requests']} requests of "
          f"{s.counters['judged_tokens']} tokens")
    result["checks"] = {k: [c["value"], c["limit"]]
                        for k, c in checks.items()}
    for k, c in checks.items():
        if "program" in c:
            s.say(f"program {k}: {c['program']!r} (the control's is judged)")
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
