"""Find the knee of a streaming cell: the highest arrival rate whose backlog
does not grow over the window.

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds <s> \
        --rates 2,4,6,8 [--config-file <file> --workload-file <file>]

runs the cell's mix at each rate in turn, on one service built once, and
prints a line per rate: the requests due and finished, time to first
audio and chunk gaps (p50, p95), and the backlog (requests waiting for a
slot, sampled every quarter second) at the window's middle and end with
its slope over the second half.  A streaming cell's rate is set below
the knee once, by hand, in its workload file; nothing reads this tool's
output.  A mix that is no cell yet is named by its files.
"""

import argparse
import importlib
import json
import os
import sys
import threading
import time

import run as bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--config-file", default=None)
    p.add_argument("--workload-file", default=None)
    a = p.parse_args(argv)
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        _, config, workload = bench.cell_spec(
            json.load(f), a.workload, a.config_file, a.workload_file)
    bench.caches_in_checkout()
    sys.path.insert(1, bench.ROOT)
    import numpy as np
    import torch

    from harness import program, weights
    from harness.session import Session
    from drivers import stream

    if a.device == "cuda" and not torch.cuda.is_available():
        bench.fail("no CUDA device")
    s = Session(name=a.workload, seed=a.seed, seconds=a.seconds,
                traced=False, device=torch.device(a.device), config=config,
                workload=workload)
    s.weights = weights.draw(config, a.seed, s.device)
    stream.setup(s)
    gap = importlib.import_module("metrics.chunk_gap_p95_ms")
    for rate in [float(r) for r in a.rates.split(",")]:
        s.workload = dict(workload, traffic=dict(workload["traffic"],
                                                 rate=rate))
        s.records, s.outputs = [], program.Outputs()
        stream.plan(s)
        samples, stop = [], threading.Event()

        def watch():
            while not stop.is_set():
                if s.t0 is not None:
                    st = s.state["service"].stats()["code"]
                    samples.append((s.now(), st["waiting"],
                                    st["slots_busy"]))
                time.sleep(0.25)

        w = threading.Thread(target=watch, daemon=True)
        w.start()
        stream.run(s)
        stop.set()
        w.join()
        t = np.asarray([x[0] for x in samples if x[0] <= s.seconds])
        q = np.asarray([x[1] for x in samples if x[0] <= s.seconds], float)
        half = t >= s.seconds / 2
        slope = (float(np.polyfit(t[half], q[half], 1)[0])
                 if half.sum() > 2 else float("nan"))
        ttfa = [1e3 * ((r.first if r.first is not None else s.window_s)
                       - r.due) for r in s.records]
        done = sum(r.end is not None for r in s.records)
        print(json.dumps({
            "rate": rate, "due": len(s.records), "finished": done,
            "ttfa_p50_ms": float(np.percentile(ttfa, 50)),
            "ttfa_p95_ms": float(np.percentile(ttfa, 95)),
            "chunk_gap_p95_ms": gap.read(s),
            "waiting_mid": float(q[np.argmin(abs(t - s.seconds / 2))]),
            "waiting_end": float(q[-1]), "waiting_slope_per_s": slope,
            "busy_slots_mean": float(np.mean([x[2] for x in samples]))}),
            flush=True)
    stream.teardown(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
