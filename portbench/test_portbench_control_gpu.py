"""The control on the card: each cell run at its own size on three seeds,
once as it is and once with the reference one weight tier below the
configuration's judged in the program's place (``--control 1``).  The
program's run comes out correct and the control's not correct, both by
the harness's own comparison.  Needs the card: run on it with
``python -m pytest -m gpu portbench/``."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEEDS = (2 ** 31 + 11, 2 ** 40 + 7, 3 * 10 ** 12 + 1)


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def run(cell, seed, control):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "8", "--trace", "0", "--control",
         str(control)], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", cells())
def test_the_program_is_correct_and_the_control_is_not(cell, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, err = run(cell, seed, 0)
    assert res["correct"] is True, err[-2000:]
    res, err = run(cell, seed, 1)
    assert res["correct"] is False, err[-2000:]
    assert any(v > limit for v, limit in res["checks"].values()), res
