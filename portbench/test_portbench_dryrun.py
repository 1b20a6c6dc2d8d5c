"""The CPU dry run of each driver: a whole run (set-up, window, the
comparison with the reference) on a tiny configuration, with no chip.  A
sound run comes out correct; a run with the timed path broken underneath
comes out not correct, once for each fault a cell can have: a decode step
that returns its state unchanged, and a token altered where it is
sampled.  The dry run prints no metric: it measures no device."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the cell each driver's dry run is named as; the streaming driver has no
# cell yet (PERF.md), so its run takes a name of its own
CELLS = {"gen": "gen-b8-bf16w-kv8", "stream": "serve-stream-dry",
         "sat": "serve-sat-int8w-kv4"}
FAULTS = {
    None: "",
    # the step hands back its input: the residual never moves
    "state unchanged": (
        "from chattts_tpu_torch.ops import decode_step as k1\n"
        "k1.decode_step = lambda packed, emb, *a, **k: emb.float()\n"),
    # every seventh sampling call serves other codes, in every row
    "token altered": (
        "from chattts_tpu_torch.ops import sampling\n"
        "inner, calls = sampling.sample, [0]\n"
        "def sample(*a, **k):\n"
        "    ids = inner(*a, **k)\n"
        "    calls[0] += 1\n"
        "    if calls[0] % 7 == 3:\n"
        "        ids = (ids + 1) % 625\n"
        "    return ids\n"
        "sampling.sample = sample\n"),
}


def dry_run(driver, fault=None, seconds="3", control="0"):
    code = (
        "import sys, runpy\n"
        f"sys.path[:0] = [{HERE!r}, {ROOT!r}]\n" + FAULTS[fault]
        + "sys.argv = ['portbench/run.py', '--workload', "
        f"{CELLS[driver]!r}, '--seed', '18446744073709551629', "
        f"'--seconds', {seconds!r}, '--control', {control!r}, "
        "'--device', 'cpu', '--config-file', "
        "'portbench/fixtures/tiny-config.json', '--workload-file', "
        f"'portbench/fixtures/tiny-{driver}.json']\n"
        "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("driver", sorted(CELLS))
def test_a_sound_dry_run_is_correct(driver):
    res, err = dry_run(driver)
    assert res["correct"] is True, err[-2000:]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    # the numbers compared, beside their limits, end standard error
    assert err.rstrip().splitlines()[-1].startswith("check wav_rel_err")


@pytest.mark.parametrize("fault", ["state unchanged", "token altered"])
@pytest.mark.parametrize("driver", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(driver, fault):
    res, err = dry_run(driver, fault)
    assert res["correct"] is False, err[-2000:]


def test_no_cuda_means_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS["gen"],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_control_is_judged_in_the_programs_place():
    """With ``--control 1`` the numbers compared are the control's, and
    ``correct`` is decided on them; the program's own stand before."""
    res, err = dry_run("gen", control="1")
    out = res["checks"]
    assert set(out) == {"logit_gap", "wav_rel_err"}
    assert res["correct"] is all(v <= limit for v, limit in out.values())
    plain, _ = dry_run("gen")
    assert [v for v, _ in out.values()] != [
        v for v, _ in plain["checks"].values()]
