"""Nothing the benchmark runs is JAX or the JAX package, and the reference
is independent of the program.  Module names are compared whole, by the
part before the first dot: the program's ``chattts_tpu_torch`` begins
with the JAX package's ``chattts_tpu`` and is not it."""

import ast
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "chattts_tpu"}
PROGRAM = "chattts_tpu_torch"


def imported(path):
    """Top-level names of every module a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources(HERE):
        assert not imported(path) & FORBIDDEN, path


def test_the_whole_name_is_compared():
    assert "chattts_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "chattts_tpu.core".split(".")[0] in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(HERE, "reference")):
        names = imported(path)
        assert PROGRAM not in names and not names & FORBIDDEN, path
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}


def test_a_dry_run_loads_no_jax():
    """The CPU dry run in a fresh interpreter, then the loaded modules."""
    code = (
        "import json, sys, runpy\n"
        "sys.argv = ['portbench/run.py', '--workload', 'gen-b8-bf16w-kv8',"
        " '--seed', '4294967297', '--seconds', '1', '--device', 'cpu',"
        " '--config-file', 'portbench/fixtures/tiny-config.json',"
        " '--workload-file', 'portbench/fixtures/tiny-gen.json']\n"
        "try:\n"
        "    runpy.run_path('portbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN
