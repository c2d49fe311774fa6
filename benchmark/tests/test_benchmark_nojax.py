"""The no-JAX guard: no file of the benchmark imports jax, jaxlib, flax or
the JAX package, none reads the JAX package's bench files, and a job
rehearsed on the CPU leaves none of them loaded. Top-level module names
are compared whole (``drep_tpu_torch`` is not ``drep_tpu``)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "drep_tpu"}
# the JAX package's benchmark script and result files, spelled apart so
# that this file does not name them itself
JAX_BENCH_FILES = ("bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_", "BASELINE" + ".json")


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    found = {p: _imported_tops(p) & FORBIDDEN for p in _sources()}
    assert not {p: t for p, t in found.items() if t}
    assert "drep_tpu_torch" in set().union(*(_imported_tops(p) for p in _sources()))


def test_no_benchmark_file_reads_the_jax_bench_files():
    me = os.path.abspath(__file__)
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            path = os.path.join(dirpath, f)
            if path == me or "__pycache__" in path:
                continue
            with open(path, errors="replace") as fh:
                text = fh.read()
            assert not [n for n in JAX_BENCH_FILES if n in text], path


def test_a_rehearsed_job_loads_no_jax():
    code = (
        "import sys, time, torch; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])\n"
        "from benchmark import harness\n"
        "from conftest import tiny\n"
        "cell = tiny(harness.load_cell('gtdb207_reps.primary'), 200)\n"
        "res = harness.run_cell(cell, 3, 1e-6, False, torch.device('cpu'), time.perf_counter())\n"
        "assert res.ok, res.result\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code, ROOT, os.path.dirname(os.path.abspath(__file__))],
                       capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = next(x for x in p.stdout.splitlines() if x.startswith("LOADED"))
    loaded = set(eval(line[len("LOADED "):]))  # noqa: S307 — our own child's list of names
    assert "drep_tpu_torch" in loaded and not loaded & FORBIDDEN
