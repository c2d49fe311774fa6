#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its job driver
and its metrics are found by name (benchmark/README.md). The last line on
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the same numbers are the last lines on standard error.

Exits nonzero, printing no result, where there is no CUDA device or fewer
than the cell asks for, where the program cannot be imported, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="draws the inputs (any whole number)")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: run the window under the profiler")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    try:
        import drep_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program under test is missing: {e}", file=sys.stderr)
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.modules_forbidden()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for i, rec in enumerate(run.records):
        print(f"job {i}: {json.dumps(rec)}", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(run.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
