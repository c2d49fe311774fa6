#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
computed one precision below the configuration's (bfloat16 distances for
its float32 ones), and judged by the comparison that decides
``correct``. It has to come out not correct. The benchmark's own runs do
not run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

prints one JSON line a seed: the seed and every number compared with its
limit, and whether the control passed (it must not).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.reference.check import verdict

    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    job_cls = harness.job_class(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        job = job_cls(cell.config, cell.workload["params"], seed, device)
        ok, checks = verdict(job.control())
        print(json.dumps({"workload": cell.name, "seed": seed, "control_correct": ok, "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
