"""The benchmark's engine, driven by data.

Everything that belongs to one configuration, cell or metric sits in a
file of its own and is found by its name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: a deployment (the ``file`` of its
  entry in ``BENCHMARK.json``);
- ``benchmark/workloads/<cell>.json``: the cell's job kind and its
  parameters;
- ``benchmark/jobs/<job>.py``: one job driver a kind, a class ``Job``
  (set-up in its constructor, ``warm()``, ``run()`` one job of the
  window, ``phases(record)``, ``check(records)`` after it,
  ``kernel_bounds()``, ``control()``);
- ``benchmark/metrics/<metric>.py``: one reader a metric,
  ``read(ctx) -> float | None`` (None: nothing to read, left out).

A run: set-up (inputs from the seed, one warm job on a few genomes), then
jobs back to back until ``seconds`` have passed (the last one finishes;
no partial job is counted), then the check against the plain reference.
With ``trace`` the window runs under ``torch.profiler``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from benchmark import tracing
from benchmark.roofline.mash import bound_seconds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "drep_tpu")


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    spec: dict  # BENCHMARK.json
    workload: dict  # workloads/<cell>.json
    config: dict  # the configuration's file

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, kind: str) -> list[dict]:
        """The `kind` ('end_to_end' or 'per_layer') metrics this cell
        reports: those that list it or list no cells."""
        return [m for m in self.spec[kind] if self.name in m.get("workloads", [self.name])]


def load_module(path: str, name: str):
    """A file of the benchmark, imported by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "workloads", f"{name}.json")) as f:
        workload = json.load(f)
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {workload[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(name, entry, spec, workload, config)


def job_class(cell: Cell, root: str = ROOT):
    kind = cell.workload["job"]
    return load_module(os.path.join(root, "benchmark", "jobs", f"{kind}.py"), f"bench_job_{kind}").Job


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmark", "metrics", f"{name}.py"), f"bench_metric_{name}").read


@dataclass
class RunResult:
    result: dict  # the last line's object
    checks: dict = field(default_factory=dict)
    ok: bool = False
    records: list = field(default_factory=list)  # one a job of the window


def _finite(x):
    """A number as JSON can hold it (a non-finite reading as 1e300)."""
    return x if isinstance(x, int) or math.isfinite(x) else 1e300


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
             root: str = ROOT) -> RunResult:
    """One run of `cell` (module docstring). `t_start` is the process's
    start on the host clock (set-up runs from it to the window)."""
    job = job_class(cell, root)(cell.config, cell.workload["params"], seed, device)
    job.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    records: list[dict] = []
    failed = 0
    prof = tracing.Profiled(device) if trace else None
    if prof is not None:
        prof.__enter__()
    w0 = time.perf_counter()
    w1 = w0
    try:
        while w1 - w0 < seconds:
            with tracing.span("job"):
                try:
                    t = time.perf_counter()
                    rec = job.run()
                    rec["job_s"] = time.perf_counter() - t
                    records.append(rec)
                except Exception:  # noqa: BLE001 — the run reports it and is not correct
                    traceback.print_exc()
                    failed += 1
            w1 = time.perf_counter()
            if failed:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    window_s = w1 - w0
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = job.check(records) if records else {}
    from benchmark.reference.check import verdict

    ok, checks = verdict(values)
    ok = ok and not failed and bool(records) and len(checks) == len(values)

    ctx = {"records": records, "window_s": window_s, "setup_s": setup_s, "timeline": None,
           "kernel_bounds": {}, "cell": cell}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    breakdown = None
    if prof is not None:
        tl = prof.timeline(refine=lambda spans: split_phases(spans, records, job))
        ctx["timeline"] = tl
        ctx["kernel_bounds"] = {k: bound_seconds(*v)[0] for k, v in job.kernel_bounds().items()}
        device_info.update(busy_s=tl.busy_s, window_s=tl.window_s)
        breakdown = {
            "device_ops": [[k, v] for k, v in sorted(tl.device_ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in tl.gaps[:10]],
        }
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": len(records) + failed, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return RunResult(result, checks, ok, records)


def split_phases(spans: list, records: list[dict], job) -> list:
    """The harness's spans plus each job's host phases (the job driver's
    ``phases(record)``: (layer, seconds) in the order they ran), laid end
    to end from the job's start, so an idle gap is labelled by the layer
    the host was in."""
    out = list(spans)
    jobs = [s for s in spans if s[0] == "job"]
    for (_, a, b), rec in zip(jobs, records):
        t = a
        for name, secs in job.phases(rec):
            out.append((name, t, min(b, t + secs * 1e6)))
            t += secs * 1e6
    return out


def modules_forbidden() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (compared whole: ``drep_tpu_torch`` is not ``drep_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_TOP})
