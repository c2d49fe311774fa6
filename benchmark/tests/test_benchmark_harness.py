"""The harness rehearsed on the CPU at a tiny size: the last line, the
traced run, BENCHMARK.json against the files, cells, configurations and
metrics dropped in as files, and ``correct`` under the faults and the
control."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference.check import verdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
DENSE = "gtdb207_reps.primary"
# the dense cell's job under --primary_prune lsh at the CLI's defaults (no
# cell runs it; the job kind takes it as a parameter)
PRUNED = "pruned"


def _cell(tiny_cell, name):
    """The cell `name` at the rehearsal's size; PRUNED as above."""
    if name != PRUNED:
        return tiny_cell(name)
    cell = tiny_cell(DENSE)
    cell.workload["params"]["primary_prune"] = "lsh"
    return cell


def _run(cell, trace=False, seed=2**31 + 7, root=ROOT):
    return harness.run_cell(cell, seed, 1e-6, trace, CPU, time.perf_counter(), root=root)


def test_last_line_keys_and_checks_last(tiny_cell):
    res = _run(tiny_cell(DENSE))
    line = json.loads(json.dumps(res.result))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"primary_pairs_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"pairs_off", "edges_missing", "edges_extra", "dist_gap_max",
                                   "labels_wrong"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_traced_line_has_the_per_layer_metrics(tiny_cell):
    res = _run(tiny_cell(DENSE), trace=True)
    line = res.result
    assert list(line)[-1] == "checks" and "breakdown" in line
    # off the card no device time: the device readers have nothing to read
    assert set(line["metrics"]) == {"job_median_s", "pack_s", "walk_s", "linkage_s"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["breakdown"]["idle_gaps"][0][0] in ("pack", "prune", "walk", "linkage")


def test_pruned_job_records_its_prune(tiny_cell):
    res = _run(_cell(tiny_cell, PRUNED), trace=True)
    assert res.ok and all(r["prune_s"] > 0 for r in res.records)
    assert "pairs_off" not in res.checks  # a pruned walk computes fewer pairs by design


def test_benchmark_json_matches_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert spec["command"] == ["python3", "benchmark/run.py"] and spec["paths"] == ["benchmark"]
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "jobs", f"{cell.workload['job']}.py"))
        assert cell.workload["why"] == w["why"] and w["name"] == f"{w['config']}.{w['traffic']}"
        assert {m["name"] for m in cell.metrics("end_to_end")} == {"primary_pairs_per_s", "setup_s"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", [])) <= cells
    assert {m["moves"] for m in spec["per_layer"]} == {"primary_pairs_per_s"}


def test_run_refuses_without_enough_cards(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    # a checkout of BENCHMARK.json and benchmark/ alone: no card, no program
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", DENSE, "--seed", "1",
                            "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""


def test_new_config_cell_and_metric_are_found_as_files(tmp_path, tiny_params):
    """A later change adds files and entries and edits no file: here in a
    copy of the benchmark."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cfg = json.loads((root / "benchmark/configs/gtdb207_reps.json").read_text())
    cfg.update(name="toy_reps", genomes=260, planting=dict(cfg["planting"], genus_sizes={
        "law": "geometric", "p": 0.5, "max": 6}))
    (root / "benchmark/configs/toy_reps.json").write_text(json.dumps(cfg))
    cell = {"config": "toy_reps", "traffic": "primary_b256", "chips": 1, "why": "a toy cell",
            "job": "streaming_primary",
            "params": dict(json.loads((root / "benchmark/workloads/gtdb207_reps.primary.json").read_text())["params"],
                           **tiny_params)}
    (root / "benchmark/workloads/toy_reps.primary_b256.json").write_text(json.dumps(cell))
    (root / "benchmark/metrics/edges_per_job.py").write_text(
        "def read(ctx):\n    r = ctx['records']\n    return sum(x['edges'] for x in r) / len(r) if r else None\n")
    spec["configs"].append({"name": "toy_reps", "source": "a test", "file": "benchmark/configs/toy_reps.json",
                            "reduced": [], "why": "a toy"})
    spec["workloads"].append({"name": "toy_reps.primary_b256", "config": "toy_reps", "traffic": "primary_b256",
                              "chips": 1, "why": "a toy cell"})
    spec["per_layer"].append({"name": "edges_per_job", "unit": "edges", "better": "higher",
                              "source": "program_counter", "layer": "streaming walk",
                              "moves": "primary_pairs_per_s", "workloads": ["toy_reps.primary_b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = _run(harness.load_cell("toy_reps.primary_b256", str(root)), trace=True, root=str(root))
    assert res.ok and res.result["metrics"]["edges_per_job"]["value"] > 0


# -- correct: the sound run, the faults, the control -------------------------

def _survivors_fault(monkeypatch, alter):
    from drep_tpu_torch.parallel import streaming

    real = streaming.stripe_survivors

    def broken(a, na, b, nb, s_orig, keep_table, diag):
        return alter(real(a, na, b, nb, s_orig, keep_table, diag), a.shape[0])

    monkeypatch.setattr(streaming, "stripe_survivors", broken)


def _half_the_rows(surv, block):
    return surv[surv[:, 1] < block // 2]


def _one_answer_altered(surv, block):
    surv = surv.copy()
    if len(surv):
        surv[0, 3] -= 1
    return surv


def test_sound_run_is_correct(tiny_cell):
    assert _run(tiny_cell(DENSE)).ok


@pytest.mark.parametrize("cell_name", [DENSE, PRUNED])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered", "single_linkage",
                                   "cutoff_moved"])
def test_each_fault_comes_out_not_correct(fault, cell_name, tiny_cell, monkeypatch):
    """Each fault a one-card cell can have (the exchange between cards it
    cannot), and a wrong linkage, planted in the timed path itself."""
    from drep_tpu_torch.ops import linkage
    from drep_tpu_torch.parallel import streaming

    cell = _cell(tiny_cell, cell_name)
    if fault == "single_linkage":  # single linkage where the configuration states average
        real = streaming.streaming_primary_clusters
        monkeypatch.setattr(streaming, "streaming_primary_clusters",
                            lambda *a, **kw: real(*a, **dict(kw, cluster_alg="single")))
    elif fault == "cutoff_moved":  # the UPGMA cut 0.01 below 1 - P_ani
        real_link = linkage.sparse_average_linkage
        monkeypatch.setattr(linkage, "sparse_average_linkage",
                            lambda n, ii, jj, dd, cutoff, keep: real_link(n, ii, jj, dd, cutoff - 0.01, keep))
    elif fault == "state_unchanged":
        def unchanged(packed, *a, **kw):  # the walk hands back its empty state
            e = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32))
            streaming.STATS.clear()
            streaming.STATS.update(launches=0, seconds=0.0, pairs_computed=0)
            return (*e, 0)

        monkeypatch.setattr(streaming, "streaming_mash_edges", unchanged)
    else:
        _survivors_fault(monkeypatch, _half_the_rows if fault == "half_left_out" else _one_answer_altered)
    res = _run(cell)
    assert res.result["correct"] is False
    assert any(c["value"] > c["limit"] for c in res.result["checks"].values())


@pytest.mark.parametrize("cell_name", [DENSE, PRUNED])
def test_control_comes_out_not_correct(cell_name, tiny_cell):
    cell = _cell(tiny_cell, cell_name)
    job = harness.job_class(cell)(cell.config, cell.workload["params"], 5, CPU)
    ok, checks = verdict(job.control())
    assert not ok and checks["dist_gap_max"]["value"] > 0


@pytest.mark.card
def test_tiny_cell_on_the_card(cuda_device, tiny_cell):
    res = harness.run_cell(tiny_cell(DENSE, genomes=3000), 9, 1e-6, True, cuda_device, time.perf_counter())
    assert res.ok and res.result["device"]["busy_s"] > 0
    assert 0 < res.result["metrics"]["mash_shared_roofline"]["value"] <= 100


def test_idle_gaps_are_cut_where_host_phases_change():
    from benchmark.tracing import reduce_events

    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.job", "ts": t, "dur": 100} for t in (0, 100)]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 40, "dur": 20},
               {"ph": "X", "cat": "kernel", "name": "k", "ts": 150, "dur": 10}]
    phases = [("pack", 0, 30), ("walk", 30, 70), ("linkage", 70, 100),
              ("pack", 100, 140), ("walk", 140, 170), ("linkage", 170, 200)]
    tl = reduce_events(events, lambda spans: spans + phases)
    assert tl.busy_s == pytest.approx(30e-6) and tl.window_s == pytest.approx(200e-6)
    # the idle stretch 60-150 us runs through walk, linkage, pack and walk
    got = sorted((name, round(s * 1e6)) for name, s in tl.gaps)
    assert got == sorted([("pack", 40), ("pack", 30), ("linkage", 30), ("linkage", 30),
                          ("walk", 10), ("walk", 10), ("walk", 10), ("walk", 10)])
