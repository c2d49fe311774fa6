"""The port's autoscale package (drep_tpu_torch/autoscale/) and the index
maintenance scheduler's inputs against the JAX package's, on the CPU.

- ``decide``, ``maintenance_decide`` and ``decide_fleet`` return the JAX
  package's Decision (verdict, delta, reason slug, inputs) on seeded
  random snapshots, with every reason slug of both policies reached;
- ``maintenance_snapshot`` reads a port-built and a JAX-built federation
  alike, and the targets come from the knobs;
- the recommend-only FleetAutoscaleController ticks against the port's
  RouterServer, writing the decision records the JAX controller writes
  against the same router;
- actuation (``spawn_cmd``, ``fleet_dir``, ``supervisor``, ``--spawn``,
  ``--fleet_dir``) refuses naming item 11c and batch mode (a checkpoint
  dir) naming item 12b, before anything is read.
"""

import dataclasses
import json
import os
import random
import sys
import threading

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402

from drep_tpu.autoscale import fleet as jax_fleet  # noqa: E402
from drep_tpu.autoscale import policy as jax_policy  # noqa: E402
from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.index.maintenance import maintenance_snapshot as jax_maintenance_snapshot  # noqa: E402
from drep_tpu_torch.autoscale import fleet, policy  # noqa: E402
from drep_tpu_torch.autoscale.__main__ import main as autoscale_main  # noqa: E402
from drep_tpu_torch.index import build_federated, maintenance_snapshot  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig  # noqa: E402
from drep_tpu_torch.serve.router import RouterConfig, RouterServer  # noqa: E402

CPU = torch.device("cpu")

DECIDE_REASONS = {"snapshot-error", "no-live-members", "finished", "no-targets", "cooldown", "warming",
                  "at-max-procs", "pending-covers", "spawn-clamped", "eta-misses-deadline", "deadline-passed",
                  "cost-over-budget", "deadline-met", "within-cost"}
MAINT_REASONS = {"snapshot-error", "not-federated", "maintenance-pending", "busy-traffic", "cooldown",
                 "partition-unreadable", "partition-over-split-budget", "shards-over-budget", "healthy"}
SEEDS = range(8)


def _same(mine, theirs) -> None:
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _random_decide_case(rng: random.Random):
    now = 1000.0 + rng.random() * 100
    if rng.random() < 0.04:
        snap = {"error": "pod_status: checkpoint dir unreadable"}
    else:
        total = rng.choice([None, 8, 40])
        snap = {
            "observed_at": now,
            "live": list(range(rng.choice([0, 1, 1, 2, 3, 5]))),
            "pending_joins": list(range(rng.choice([0, 0, 1, 3]))),
            "shards_published": rng.randint(0, 44),
            "shards_total": total,
            "eta_s": rng.choice([None, round(rng.uniform(1, 400), 3)]),
        }
    deadline = rng.choice([None, now + rng.uniform(-50, 300)])
    kw = dict(deadline_at=deadline, cost_proc_s=rng.choice([None, rng.uniform(10, 900)]),
              min_procs=rng.choice([1, 2]), max_procs=rng.choice([1, 3, 6]), cooldown_s=rng.choice([0.0, 30.0]),
              hysteresis=rng.choice([0.0, 0.1, 0.3]), max_spawn=rng.choice([0, 1, 2]))
    history = [{"at": now - rng.uniform(0, 60), "verdict": rng.choice(["hold", "scale_up", "scale_down"]),
                "delta": 1} for _ in range(rng.randint(0, 2))]
    return snap, kw, history


@pytest.mark.parametrize("seed", SEEDS)
def test_decide_equals_jax(seed):
    rng = random.Random(seed)
    reasons = set()
    for _ in range(400):
        snap, kw, history = _random_decide_case(rng)
        mine = policy.decide(snap, policy.Targets(**kw), history)
        _same(mine, jax_policy.decide(snap, jax_policy.Targets(**kw), history))
        reasons.add(mine.reason)
    assert reasons <= DECIDE_REASONS


def test_decide_cases_reach_every_reason():
    reasons = set()
    for seed in SEEDS:
        rng = random.Random(seed)
        for _ in range(400):
            snap, kw, history = _random_decide_case(rng)
            reasons.add(policy.decide(snap, policy.Targets(**kw), history).reason)
    assert reasons == DECIDE_REASONS


def _random_maint_case(rng: random.Random):
    now = 500.0 + rng.random() * 10
    r = rng.random()
    if r < 0.04:
        snap = {"observed_at": now, "error": "not a federated index"}
    else:
        n = rng.choice([0, 1, 3, 4])
        snap = {"observed_at": now, "generation": rng.randint(0, 9), "qps": rng.choice([None, 0.0, 0.5, 3.0]),
                "maintenance_pending": rng.random() < 0.08,
                "partitions": [{"pid": p, "n_genomes": rng.randint(0, 80),
                                "generations": rng.choice([-1] + [1, 2, 3, 4, 5] * 6)} for p in range(n)]}
    kw = dict(compact_min_shards=rng.choice([2, 4]), split_max_genomes=rng.choice([0, 0, 50]),
              idle_qps=1.0, cooldown_s=rng.choice([0.0, 300.0]))
    history = [{"at": now - rng.uniform(0, 400), "verdict": rng.choice(["hold", "split", "compact"])}
               for _ in range(rng.randint(0, 2))]
    return snap, kw, history


@pytest.mark.parametrize("seed", SEEDS)
def test_maintenance_decide_equals_jax(seed):
    rng = random.Random(100 + seed)
    for _ in range(400):
        snap, kw, history = _random_maint_case(rng)
        _same(policy.maintenance_decide(snap, policy.MaintenanceTargets(**kw), history),
              jax_policy.maintenance_decide(snap, jax_policy.MaintenanceTargets(**kw), history))


def test_maintenance_cases_reach_every_reason():
    reasons = set()
    for seed in SEEDS:
        rng = random.Random(100 + seed)
        for _ in range(400):
            snap, kw, history = _random_maint_case(rng)
            reasons.add(policy.maintenance_decide(snap, policy.MaintenanceTargets(**kw), history).reason)
    assert reasons == MAINT_REASONS


def _random_router_status(rng: random.Random) -> dict:
    scopes = [None, [0, 1], [2], [0, 1, 2]]
    replicas = {}
    for i in range(rng.randint(0, 5)):
        replicas[f"127.0.0.1:{9000 + i}"] = {
            "state": rng.choice(["healthy", "healthy", "suspect", "ejected", "left"]),
            "assigned": rng.choice(scopes), "draining": rng.random() < 0.2,
            "queue_depth": rng.randint(0, 40),
        }
    return {"role": "router", "replicas": {"replicas": replicas}}


@pytest.mark.parametrize("seed", SEEDS)
def test_decide_fleet_equals_jax(seed):
    rng = random.Random(200 + seed)
    for _ in range(200):
        status = _random_router_status(rng)
        now = 10.0 + rng.random()
        kw = dict(cost_proc_s=rng.choice([None, 5.0]), max_procs=rng.choice([2, 4]), cooldown_s=rng.choice([0, 30]),
                  max_spawn=rng.choice([0, 1]))
        qd, svc = rng.choice([0.5, 5.0]), rng.choice([0.05, 0.2, 1.0])
        history = {"0,1": [{"at": now - 5, "verdict": "scale_up", "delta": 1}]} if rng.random() < 0.3 else {}
        assert fleet.fleet_snapshots(status, now, svc) == jax_fleet.fleet_snapshots(status, now, svc)
        mine = fleet.decide_fleet(status, now, policy.Targets(**kw), qd, svc, history)
        theirs = jax_fleet.decide_fleet(status, now, jax_policy.Targets(**kw), qd, svc, history)
        assert mine.keys() == theirs.keys()
        for key in mine:
            _same(mine[key], theirs[key])


@pytest.fixture(scope="module")
def feds(tmp_path_factory):
    """One P = 3 federation of 7 planted genomes built by each package."""
    td = tmp_path_factory.mktemp("autoscale_fed")
    paths = lib.write_genome_set(str(td / "g"), [3, 2, 2], seed=3)
    jax_build_federated(str(td / "jax"), paths, 3, processes=1, length=0)
    build_federated(str(td / "torch"), paths, 3, processes=1, length=0, device=CPU)
    return str(td / "torch"), str(td / "jax")


def test_maintenance_snapshot_equals_jax(feds, tmp_path):
    mine, theirs = maintenance_snapshot(feds[0]), jax_maintenance_snapshot(feds[1])
    strip = ("observed_at", "location")
    assert {k: v for k, v in mine.items() if k not in strip} == {k: v for k, v in theirs.items() if k not in strip}
    assert mine["partitions"] and not mine["maintenance_pending"]
    plain = maintenance_snapshot(str(tmp_path))
    assert plain["error"] == jax_maintenance_snapshot(str(tmp_path))["error"]
    decision = policy.maintenance_decide(mine, policy.MaintenanceTargets(compact_min_shards=1), [])
    assert decision.verdict == "hold" and decision.reason == "healthy"  # one generation each: floor 2


def _serve(srv):
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    return srv, addr, t


def _stop(srv, t):
    try:
        srv.request_drain()
    finally:
        srv.queue.drain()
        t.join(timeout=60)
        srv.close()


def test_recommend_only_controller_against_the_port_router(feds, tmp_path):
    """One tick of the port's controller and one of the JAX package's
    against the same port router over two scoped replicas: one record a
    range, the JAX keys, the same verdicts and reasons, nothing placed."""
    from drep_tpu.autoscale.fleet import FleetAutoscaleController as JaxController
    from drep_tpu.serve import ServeClient as JaxServeClient

    loc = feds[0]
    kw = {"batch_window_ms": 20.0, "max_batch": 16, "poll_generation_s": 60.0}
    reps = [_serve(IndexServer(ServeConfig(index_loc=loc, device=CPU, **kw))) for _ in range(2)]
    specs = [f"{reps[0][1]}=0,1", f"{reps[1][1]}=2"]
    rt, ra, trt = _serve(RouterServer(RouterConfig(index_loc=loc, replicas=specs, device=CPU, **kw)))
    logs = {"torch": str(tmp_path / "torch.jsonl"), "jax": str(tmp_path / "jax.jsonl")}
    try:
        for pkg, ctl_cls, targets, client in (
                ("torch", fleet.FleetAutoscaleController, policy.Targets(max_procs=4), ServeClient),
                ("jax", JaxController, jax_policy.Targets(max_procs=4), JaxServeClient)):
            with client(ra, timeout_s=60) as c:
                ctl = ctl_cls(c, targets, queue_deadline_s=5.0, svc_s=0.2, decision_log=logs[pkg])
                decisions = ctl.poll_once()
            assert sorted(decisions) == ["0,1", "2"] and not ctl.history
    finally:
        _stop(rt, trt)
        for srv, _a, t in reps:
            _stop(srv, t)
    recs = {}
    for pkg, path in logs.items():
        with open(path) as f:
            recs[pkg] = [json.loads(line) for line in f]
    assert [sorted(r) for r in recs["torch"]] == [sorted(r) for r in recs["jax"]]
    drop = ("at", "inputs")
    assert [{k: v for k, v in r.items() if k not in drop} for r in recs["torch"]] == \
        [{k: v for k, v in r.items() if k not in drop} for r in recs["jax"]]
    assert all(r["inputs"].keys() == s["inputs"].keys() for r, s in zip(recs["torch"], recs["jax"]))


class _DeadRouter:
    """A client whose router has gone away."""

    def status(self):
        raise ConnectionRefusedError("router gone")


def test_controller_tick_against_a_dead_router_records_snapshot_error(tmp_path):
    log = str(tmp_path / "d.jsonl")
    ctl = fleet.FleetAutoscaleController(_DeadRouter(), policy.Targets(), queue_deadline_s=5.0, svc_s=0.2,
                                         decision_log=log)
    assert ctl.run(count=1) == 0
    with open(log) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["range"] == "all" and rec["reason"] == "snapshot-error" and rec["actuation"] == ""


@pytest.mark.parametrize("arg", ["spawn_cmd", "fleet_dir", "supervisor"])
def test_controller_actuation_refused_naming_11c(arg, tmp_path):
    with pytest.raises(NotImplementedError, match="item 11c"):
        fleet.FleetAutoscaleController(_DeadRouter(), policy.Targets(), queue_deadline_s=5.0, svc_s=0.2,
                                       **{arg: str(tmp_path / "x")})
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv,item", [
    (["--router", "ADDR", "--spawn", "python -m drep_tpu_torch index serve IDX"], "11c"),
    (["--router", "ADDR", "--fleet_dir", "FLEET"], "11c"),
    (["CKPT", "--deadline", "600"], "12b"),
])
def test_cli_refusals_name_their_item(tmp_path, argv, item):
    """`python -m drep_tpu_torch.autoscale` refuses actuation and batch
    mode before anything is read or written (no decision log, no socket)."""
    sub = {"ADDR": str(tmp_path / "r.sock"), "FLEET": str(tmp_path / "fleet"), "CKPT": str(tmp_path / "ckpt")}
    log = tmp_path / "d.jsonl"
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        autoscale_main([sub.get(a, a) for a in argv] + ["--decision_log", str(log)])
    assert not os.listdir(tmp_path)


def test_cli_recommend_only_run(feds, tmp_path, monkeypatch):
    """The CLI against a live router: --count ticks, one record a range
    each, and with DREP_TORCH_EVENTS=on a fleet_autoscale_decision instant
    a record under --log_dir."""
    from drep_tpu_torch.utils import telemetry

    loc = feds[0]
    kw = {"batch_window_ms": 20.0, "max_batch": 16, "poll_generation_s": 60.0}
    rep = _serve(IndexServer(ServeConfig(index_loc=loc, device=CPU, **kw)))
    rt, ra, trt = _serve(RouterServer(RouterConfig(index_loc=loc, replicas=[rep[1]], device=CPU, **kw)))
    monkeypatch.setenv("DREP_TORCH_EVENTS", "on")
    log, events = tmp_path / "d.jsonl", tmp_path / "log"
    try:
        assert autoscale_main(["--router", ra, "--count", "2", "--interval", "0.05", "--decision_log", str(log),
                               "--log_dir", str(events)]) == 0
    finally:
        telemetry.configure()
        _stop(rt, trt)
        _stop(*rep[0:1], rep[2])
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["range"] for r in recs] == ["all", "all"]
    got = telemetry.read_events(str(events))
    assert [r["ev"] for r in got] == ["fleet_autoscale_decision"] * 2 and {r["pid"] for r in got} == {999}
