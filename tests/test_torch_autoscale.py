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
- actuation arguments (``spawn_cmd``, ``fleet_dir``, ``supervisor``,
  ``--spawn``, ``--fleet_dir``) behave as the JAX controller's and
  ``tools/pod_autoscale.py``'s (tests/test_torch_supervisor.py holds the
  actuation itself); batch mode (a checkpoint dir) writes the decision
  records ``tools/pod_autoscale.py`` writes (the pod controller itself is
  tests/test_torch_pod_autoscale.py's).
"""

import dataclasses
import json
import os
import random
import sys
import threading
import time

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
def test_controller_actuation_arguments_act_as_jax(arg, tmp_path):
    """Actuation since item 11c, each argument alone, as in the JAX
    controller: a spawn command without a manifest home refuses with
    nothing written; a fleet_dir embeds a supervisor, recovered at once
    (the manifest's first generation); a supervisor is used as given."""
    outcomes = {}
    for pkg, (fl, pol) in {"torch": (fleet, policy), "jax": (jax_fleet, jax_policy)}.items():
        home = tmp_path / pkg
        home.mkdir()
        value = {"spawn_cmd": "index serve x", "fleet_dir": str(home / "fleet"), "supervisor": _DeadRouter()}[arg]
        try:
            ctl = fl.FleetAutoscaleController(_DeadRouter(), pol.Targets(), queue_deadline_s=5.0, svc_s=0.2,
                                              **{arg: value})
        except ValueError as e:
            outcomes[pkg] = ("ValueError", "fleet_dir" in str(e), os.listdir(home))
            continue
        sup = ctl.supervisor
        outcomes[pkg] = (type(sup).__name__, sup is value, getattr(sup, "doc", {}).get("generation"),
                         sorted(os.listdir(home)))
    assert outcomes["torch"] == outcomes["jax"]
    assert outcomes["torch"] == {"spawn_cmd": ("ValueError", True, []),
                                 "fleet_dir": ("FleetSupervisor", False, 1, ["fleet"]),
                                 "supervisor": ("_DeadRouter", True, None, [])}[arg]


@pytest.mark.parametrize("argv,item", [
    (["--router", "ADDR", "--spawn", "python -m drep_tpu_torch index serve IDX"], "11c"),
    (["--router", "ADDR", "--fleet_dir", "FLEET"], "11c"),
    (["CKPT", "--deadline", "600", "--count", "2", "--interval", "0.01"], "batch"),
])
def test_cli_refusals_name_their_item(tmp_path, monkeypatch, argv, item):
    """`python -m drep_tpu_torch.autoscale` acts as ``tools/pod_autoscale.py``
    on the same argv. Its fleet actuation flags (item 11c): --spawn
    without --fleet_dir is a usage error, and a router that is not there
    fails the start, with nothing read or written (no decision log, no
    manifest, no socket). Batch mode on a pod's checkpoint dir, both
    controllers at one clock: the same decision records, and nothing
    written into the dir."""
    import functools
    import types

    from tools.pod_autoscale import main as jax_autoscale_main

    sub = {"ADDR": str(tmp_path / "r.sock"), "FLEET": str(tmp_path / "fleet"), "CKPT": str(tmp_path / "ckpt")}
    if item != "batch":
        full = [sub.get(a, a) for a in argv] + ["--decision_log", str(tmp_path / "d.jsonl")]
        seen = []
        for main in (autoscale_main, jax_autoscale_main):
            with pytest.raises((SystemExit, OSError)) as ei:
                main(full)
            seen.append(type(ei.value).__name__)
        assert seen[0] == seen[1] == ("SystemExit" if "--spawn" in argv else "FileNotFoundError")
        assert not os.listdir(tmp_path)
        return
    from drep_tpu.utils import hosttools as jax_hosttools
    from drep_tpu_torch.autoscale import __main__ as cli
    from drep_tpu_torch.autoscale import controller
    from drep_tpu_torch.utils import hosttools
    from tools import pod_autoscale
    from tools import pod_status as jax_pod_status

    now = time.time()
    ckpt = sub["CKPT"]
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "meta.json"), "w") as f:
        json.dump({"n": 72, "block": 8, "n_blocks": 9}, f)
    for pid in (0, 1):
        with open(os.path.join(ckpt, f".pod-hb.p{pid}"), "wb") as f:
            f.write(b"1")
    files = sorted(os.listdir(ckpt))
    # one wall clock for both: the deadline (start + 600) and the snapshots
    clock = types.SimpleNamespace(time=lambda: now, sleep=time.sleep, monotonic=time.monotonic)
    monkeypatch.setattr(cli, "time", clock)
    monkeypatch.setattr(pod_autoscale, "time", clock)
    monkeypatch.setattr(controller, "collect", functools.partial(hosttools.collect, now=now))
    monkeypatch.setattr(jax_hosttools, "_POD_STATUS", [functools.partial(jax_pod_status.collect, now=now)])
    records = []
    for name, main in (("torch", autoscale_main), ("jax", jax_autoscale_main)):
        log = str(tmp_path / f"{name}.jsonl")
        assert main([sub.get(a, a) for a in argv] + ["--decision_log", log]) == 0
        with open(log) as f:
            records.append([json.loads(line) for line in f])
    assert records[0] == records[1] and len(records[0]) == 2
    assert [r["reason"] for r in records[0]] == ["warming", "warming"]
    assert records[0][0]["inputs"]["remaining_s"] == 600.0 and records[0][0]["at"] == round(now, 3)
    assert sorted(os.listdir(ckpt)) == files


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


# a stand-in replica on the daemon's ready-line contract: it binds a port,
# prints the ready line and answers every request line with an error
STUB_REPLICA = """import json, os, socket, threading
srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
srv.bind(("127.0.0.1", 0))
srv.listen(8)
def serve(conn):
    with conn, conn.makefile("rb") as r:
        for line in r:
            conn.sendall(b'{"ok": false, "reason": "stub"}\\n')
def accept():
    while True:
        threading.Thread(target=serve, args=(srv.accept()[0],), daemon=True).start()
threading.Thread(target=accept, daemon=True).start()
print(json.dumps({"serving": "127.0.0.1:%d" % srv.getsockname()[1], "pid": os.getpid()}), flush=True)
threading.Event().wait()
"""


def test_cli_places_through_the_supervisor(feds, tmp_path):
    """`--spawn` with `--fleet_dir` acts: a range whose queueing deadline
    is already spent (--queue_deadline_s 0) scales up, and the embedded
    supervisor places the replica (the manifest's slot healthy, the
    decision's actuation naming its address, the router told by a fleet
    join), as tools/pod_autoscale.py does."""
    import signal
    import sys

    from drep_tpu_torch.serve.supervisor import load_manifest

    loc = feds[0]
    kw = {"batch_window_ms": 20.0, "max_batch": 16, "poll_generation_s": 60.0}
    rep = _serve(IndexServer(ServeConfig(index_loc=loc, device=CPU, **kw)))
    rt, ra, trt = _serve(RouterServer(RouterConfig(index_loc=loc, replicas=[rep[1]], device=CPU, **kw)))
    stub = tmp_path / "stub.py"
    stub.write_text(STUB_REPLICA)
    log, fleet_dir = tmp_path / "d.jsonl", str(tmp_path / "fleet")
    pids = []
    try:
        assert autoscale_main(["--router", ra, "--count", "1", "--queue_deadline_s", "0", "--max_procs", "2",
                               "--spawn", f"{sys.executable} {stub}", "--fleet_dir", fleet_dir,
                               "--decision_log", str(log)]) == 0
        slots = load_manifest(fleet_dir)["slots"]
        pids = [s["pid"] for s in slots.values() if s.get("pid")]
        (slot,) = slots.values()
        assert slot["state"] == "healthy" and slot["partitions"] is None
        with open(log) as f:
            (rec,) = [json.loads(line) for line in f]
        assert (rec["range"], rec["verdict"], rec["delta"], rec["reason"]) == ("all", "scale_up", 1, "deadline-passed")
        assert rec["actuation"] == f"placed [{slot['address']!r}] for range all"
        assert rt.table.health_map()["replicas"][slot["address"]]["state"] == "healthy"  # the fleet join
    finally:
        for pid in pids:
            os.kill(pid, signal.SIGKILL)
        _stop(rt, trt)
        _stop(*rep[0:1], rep[2])
