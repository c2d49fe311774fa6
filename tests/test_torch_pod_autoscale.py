"""The elastic pod's operator tools in the port against the JAX package's,
on the CPU: the pod-status snapshot (drep_tpu_torch/utils/hosttools.py),
the pod's AutoscaleController (drep_tpu_torch/autoscale/controller.py)
and the serve daemon's ``update_pod`` field.

- **the snapshot**: the port's ``collect`` equals ``tools/pod_status.py``'s
  at one fixed ``now`` on hand-built note sets (every note kind, torn and
  corrupt notes, ``.eNN`` shards, dense-ring stores at odd and even D, an
  empty and a missing dir) and on a store a port pod wrote;
- **the controller**: tests/test_autoscale.py's controller cases, each run
  by both packages' controllers on one dir at one fixed clock, with equal
  decision records (actuation pids aside): read-only byte for byte, a
  recommend-only scale-up, the spawn environment, ``max_spawn`` 0, a
  broken ``--spawn``, no pod to govern, and a drain stamped by a
  controller-spawned joiner booking churn;
- **the acceptance cell**: a 2-member port pod over gloo
  (tests/_torch_pod_worker.py), stripes paced by
  ``process_death:sleep``, governed by ``python -m drep_tpu_torch.autoscale
  --deadline 1``: the controller spawns a joiner, the leader admits it,
  the edges equal single-process runs of both packages bit for bit (the
  JAX package's distances at atol=1e-7), the decision log and the merged
  events show the scale-up, every process books ``autoscale_churn``;
- **the daemon**: ``update_pod`` over an interrupted `index update`'s
  pending store (the update SIGKILLed by ``process_death:kill:skip=1``)
  equals the JAX daemon's on a plain and a federated root, and the
  port's daemon serves it in ``status``.
"""

import contextlib
import functools
import hashlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import _index_testlib as lib  # noqa: E402

from drep_tpu.autoscale.controller import AutoscaleController as JaxAutoscaleController  # noqa: E402
from drep_tpu.autoscale.policy import Targets as JaxTargets  # noqa: E402
from drep_tpu.parallel import faulttol as jax_faulttol  # noqa: E402
from drep_tpu.serve import IndexServer as JaxIndexServer  # noqa: E402
from drep_tpu.utils import faults as jax_faults  # noqa: E402
from drep_tpu.utils import hosttools as jax_hosttools  # noqa: E402
from drep_tpu.utils.profiling import counters as jax_counters  # noqa: E402
from drep_tpu_torch.autoscale import controller as controller_mod  # noqa: E402
from drep_tpu_torch.autoscale.controller import AutoscaleController, default_decision_log  # noqa: E402
from drep_tpu_torch.autoscale.policy import Targets  # noqa: E402
from drep_tpu_torch.parallel import faulttol  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig  # noqa: E402
from drep_tpu_torch.serve.daemon import pending_update_status  # noqa: E402
from drep_tpu_torch.utils import faults, hosttools, telemetry  # noqa: E402
from drep_tpu_torch.utils.durableio import atomic_savez, atomic_write_bytes, atomic_write_json  # noqa: E402
from drep_tpu_torch.utils.profiling import counters  # noqa: E402
from tools import pod_status as jax_pod_status  # noqa: E402

CPU = torch.device("cpu")
WORKER = os.path.join(HERE, "_torch_pod_worker.py")
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """Both packages' pod state, counters and fault rules fresh, and one
    heartbeat cadence for both."""
    for mod in (faulttol, jax_faulttol):
        mod.reset_pod()
    for c in (counters, jax_counters):
        c.reset()
    for f in (faults, jax_faults):
        f.reset()
    for name in ("DREP_TORCH_HEARTBEAT_S", "DREP_TPU_HEARTBEAT_S"):
        monkeypatch.setenv(name, "0.5")
    yield
    for mod in (faulttol, jax_faulttol):
        mod.reset_pod()
    for f in (faults, jax_faults):
        f.reset()


def _dir_digest(root) -> dict:
    """Relative path -> (size, mtime_ns, sha256) of every file under `root`."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            st = os.stat(p)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns, hashlib.sha256(f.read()).hexdigest())
    return out


def _empty_shard(path: str, mtime: float | None = None) -> None:
    e = np.empty(0, np.int64)
    atomic_savez(path, ii=e, jj=e, dist=np.empty(0, np.float32))
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def _beat(ckpt: str, pid: int, mtime: float) -> None:
    path = os.path.join(ckpt, f".pod-hb.p{pid}")
    atomic_write_bytes(path, b"1")
    os.utime(path, (mtime, mtime))


# -- the snapshot -------------------------------------------------------------

NOTE_CASES = ("hb", "done", "dead", "drain", "join", "admit", "torn", "corrupt", "epochs", "ring_odd", "ring_even",
              "ring_full", "empty", "missing")


def _plant_notes(ckpt: str, case: str, now: float) -> None:
    """One hand-built store a case: a 9-stripe streaming store with four
    published stripes and two members beating, plus the case's notes."""
    if case == "missing":
        return
    os.makedirs(ckpt)
    if case == "empty":
        return
    if case.startswith("ring"):
        d = {"ring_odd": 3, "ring_even": 4, "ring_full": 3}[case]
        meta = {"n": 96, "block": 32, "n_devices": d, "kind": "mash"}
        if case == "ring_full":
            meta["half"] = False
        atomic_write_json(os.path.join(ckpt, "meta.json"), meta)
        for i, (a, b) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1))):
            _empty_shard(os.path.join(ckpt, f"blk_{a:03d}_{b:03d}.npz"), now - 10 + 2 * i)
        _empty_shard(os.path.join(ckpt, "blk_001_002.e01.npz"), now - 1)
        for pid in (0, 1):
            _beat(ckpt, pid, now - 0.2 * pid)
        return
    atomic_write_json(os.path.join(ckpt, "meta.json"), {"n": 72, "block": 8, "n_blocks": 9, "pod_epochs": 2})
    for bi in range(4):
        _empty_shard(os.path.join(ckpt, f"row_{bi:05d}.npz"), now - 9 + 3 * bi)
    for pid in (0, 1):
        _beat(ckpt, pid, now - 0.3 * pid)
    note = lambda kind, pid: os.path.join(ckpt, f".pod-{kind}.p{pid}")  # noqa: E731
    if case == "hb":
        _beat(ckpt, 2, now - 120)  # stale
        _beat(ckpt, 3, now - 1.5)  # within 5 x 0.5 s of the newest
    elif case == "done":
        atomic_write_json(note("done", 1), {"seq": 1, "epoch": 0, "pairs": 1234, "at": now})
    elif case == "dead":
        _beat(ckpt, 2, now - 60)
        atomic_write_json(note("dead", 2), {"by": 0, "seq": 1, "at": now})
    elif case == "drain":
        atomic_write_json(note("drain", 1), {"seq": 1, "epoch": 1, "pairs": 99, "at": now, "autoscale": True})
    elif case == "join":
        atomic_write_bytes(note("hb", 5), b"join-candidate:t")
        atomic_write_json(note("join", 5), {"token": "t", "at": now})
    elif case == "admit":
        atomic_write_json(note("admit", 2), {"token": "t", "epoch": 1, "seq": 1, "pc": 2, "live": [0, 1, 2]})
        _beat(ckpt, 2, now - 0.1)
        atomic_write_json(note("join", 3), {"token": "u", "at": now})
        atomic_write_json(note("admit", 3), {"token": "u", "reject": "max_joins", "epoch": 1})
    elif case == "torn":
        with open(note("done", 1), "w") as f:
            f.write('{"seq": 1, "epoch": 3, "pa')  # a half-written note reads as absent
        with open(note("drain", 0), "wb") as f:
            f.write(b"\x00\xff")
    elif case == "corrupt":
        atomic_write_json(note("done", 1), {"seq": 1, "epoch": 2, "pairs": 5, "at": now})
        with open(note("done", 1)) as f:
            doc = json.load(f)
        doc["pairs"] = 6  # the in-band checksum no longer matches
        with open(note("done", 1), "w") as f:
            json.dump(doc, f)
        with open(os.path.join(ckpt, "meta.json"), "w") as f:
            f.write("{not json")
    elif case == "epochs":
        _empty_shard(os.path.join(ckpt, "row_00002.e01.npz"), now - 0.5)  # counts once, at its first publish
        _empty_shard(os.path.join(ckpt, "row_00005.e02.npz"), now - 0.2)
        _empty_shard(os.path.join(ckpt, "row_00006.e01.npz"))


@pytest.mark.parametrize("case", NOTE_CASES)
def test_collect_equals_pod_status_tool(tmp_path, case):
    now = time.time()
    ckpt = str(tmp_path / "ckpt")
    _plant_notes(ckpt, case, now)
    before = _dir_digest(ckpt) if os.path.isdir(ckpt) else None
    got = hosttools.collect(ckpt, now=now)
    want = jax_pod_status.collect(ckpt, now=now)
    assert got == want
    assert (_dir_digest(ckpt) if os.path.isdir(ckpt) else None) == before
    if case == "missing":
        assert "error" in got
    elif case == "hb":
        assert got["live"] == [0, 1, 3] and got["stale"] == [2] and got["miss_window_s"] == 2.5
    elif case == "admit":
        assert got["members"]["2"]["joined"] and got["pending_joins"] == [3] and got["epoch"] == 1
    elif case == "epochs":
        assert got["shards_published"] == 6 and got["shards_total"] == 9
    elif case == "ring_even":
        assert got["shards_total"] == 10 and got["shards_published"] == 5
    elif case == "torn":
        assert got["members"]["1"]["state"] == "finished" and "pairs" not in got["members"]["1"]


# -- the controller -----------------------------------------------------------

def _plant_pod(ckpt: str, now: float) -> None:
    """tests/test_autoscale.py's mid-run pod: 3 live members, 4 of 9
    stripes published at a measurable rate."""
    os.makedirs(ckpt, exist_ok=True)
    atomic_write_json(os.path.join(ckpt, "meta.json"), {"n": 72, "block": 8, "n_blocks": 9})
    for bi in range(4):
        _empty_shard(os.path.join(ckpt, f"row_{bi:05d}.npz"), now - 9 + 3 * bi)
    for pid in (0, 1, 2):
        with open(os.path.join(ckpt, f".pod-hb.p{pid}"), "wb") as f:
            f.write(b"1")


def _fixed_clock(monkeypatch, now: float) -> None:
    """Both controllers snapshot at `now`."""
    monkeypatch.setattr(controller_mod, "collect", functools.partial(hosttools.collect, now=now))
    monkeypatch.setattr(jax_hosttools, "_POD_STATUS", [functools.partial(jax_pod_status.collect, now=now)])


def _records(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        recs = [json.loads(line) for line in f.read().splitlines()]
    for r in recs:
        r["actuation"] = re.sub(r"\(pids? \[[0-9, ]*\]\)", "(pids)", r["actuation"])
    return recs


def _both(tmp_path, monkeypatch, ckpt: str, now: float, ticks: int = 1, spawn: dict | None = None, **kw) -> dict:
    """Each package's controller on `ckpt` at the fixed clock `now`, `ticks`
    ticks: {pkg: (controller, decisions, records)}."""
    _fixed_clock(monkeypatch, now)
    targets_kw = kw.pop("targets")
    out = {}
    for pkg, cls, tcls in (("torch", AutoscaleController, Targets), ("jax", JaxAutoscaleController, JaxTargets)):
        log = str(tmp_path / f"decisions_{pkg}.jsonl")
        ctl = cls(ckpt, tcls(**targets_kw), spawn_cmd=(spawn or {}).get(pkg), decision_log=log, **kw)
        decisions = [ctl.poll_once() for _ in range(ticks)]
        out[pkg] = (ctl, decisions, _records(log))
    return out


def _same(out: dict) -> None:
    (tc, td, tr), (jc, jd, jr) = out["torch"], out["jax"]
    assert [(d.verdict, d.delta, d.reason, d.inputs) for d in td] == [(d.verdict, d.delta, d.reason, d.inputs)
                                                                     for d in jd]
    assert tr == jr and len(tr) == len(td)
    assert tc.history == jc.history and tc.decisions == jc.decisions


def test_controller_is_byte_for_byte_read_only_and_logs_decisions(tmp_path, monkeypatch):
    now = time.time()
    ckpt = str(tmp_path / "pod" / "ckpt")
    _plant_pod(ckpt, now)
    before = _dir_digest(ckpt)
    out = _both(tmp_path, monkeypatch, ckpt, now, ticks=2, targets={"deadline_at": now + 1e6}, interval_s=0.01)
    assert _dir_digest(ckpt) == before, "a controller wrote into the checkpoint dir"
    _same(out)
    ctl, decisions, recs = out["torch"]
    assert [d.reason for d in decisions] == ["deadline-met", "deadline-met"]
    assert recs[0]["ckpt"] == os.path.abspath(ckpt) and "inputs" in recs[0]
    assert ctl.history == [] and ctl.decisions == 2
    # the default log lives beside the dir, as the JAX controller's
    from drep_tpu.autoscale.controller import default_decision_log as jax_default_log

    assert default_decision_log(ckpt) == jax_default_log(ckpt)
    assert os.path.dirname(default_decision_log(ckpt)) == os.path.dirname(ckpt)


def test_controller_recommend_only_scale_up_is_logged_not_actuated(tmp_path, monkeypatch):
    now = time.time()
    ckpt = str(tmp_path / "ckpt")
    _plant_pod(ckpt, now)
    out = _both(tmp_path, monkeypatch, ckpt, now, ticks=2, targets={"deadline_at": now - 5.0})
    _same(out)
    ctl, decisions, recs = out["torch"]
    assert decisions[0].verdict == "scale_up" and decisions[0].reason == "deadline-passed"
    assert "no --spawn" in recs[0]["actuation"] and not ctl.spawned
    # a skipped actuation never arms the cooldown: the second tick decides again
    assert ctl.history == [] and decisions[1].verdict == "scale_up"


def test_controller_spawn_env_carries_the_protocol_knobs(tmp_path, monkeypatch):
    now = time.time()
    ckpt = str(tmp_path / "ckpt")
    _plant_pod(ckpt, now)
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import json, os, sys\n"
        "json.dump({k: os.environ.get(k) for k in ('DREP_TORCH_POD_JOIN', 'DREP_TORCH_AUTOSCALE_SPAWNED',\n"
        "           'DREP_TPU_POD_JOIN', 'DREP_TPU_AUTOSCALE_SPAWNED')}, open(sys.argv[1], 'w'))\n")
    # two spawns a decision: max_spawn 2, above the knob's default of 1
    out = _both(tmp_path, monkeypatch, ckpt, now, targets={"deadline_at": now - 5.0, "max_spawn": 2},
                spawn={pkg: f"{sys.executable} {probe} {tmp_path / f'{pkg}_env.json'}" for pkg in ("torch", "jax")})
    _same(out)
    for pkg in ("torch", "jax"):
        ctl, decisions, recs = out[pkg]
        assert decisions[0].verdict == "scale_up" and decisions[0].delta == 2 and len(ctl.spawned) == 2
        assert all(p.wait(timeout=60) == 0 for p in ctl.spawned)
        assert recs[0]["actuation"] == "spawned 2 joiner(s) (pids)"
    with open(tmp_path / "torch_env.json") as f:
        mine = json.load(f)
    with open(tmp_path / "jax_env.json") as f:
        theirs = json.load(f)
    assert mine["DREP_TORCH_POD_JOIN"] == "auto" and mine["DREP_TORCH_AUTOSCALE_SPAWNED"] == "1"
    assert (theirs["DREP_TPU_POD_JOIN"], theirs["DREP_TPU_AUTOSCALE_SPAWNED"]) == ("auto", "1")


def test_max_spawn_zero_decides_but_never_spawns(tmp_path, monkeypatch):
    now = time.time()
    ckpt = str(tmp_path / "ckpt")
    _plant_pod(ckpt, now)
    out = _both(tmp_path, monkeypatch, ckpt, now, targets={"deadline_at": now - 5.0, "max_spawn": 0},
                spawn={"torch": f"{sys.executable} -c pass", "jax": f"{sys.executable} -c pass"})
    _same(out)
    ctl, decisions, recs = out["torch"]
    assert (decisions[0].verdict, decisions[0].reason) == ("hold", "spawn-clamped") and not ctl.spawned
    # a hand-built delta cannot spawn past the clamp either
    assert ctl._spawn_joiners(3) == out["jax"][0]._spawn_joiners(3) == "skipped: max_spawn is 0"


def test_broken_spawn_command_records_the_failure_not_a_crash(tmp_path, monkeypatch):
    now = time.time()
    ckpt = str(tmp_path / "ckpt")
    _plant_pod(ckpt, now)
    broken = "/nonexistent-binary-xyzzy --flag"
    out = _both(tmp_path, monkeypatch, ckpt, now, targets={"deadline_at": now - 5.0},
                spawn={"torch": broken, "jax": broken})
    _same(out)
    ctl, decisions, recs = out["torch"]
    assert decisions[0].verdict == "scale_up" and recs[0]["actuation"].startswith("FAILED:") and not ctl.spawned


def test_controller_exits_when_there_is_no_pod_to_govern(tmp_path, monkeypatch):
    now = time.time()
    _fixed_clock(monkeypatch, now)
    ckpt = str(tmp_path / "never_created")
    runs = {}
    monkeypatch.setattr(AutoscaleController, "IDLE_EXIT_S", 0.05)
    for pkg, cls, tcls in (("torch", AutoscaleController, Targets), ("jax", JaxAutoscaleController, JaxTargets)):
        log = str(tmp_path / f"{pkg}.jsonl")
        kw = {"idle_exit_s": 0.05} if pkg == "jax" else {}
        ctl = cls(ckpt, tcls(deadline_at=now + 60), interval_s=0.01, decision_log=log, **kw)
        t0 = time.monotonic()
        assert ctl.run() == 0
        assert time.monotonic() - t0 < 10.0 and ctl.decisions >= 2
        recs = _records(log)
        runs[pkg] = recs[0]
        assert all(r == recs[0] for r in recs) and recs[0]["reason"] == "snapshot-error"
    assert runs["torch"] == runs["jax"]
    assert not os.path.exists(ckpt)


def test_drain_of_a_controller_spawned_joiner_books_churn(tmp_path, monkeypatch):
    """A joiner the controller spawned drains (its SIGTERM, here
    announce_drain under DREP_TORCH_AUTOSCALE_SPAWNED): its departure note
    is stamped, and the peer that reads it books autoscale_churn and a
    planned departure, as in the JAX package. The controller's scale-down
    SIGTERMs the newest live joiner it spawned."""
    seen = {}
    for pkg, ft, ctr, env in (("torch", faulttol, counters, "DREP_TORCH_AUTOSCALE_SPAWNED"),
                              ("jax", jax_faulttol, jax_counters, "DREP_TPU_AUTOSCALE_SPAWNED")):
        d = tmp_path / pkg
        d.mkdir()
        hbs = []
        for pid in (0, 1):
            ft._HB_SEQ[os.path.abspath(str(d))] = 0
            hb = ft.HeartbeatManager(str(d), 0.2, max_dead=1, pc=2, pid=pid, max_joins=0)
            hb.start()
            hbs.append(hb)
        try:
            monkeypatch.setenv(env, "1")
            hbs[1].announce_drain(pairs=7)
            monkeypatch.delenv(env)
            note = ft.read_pod_note(hbs[1].drain_path(1))
            assert hbs[0].check()
            seen[pkg] = (note.get("autoscale"), hbs[0].drained, ctr.faults.get("autoscale_churn"),
                         ctr.faults.get("planned_departures"))
        finally:
            for hb in hbs:
                hb.close()
    assert seen["torch"] == seen["jax"] == (True, [1], 1, 1)
    ctl = AutoscaleController(str(tmp_path / "ckpt"), Targets())
    assert ctl._drain_joiners(1) == "skipped: no controller-spawned capacity left to drain"
    ctl.spawned = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"]) for _ in range(2)]
    try:
        assert ctl._drain_joiners(1) == f"SIGTERMed joiner pid(s) [{ctl.spawned[1].pid}] (graceful drain)"
        assert ctl.spawned[1].wait(timeout=30) == -signal.SIGTERM and ctl.spawned[0].poll() is None
    finally:
        for p in ctl.spawned:
            p.kill()
            p.wait()


# -- the acceptance cell: a governed pod on the CPU ---------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DREP_TORCH_", "DREP_TPU_"))}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               DREP_TORCH_HEARTBEAT_S="0.3", DREP_TORCH_COLLECTIVE_TIMEOUT_S="90", DREP_TORCH_EVENTS="on")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def single_edges():
    """The fixed-membership oracles: single-process walks of the worker's
    pack by the port and by the JAX package."""
    from _torch_pod_worker import BLOCK, CUTOFF, planted_pack

    from drep_tpu.ops.minhash import PackedSketches as JaxPacked
    from drep_tpu.parallel.streaming import streaming_mash_edges as jax_streaming_mash_edges
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges

    pack = planted_pack()
    mine = streaming_mash_edges(pack, k=21, cutoff=CUTOFF, block=BLOCK, device="cpu")
    theirs = jax_streaming_mash_edges(JaxPacked(ids=pack.ids, counts=pack.counts, names=list(pack.names)), k=21,
                                      cutoff=CUTOFF, block=BLOCK)
    return [np.asarray(x) for x in mine[:3]], [np.asarray(x) for x in theirs[:3]]


def test_controller_spawned_joiner_is_admitted_mid_run(tmp_path, single_edges):
    out, ckpt, log_dir = str(tmp_path / "out"), str(tmp_path / "ckpt"), str(tmp_path / "out" / "log")
    os.makedirs(log_dir)
    decision_log = os.path.join(out, "autoscale.jsonl")
    port = str(_free_port())
    procs, logs = [], []
    try:
        for r in range(2):
            logs.append(open(os.path.join(out, f"m{r}.log"), "w"))  # noqa: SIM115 — closed below
            env = _env({"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": port, "DREP_TORCH_FAULTS": "process_death:sleep:secs=3.5"})
            procs.append(subprocess.Popen([sys.executable, WORKER, os.path.join(out, f"m{r}.npz"), ckpt,
                                           "--no_ring", "--log_dir", log_dir],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
        spawn = f"{sys.executable} {WORKER} {os.path.join(out, 'j.npz')} {ckpt} --no_ring --log_dir {log_dir}"
        logs.append(open(os.path.join(out, "controller.log"), "w"))  # noqa: SIM115 — closed below
        ctl = subprocess.Popen(
            [sys.executable, "-m", "drep_tpu_torch.autoscale", ckpt, "--deadline", "1", "--min_procs", "2",
             "--max_procs", "3", "--interval", "0.2", "--cooldown", "120", "--max_spawn", "1", "--spawn", spawn,
             "--decision_log", decision_log, "--log_dir", log_dir],
            env=_env({}), stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT)
        procs.append(ctl)
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]

        def tail(name):
            with open(os.path.join(out, name)) as f:
                return f.read()[-3000:]

        assert rcs == [0, 0, 0], (rcs, tail("m0.log"), tail("m1.log"), tail("controller.log"))
        # the joiner is the controller's child, left running at its exit
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(os.path.join(out, "j.npz")) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert os.path.exists(os.path.join(out, "j.npz")), tail("controller.log")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        with open(decision_log) if os.path.exists(decision_log) else contextlib.nullcontext([]) as f:
            spawned = [int(p) for line in f for p in re.findall(r"pids \[([0-9, ]*)\]", line)[0:1]
                       for p in p.split(",") if p.strip()]
        for pid in spawned:  # the joiner, where a failure left it running
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)

    mine, theirs = single_edges
    for who in ("m0", "m1", "j"):
        with np.load(os.path.join(out, f"{who}.npz")) as z:
            got = [z["ii"], z["jj"], z["dist"]]
        for a, b in zip(got, mine, strict=True):
            assert a.tobytes() == b.tobytes(), who
        np.testing.assert_array_equal(got[0], theirs[0])
        np.testing.assert_array_equal(got[1], theirs[1])
        np.testing.assert_allclose(got[2], theirs[2], rtol=0, atol=1e-7)

    with open(decision_log, encoding="utf-8") as f:
        decisions = [json.loads(line) for line in f.read().splitlines()]
    ups = [d for d in decisions if d["verdict"] == "scale_up"]
    assert ups and ups[0]["reason"] in ("deadline-passed", "eta-misses-deadline"), decisions
    assert "spawned 1 joiner" in ups[0]["actuation"]
    assert len(ups) == 1  # the cooldown holds the rest

    ctrs = {}
    for who in ("m0", "m1", "j"):
        with open(os.path.join(out, f"{who}.npz.counters.json")) as f:
            ctrs[who] = json.load(f)
    assert ctrs["j"].get("pod_join_accepted") == 1 and ctrs["j"].get("autoscale_churn", 0) >= 1, ctrs
    for who in ("m0", "m1"):
        assert ctrs[who].get("pod_joins", 0) >= 1 and ctrs[who].get("autoscale_churn", 0) >= 1, ctrs
    with open(os.path.join(ckpt, "meta.json")) as f:
        assert json.load(f).get("pod_joins", 0) >= 1

    events = telemetry.read_events(log_dir)
    names = {e["ev"] for e in events}
    assert {"autoscale_decision"} <= names and names & {"join_admitted", "join_adopted"}, sorted(names)
    assert any(e["ev"] == "autoscale_decision" and e["pid"] == 999 and e["args"]["verdict"] == "scale_up"
               for e in events)
    # the store the pod wrote, read by both snapshots at one clock; nothing
    # of the controller's inside it
    now = time.time()
    snap = hosttools.collect(ckpt, now=now)
    assert snap == jax_pod_status.collect(ckpt, now=now)
    assert snap["shards_published"] == snap["shards_total"] == 9 and snap["members"]["2"]["joined"]
    pattern = re.compile(r"^(\.pod-(hb|done|dead|drain|join|admit)\.p\d+|\.barrier-[0-9a-f]+\.p\d+|"
                         r"row_\d+(\.e\d+)?\.npz|meta\.json)$")
    assert all(pattern.match(name) for name in os.listdir(ckpt)), sorted(os.listdir(ckpt))


# -- the daemon's update_pod --------------------------------------------------

def _interrupted_update(loc: str, paths: list[str]) -> None:
    """`index update` of `paths` into `loc` on the CPU, SIGKILLed as it
    starts its second stripe: a genuine pending store is left behind."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DREP_TORCH_")}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               DREP_TORCH_FAULTS="process_death:kill:skip=1")
    res = subprocess.run([sys.executable, "-m", "drep_tpu_torch", "index", "update", loc, "-g", *paths,
                          "--device", "cpu", "-p", "1"], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert res.returncode == -signal.SIGKILL, res.stderr[-3000:]


def _jax_update_pod(loc: str):
    return JaxIndexServer._pending_update_status(types.SimpleNamespace(cfg=types.SimpleNamespace(index_loc=loc)))


@pytest.fixture(scope="module")
def update_roots(tmp_path_factory):
    """A plain and a federated root (2 partitions) of 200 genomes, each
    with an interrupted update of 100 more: the update's walk has a stripe
    a 128 genomes (the smallest block), so the kill leaves stripes
    unpublished."""
    from drep_tpu_torch.index import build_federated, build_from_paths

    base = tmp_path_factory.mktemp("upd")
    paths = lib.write_genome_set(str(base / "g"), [6] * 50, seed=19, length=3000)
    plain, fed = str(base / "plain"), str(base / "fed")
    kw = {"length": 0, "MASH_sketch": 64, "streaming_block": 128, "device": CPU}
    build_from_paths(plain, paths[:200], **kw)
    build_federated(fed, paths[:200], 2, processes=1, **kw)
    telemetry.close()
    for loc in (plain, fed):
        _interrupted_update(loc, paths[200:])
    return {"plain": plain, "federated": fed}


@pytest.mark.parametrize("kind", ["plain", "federated"])
def test_update_pod_equals_the_jax_daemons(update_roots, kind):
    loc = update_roots[kind]
    got = pending_update_status(loc)
    assert got == _jax_update_pod(loc)
    assert set(got) == {"checkpoint_dir", "epoch", "live", "dead", "draining", "shards_published", "shards_total",
                        "progress", "eta_s"}
    assert 0 < got["shards_published"] < got["shards_total"], got
    want_dir = os.path.join(loc, "pending") if kind == "plain" else os.path.join(loc, "part_")
    assert got["checkpoint_dir"].startswith(want_dir) and os.path.basename(got["checkpoint_dir"]).startswith("g")
    snap = hosttools.collect(got["checkpoint_dir"])
    assert {k: snap[k] for k in got if k != "checkpoint_dir"} == {k: v for k, v in got.items() if k != "checkpoint_dir"}


def test_daemon_status_carries_update_pod(update_roots, tmp_path):
    """The port's daemon on the plain root serves update_pod in ``status``;
    a root with no pending store leaves the field out."""
    loc = update_roots["plain"]
    before = lib.tree_digest(loc, exclude_dirs=())
    srv = IndexServer(ServeConfig(index_loc=loc, batch_window_ms=1.0, poll_generation_s=60.0, device="cpu"))
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    try:
        with ServeClient(addr) as c:
            st = c.status()
    finally:
        srv.request_drain()
        t.join(timeout=30)
        srv.close()
    assert st["update_pod"] == _jax_update_pod(loc) == pending_update_status(loc)
    assert st["update_pod"]["shards_published"] < st["update_pod"]["shards_total"]
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    assert pending_update_status(str(tmp_path)) is None and _jax_update_pod(str(tmp_path)) is None
