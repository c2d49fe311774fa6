"""The port's fleet supervisor (drep_tpu_torch/serve/supervisor.py), the
router's manifest rebuild and the fleet autoscaler's actuation against
the JAX package's, on the CPU.

- the lifecycle arithmetic (decorrelated backoff, the crash-loop window,
  the pid probe) equals the JAX functions on seeded inputs;
- one scenario drives both packages' ``FleetSupervisor`` with the same
  ``spawn_fn`` (real python children on the daemon's ready-line
  contract, as tests/test_supervisor.py:43-100), ``probe_fn`` and
  ``random.Random(7)``: place 2, a pid death and its respawn, K deaths to
  ``quarantined``, ``unquarantine``, a drain escalated to SIGKILL. The
  manifests are equal after every step (pids, instants and
  ``supervisor_pid`` normalised) and so are the event streams, line for
  line;
- ``fleet.json`` crosses between the packages both ways: a successor of
  the other package adopts the live pids (no spawn), reaps the stale
  ones and finishes an interrupted drain; both routers rebuild their
  replica table and ``supervision`` view from either package's manifest;
  the JAX ``tools/scrub_store.py`` classifies a port fleet dir's leftover
  snapshots as ``stale_membership``;
- ``index supervise`` (no --device) takes the JAX parser's flags action
  by action; killed mid-spawn by ``supervisor_spawn:kill:skip=1``, its
  successor adopts without spawning twice;
- the fleet autoscaler places and drains through the supervisor as the
  JAX controller does on the same snapshots.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from drep_tpu.autoscale import fleet as jax_fleet  # noqa: E402
from drep_tpu.autoscale import policy as jax_policy  # noqa: E402
from drep_tpu.serve import router as jax_router  # noqa: E402
from drep_tpu.serve import supervisor as jax_sup  # noqa: E402
from drep_tpu.utils import durableio as jax_durableio  # noqa: E402
from drep_tpu.utils import faults as jax_faults  # noqa: E402
from drep_tpu.utils import telemetry as jax_telemetry  # noqa: E402
from drep_tpu_torch.autoscale import fleet, policy  # noqa: E402
from drep_tpu_torch.serve import router  # noqa: E402
from drep_tpu_torch.serve import supervisor as sup  # noqa: E402
from drep_tpu_torch.utils import durableio, faults, telemetry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# package -> (supervisor module, durableio, telemetry)
PKG = {"torch": (sup, durableio, telemetry), "jax": (jax_sup, jax_durableio, jax_telemetry)}
ROUTERS = {"torch": router, "jax": jax_router}


@pytest.fixture(autouse=True)
def _quiet_registries(monkeypatch):
    """No fault spec, no event sink and no supervisor knob of the calling
    shell leaks into a test."""
    for name in list(os.environ):
        if name.startswith(("DREP_TORCH_SUP_", "DREP_TORCH_FAULTS", "DREP_TORCH_EVENTS")):
            monkeypatch.delenv(name)
    yield
    faults.configure(None)
    jax_faults.configure(None)
    telemetry.configure()
    jax_telemetry.configure()


# ---- children on the ready-line contract ---------------------------------------

# a replica stand-in: prints the daemon's JSON ready line on a real pipe and
# sleeps; "stubborn" ignores SIGTERM first (a drain must escalate)
CHILD = ("import json, os, signal, time\n"
         "if {stubborn}:\n"
         "    signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
         "print(json.dumps({{'serving': {addr!r}, 'pid': os.getpid()}}), flush=True)\n"
         "time.sleep(3600)\n")


class _DeadOnArrival:
    """A replica that exits before its ready line."""

    def __init__(self):
        self.pid = 999999  # never consulted: poll() answers first
        self.stdout = None

    def poll(self):
        return 1

    def send_signal(self, sig):
        pass


class _Children:
    """The scenario's spawn_fn: the command's last word picks the kind
    (``live``, ``stubborn`` or ``dead``); addresses count the spawns."""

    def __init__(self):
        self.procs: list = []
        self.envs: list = []

    def __call__(self, argv, env):
        self.envs.append(env)
        kind = argv[-1]
        if kind == "dead":
            return _DeadOnArrival()
        code = CHILD.format(stubborn=kind == "stubborn", addr=f"r:{len(self.procs)}")
        p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
        self.procs.append(p)
        return p

    def kill_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


@pytest.fixture()
def children():
    made: list[_Children] = []

    def make():
        made.append(_Children())
        return made[-1]

    yield make
    for c in made:
        c.kill_all()


def _dead_pid() -> int:
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait(timeout=10)
    return p.pid


def _norm(doc: dict) -> dict:
    """A manifest with the facts that differ between two runs normalised:
    pids and instants to whether they are set, the death ledger to its
    length."""
    out = {k: v for k, v in doc.items() if k not in ("supervisor_pid", "updated_at")}
    out["slots"] = {}
    for sid, s in doc["slots"].items():
        s = dict(s)
        for key in ("pid", "placed_at", "drain_started_at", "next_retry_at"):
            s[key] = s.get(key) is not None
        s["deaths"] = len(s.get("deaths") or [])
        out["slots"][sid] = s
    return out


def _shape(recs: list[dict]) -> list[tuple]:
    return [(r["ev"], r["ph"], tuple(sorted(r.get("args", {})))) for r in recs]


# ---- the lifecycle arithmetic ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_backoff_and_crash_loop_equal_jax(seed):
    rng = random.Random(seed)
    a, b = random.Random(seed + 1), random.Random(seed + 1)
    prev_a = prev_b = 0.0
    for _ in range(60):
        base, cap = rng.choice([0.0, 0.5, 1.0]), rng.choice([0.0, 2.0, 30.0])
        prev_a, prev_b = sup.next_backoff(prev_a, base, cap, a), jax_sup.next_backoff(prev_b, base, cap, b)
        assert prev_a == prev_b and prev_a <= cap
        deaths = sorted(rng.uniform(0, 200) for _ in range(rng.randrange(0, 8)))
        now, k, window = rng.uniform(100, 250), rng.randrange(-1, 5), rng.choice([0.0, 30.0, 60.0])
        assert sup.is_crash_loop(deaths, now, k, window) == jax_sup.is_crash_loop(deaths, now, k, window)
    assert sup.is_crash_loop([940.0, 970.0, 999.0], 1000.0, 3, 60.0)  # a death exactly a window ago counts
    assert not sup.is_crash_loop([939.9, 970.0, 999.0], 1000.0, 3, 60.0)


def test_pid_alive_and_ready_line_as_jax():
    dead = _dead_pid()
    for pid in (os.getpid(), None, -1, "x", dead, str(os.getpid())):
        assert sup.pid_alive(pid) == jax_sup.pid_alive(pid)
    for line in (b'{"serving": "h:1", "pid": 3}\n', "noise", b"\xff", '{"serving": ""}', "[1]", '{"ok": 1}'):
        assert sup._parse_ready(line) == jax_sup._parse_ready(line)
    assert sup.generation_name(12) == jax_sup.generation_name(12) == "fleet.g000012.json"
    for slot in ({"partitions": None}, {"partitions": [3, 1, 2]}, {"partitions": []}):
        assert sup.slot_range_key(slot) == jax_sup.slot_range_key(slot)


# ---- one scenario, both packages ---------------------------------------------------


class _Clock:
    """The supervisor module's `time` during a scenario: its wall clock
    (the manifest's instants: retry times, deaths, drain starts) moves only
    when the scenario says, so every tick of both packages sees the same
    instants however loaded the machine is; `monotonic` and `sleep` (the
    startup waits) stay real."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)

    def __init__(self) -> None:
        self.now = time.time()

    def time(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


def _scenario(pkg: str, root, make_children) -> tuple[list, list]:
    """place 2, a pid death and respawn, K deaths -> quarantined,
    unquarantine, a drain escalated to SIGKILL. Returns the normalised
    manifest after each step and the event records."""
    mod, dio, tel = PKG[pkg]
    clock = _Clock()
    real_time, mod.time = mod.time, clock
    kids = make_children()
    log_dir = str(root / f"log_{pkg}")
    tel.configure(log_dir=log_dir, enabled=True)
    s = mod.FleetSupervisor(str(root / f"fleet_{pkg}"), spawn_fn=kids, spawn_cmd="serve live",
                            probe_fn=lambda addr: True, rng=random.Random(7), backoff_base_s=0.01,
                            backoff_max_s=0.05, crashloop_k=3, crashloop_window_s=60.0, drain_deadline_s=0.2,
                            startup_deadline_s=10.0, heartbeat_s=0.05)
    steps = []

    def snap(what: str) -> None:
        on_disk = mod.load_manifest(s.fleet_dir)
        assert _norm(on_disk) == _norm(s.doc), what
        steps.append((what, _norm(s.doc)))

    def tick_due() -> None:
        clock.advance(0.06)  # past the longest backoff
        s.tick()

    try:
        placed = s.place(count=2)
        assert [p["state"] for p in placed] == ["healthy", "healthy"]
        snap("place 2")
        kids.procs[0].kill()
        kids.procs[0].wait(timeout=10)
        s.tick()
        snap("death booked")
        tick_due()
        snap("respawned")
        (dead,) = s.place(count=1, spawn_cmd="serve dead")
        snap("dead on arrival")
        tick_due()
        tick_due()
        assert s.doc["slots"][dead["slot_id"]]["state"] == "quarantined"
        snap("quarantined")
        s.tick()
        snap("quarantine holds")
        s.unquarantine(dead["slot_id"])
        snap("unquarantined")
        s.tick()
        snap("respawned into backoff")
        (stubborn,) = s.place(partitions=[1, 0], count=1, spawn_cmd="serve stubborn")
        assert stubborn["state"] == "healthy"
        (victim,) = s.drain(partitions=[0, 1], count=1)
        assert victim["slot_id"] == stubborn["slot_id"]
        snap("draining")
        clock.advance(0.3)  # past the drain deadline
        time.sleep(0.05)
        s.tick()
        assert s.doc["slots"][victim["slot_id"]]["escalations"] == 1
        snap("escalated")
        s.tick()
        assert victim["slot_id"] not in s.doc["slots"]
        snap("retired")
        assert all(e[sup.SPAWNED_ENV if pkg == "torch" else "DREP_TPU_" + "AUTOSCALE_SPAWNED"] == "1"
                   for e in kids.envs)
    finally:
        mod.time = real_time
        tel.close()
        kids.kill_all()
    return steps, telemetry.read_events(log_dir)


def test_supervisor_scenario_manifests_and_events_equal_jax(tmp_path, children):
    got, got_events = _scenario("torch", tmp_path, children)
    want, want_events = _scenario("jax", tmp_path, children)
    assert [w for w, _ in got] == [w for w, _ in want]
    for (what, g), (_, w) in zip(got, want):
        assert g == w, what
    assert _shape(got_events) == _shape(want_events)
    kinds = [r["ev"] for r in got_events]
    for ev in ("supervisor_spawn", "supervisor_death", "supervisor_quarantine", "supervisor_unquarantine",
               "supervisor_drain", "supervisor_escalation"):
        assert ev in kinds, ev


def test_manifest_checked_snapshots_and_rot_as_jax(tmp_path):
    """The checked JSON, the kept snapshots and the refusal of a rotted
    manifest, as tests/test_supervisor.py:224 pins them for the JAX
    package; each package reads the other's manifest."""
    s = sup.FleetSupervisor(str(tmp_path / "fleet"), spawn_fn=lambda argv, env: _DeadOnArrival(),
                            spawn_cmd="x", probe_fn=lambda a: True, rng=random.Random(7), backoff_base_s=0.0,
                            backoff_max_s=0.0)
    s.place(count=2)
    doc = sup.load_manifest(s.fleet_dir)
    assert doc == jax_sup.load_manifest(s.fleet_dir)
    assert doc["generation"] == s.doc["generation"] == 4 and doc["supervisor_pid"] == os.getpid()
    with open(sup.manifest_path(s.fleet_dir)) as f:
        assert durableio.JSON_CRC_KEY in json.load(f)
    gens = sorted(n for n in os.listdir(s.fleet_dir) if n.startswith("fleet.g"))
    assert gens == ["fleet.g000003.json", "fleet.g000004.json"]
    path = sup.manifest_path(s.fleet_dir)
    with open(path, "rb") as f:
        body = f.read()
    with open(path, "wb") as f:
        f.write(body.replace(b'"slots"', b'"slotz"', 1))
    for mod, dio in ((sup, durableio), (jax_sup, jax_durableio)):
        with pytest.raises(dio.CorruptPayloadError):
            mod.load_manifest(s.fleet_dir)


def test_spawn_silent_replica_times_out_and_is_reaped(tmp_path):
    """A replica that lives but never prints costs the startup deadline
    (a non-blocking read of the real pipe), and is killed and reaped."""
    procs = []

    def spawn_fn(argv, env):
        p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"], stdout=subprocess.PIPE,
                             text=True)
        procs.append(p)
        return p

    s = sup.FleetSupervisor(str(tmp_path / "fleet"), spawn_fn=spawn_fn, spawn_cmd="x", startup_deadline_s=0.5,
                            crashloop_k=0, probe_fn=lambda a: True)
    t0 = time.monotonic()
    (slot,) = s.place(count=1)
    assert time.monotonic() - t0 < 10.0
    assert slot["state"] == "backoff" and "no ready line" in slot["last_death_reason"]
    assert procs[0].poll() == -signal.SIGKILL and not sup.pid_alive(procs[0].pid)
    assert s.drain(count=0) == [] and s.drain(count=-2) == []


# ---- the manifest across the packages ---------------------------------------------


def _slot(sid, address, pid, state="healthy", partitions=None, **kw):
    s = {"slot_id": sid, "partitions": partitions, "address": address, "pid": pid, "spawn_cmd": None,
         "state": state, "restarts": 0, "escalations": 0, "deaths": [], "last_death_reason": None,
         "next_retry_at": None, "backoff_s": 0.0, "quarantine_reason": None, "placed_at": time.time(),
         "drain_started_at": None}
    s.update(kw)
    return s


def _manifest_with(dio, fleet_dir: str, slots: dict, supervisor_pid=None) -> str:
    os.makedirs(fleet_dir, exist_ok=True)
    doc = {"version": 1, "generation": 5, "supervisor_pid": supervisor_pid or _dead_pid(),
           "next_slot": len(slots), "updated_at": time.time(), "slots": slots}
    dio.atomic_write_json(os.path.join(fleet_dir, "fleet.json"), doc)
    return fleet_dir


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_successor_of_the_other_package_adopts(tmp_path, children, writer, reader):
    """A fleet placed by one package's supervisor, whose supervisor then
    dies, is adopted by the other's: the live pids kept (no spawn), a
    stale pid reaped into backoff, a quarantine kept, an interrupted drain
    of a dead pid retired, the generation advanced; the first package
    reads the successor's manifest back."""
    kids = children()
    fleet_dir = str(tmp_path / "fleet")
    first = PKG[writer][0].FleetSupervisor(fleet_dir, spawn_fn=kids, spawn_cmd="serve live",
                                           probe_fn=lambda a: True, rng=random.Random(7))
    first.place(count=2)
    doc = first.doc
    dead = _dead_pid()
    doc["slots"]["s002"] = _slot("s002", "stale:1", dead)
    doc["slots"]["s003"] = _slot("s003", "quar:1", dead, state="quarantined", quarantine_reason="crash loop: pinned")
    doc["slots"]["s004"] = _slot("s004", "gone:1", dead, state="draining", drain_started_at=time.time() - 100)
    first._publish()
    gen, pids = doc["generation"], {sid: doc["slots"][sid]["pid"] for sid in ("s000", "s001")}
    del first
    spawned = []
    succ = PKG[reader][0].FleetSupervisor(fleet_dir, spawn_fn=lambda argv, env: spawned.append(argv),
                                          probe_fn=lambda addr: addr.startswith("r:"), backoff_base_s=0.0,
                                          backoff_max_s=0.0, crashloop_k=3, crashloop_window_s=60.0)
    out = succ.recover()
    assert out == {"adopted": ["s000", "s001"], "reaped": ["s002"], "retired": ["s004"], "quarantined": ["s003"]}
    assert spawned == []
    back = PKG[writer][0].load_manifest(fleet_dir)
    assert back["generation"] == gen + 1 and back["supervisor_pid"] == os.getpid()
    assert {sid: back["slots"][sid]["pid"] for sid in pids} == pids
    assert back["slots"]["s002"]["state"] == "backoff" and "stale pid" in back["slots"]["s002"]["last_death_reason"]
    assert back["slots"]["s003"]["state"] == "quarantined" and "s004" not in back["slots"]


def _router_shim(mod, fleet_dir):
    cfg = mod.RouterConfig(index_loc="unused", fleet_manifest=fleet_dir)
    return types.SimpleNamespace(cfg=cfg, table=mod.ReplicaTable([], probe_backoff_s=0.1, probe_max_s=1.0))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_both_routers_rebuild_from_either_manifest(tmp_path, children, writer):
    """Both routers join the healthy slots of either package's manifest
    with their scopes, skip the unroutable ones, and report the same
    supervision view; a rotted manifest is a warning, not a crash."""
    kids = children()
    live = kids(["live"], {})
    live.stdout.readline()
    fleet_dir = _manifest_with(PKG[writer][1], str(tmp_path / "fleet"), {
        "s000": _slot("s000", "a:1", live.pid, partitions=[0, 2]),
        "s001": _slot("s001", "b:1", live.pid),
        "s002": _slot("s002", None, None, state="backoff"),
        "s003": _slot("s003", "q:1", 1, state="quarantined"),
    })
    seen = {}
    for pkg, mod in ROUTERS.items():
        for path in (fleet_dir, os.path.join(fleet_dir, "fleet.json")):
            shim = _router_shim(mod, path)
            joined = mod.RouterServer._rebuild_membership(shim)
            view = mod.RouterServer._supervision_view(shim)
            hm = shim.table.health_map()["replicas"]
            seen[(pkg, path)] = (sorted(joined), {a: (r["state"], r["assigned"]) for a, r in hm.items()},
                                 sorted(view["slots"]), view["generation"], view["supervisor_alive"])
    assert len(set(map(repr, seen.values()))) == 1, seen
    assert next(iter(seen.values())) == (["a:1", "b:1"], {"a:1": ("healthy", [0, 2]), "b:1": ("healthy", None)},
                                         ["s000", "s001", "s002", "s003"], 5, False)
    with open(os.path.join(fleet_dir, "fleet.json"), "ab") as f:
        f.write(b"garbage")
    for mod in ROUTERS.values():
        shim = _router_shim(mod, fleet_dir)
        assert mod.RouterServer._rebuild_membership(shim) == []
        assert "error" in mod.RouterServer._supervision_view(shim)
        shim.cfg.fleet_manifest = None
        assert mod.RouterServer._supervision_view(shim) is None
    missing = _router_shim(router, str(tmp_path / "nowhere"))
    assert router.RouterServer._rebuild_membership(missing) == []
    assert router.RouterServer._supervision_view(missing) == {"slots": {}, "generation": 0, "supervisor_pid": None}


def test_scrub_classifies_a_port_fleet_dirs_leftovers(tmp_path):
    """tools/scrub_store.py (the JAX package's) on a fleet dir the port's
    supervisor wrote: the snapshots outside the kept window and the
    manifest of a dead supervisor are stale_membership, never damage;
    with --delete the dead-pid slot goes and the quarantined one stays."""
    from tools.scrub_store import scrub

    dead = _dead_pid()
    s = sup.FleetSupervisor(str(tmp_path / "fleet"), spawn_fn=lambda argv, env: _DeadOnArrival(),
                            spawn_cmd="x", probe_fn=lambda a: True, rng=random.Random(7), crashloop_k=1)
    s.place(count=1)  # quarantined at its first death
    s.doc["slots"]["s001"] = _slot("s001", "a:1", dead)
    s._publish()
    s._publish()  # generation 4: snapshots 3 and 4 kept
    doc = sup.load_manifest(s.fleet_dir)
    doc["supervisor_pid"] = dead  # the supervisor is gone
    durableio.atomic_write_json(sup.manifest_path(s.fleet_dir), doc)
    for g in (1, 2):  # snapshots an interrupted publish left behind
        durableio.atomic_write_json(os.path.join(s.fleet_dir, sup.generation_name(g)), dict(doc, generation=g))
    gen = doc["generation"]
    with open(os.devnull, "w") as out:
        rep = scrub([str(tmp_path)], out=out)
        assert rep["damaged"] == []
        assert {os.path.basename(p) for p in rep["stale_membership"]} == {
            "fleet.g000001.json", "fleet.g000002.json", "fleet.json"}
        scrub([str(tmp_path)], delete=True, out=out)
    left = sup.load_manifest(s.fleet_dir)
    assert sorted(left["slots"]) == ["s000"] and left["slots"]["s000"]["state"] == "quarantined"
    assert sorted(n for n in os.listdir(s.fleet_dir) if n.startswith("fleet.g")) == [
        sup.generation_name(gen - 1), sup.generation_name(gen)]


# ---- the CLI ------------------------------------------------------------------------


def _options(build_parser) -> dict:
    def sub(parser, dest):
        return next(a for a in parser._subparsers._group_actions if a.dest == dest)

    v = sub(sub(build_parser(), "operation").choices["index"], "index_op").choices["supervise"]
    return {(a.dest, tuple(a.option_strings)): (type(a).__name__, a.default, a.type, a.nargs, a.choices,
                                                 a.required, a.metavar) for a in v._actions}


def test_supervise_parser_equals_jax_action_by_action():
    """`index supervise` takes the JAX CLI's flags, action by action, and
    no --device: the supervisor uses no device."""
    from drep_tpu.argparser import build_parser as jax_build_parser
    from drep_tpu.argparser import parse_args as jax_parse_args
    from drep_tpu_torch.argparser import build_parser, parse_args

    assert _options(build_parser) == _options(jax_build_parser)
    argv = ["index", "supervise", "/tmp/idx", "--spawn", "index serve x", "--replica", "2", "--replica", "1=0-2,5",
            "--router", "h:1", "--crashloop_k", "4", "--ticks", "3"]
    assert vars(parse_args(argv)) == vars(jax_parse_args(argv))
    assert parse_args(["index", "route", "/tmp/idx", "--fleet_manifest", "/tmp/fleet"]).fleet_manifest == "/tmp/fleet"


# a stub replica speaking enough of the serve wire for the supervisor's
# /healthz probe: a status op answered, any other op refused
STUB_REPLICA = """import json, os, socket, sys, threading
srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
srv.bind(("127.0.0.1", 0))
srv.listen(8)
def serve(conn):
    with conn, conn.makefile("rb") as r:
        for line in r:
            text = line.decode().strip()
            if ',"crc":' in text:
                text = text.rsplit(',"crc":', 1)[0] + "}"
            req = json.loads(text)
            reply = {"ok": True, "id": req.get("id"), "status": {"role": "stub"}}
            if req.get("op") != "status":
                reply = {"ok": False, "id": req.get("id"), "reason": "unsupported"}
            conn.sendall((json.dumps(reply) + "\\n").encode())
def accept():
    while True:
        conn, _ = srv.accept()
        threading.Thread(target=serve, args=(conn,), daemon=True).start()
threading.Thread(target=accept, daemon=True).start()
with open(sys.argv[1], "a") as f:
    f.write(f"{os.getpid()}\\n")
print(json.dumps({"serving": "127.0.0.1:%d" % srv.getsockname()[1], "pid": os.getpid()}), flush=True)
threading.Event().wait()
"""


def _supervise(tmp_path, fleet_dir, spawn_log, extra_env=None, ticks=2):
    """One `index supervise` run to its end; its output in files (the
    replicas it spawns inherit its stderr and outlive it, so a pipe would
    never close). Returns (exit code, stdout, stderr)."""
    stub = tmp_path / "stub_replica.py"
    stub.write_text(STUB_REPLICA)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
    argv = [sys.executable, "-m", "drep_tpu_torch", "index", "supervise", str(tmp_path / "root"),
            "--fleet_dir", fleet_dir, "--spawn", f"{sys.executable} {stub} {spawn_log}", "--replica", "2",
            "--heartbeat_s", "0.05", "--ticks", str(ticks)]
    out_path, err_path = tmp_path / "sup.out", tmp_path / "sup.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        rc = subprocess.run(argv, cwd=REPO, env=env, stdout=out, stderr=err, timeout=300).returncode
    return rc, out_path.read_text(), err_path.read_text()


def test_supervise_killed_mid_spawn_successor_adopts(tmp_path):
    """`index supervise` with supervisor_spawn:kill:skip=1 dies at its
    second spawn, after the manifest recorded that slot's intent; the
    successor adopts the first replica (its pid unchanged), spawns the
    interrupted slot exactly once, and prints the ready line."""
    fleet_dir, spawn_log = str(tmp_path / "fleet"), str(tmp_path / "spawned.txt")
    os.makedirs(tmp_path / "root")
    pids = []
    try:
        rc, out, err = _supervise(tmp_path, fleet_dir, spawn_log, {"DREP_TORCH_FAULTS": "supervisor_spawn:kill:skip=1"})
        assert rc == -signal.SIGKILL, err[-3000:]
        assert out == ""  # no ready line: it died placing
        with open(spawn_log) as f:
            pids = [int(x) for x in f.read().split()]
        assert len(pids) == 1
        doc = sup.load_manifest(fleet_dir)
        assert {s: (x["state"], x["pid"]) for s, x in doc["slots"].items()} == {
            "s000": ("healthy", pids[0]), "s001": ("starting", None)}
        gen = doc["generation"]
        # the interrupted slot books a death at recovery and respawns after
        # its backoff (0.5 s): 40 ticks of 0.05 s outlast it
        rc, out, err = _supervise(tmp_path, fleet_dir, spawn_log, ticks=40)
        assert rc == 0, err[-3000:]
        ready = json.loads(out.splitlines()[0])
        assert ready["slots"] == 2 and ready["adopted"] == 1 and ready["supervising"] == fleet_dir
        with open(spawn_log) as f:
            pids = [int(x) for x in f.read().split()]
        assert len(pids) == 2  # the interrupted slot spawned once, the live one adopted
        doc = sup.load_manifest(fleet_dir)
        assert doc["slots"]["s000"]["pid"] == pids[0] and doc["slots"]["s001"]["pid"] == pids[1]
        assert all(x["state"] == "healthy" for x in doc["slots"].values()) and doc["generation"] > gen
        assert not os.listdir(tmp_path / "root")  # nothing under the root
    finally:
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


@pytest.mark.parametrize("flags,what", [(["--events", "on"], "needs --log_dir"),
                                        (["--log_dir", "ROOT/log"], "inside the index directory"),
                                        (["--replica", "two"], "bad --replica spec")])
def test_supervise_refusals_before_anything_is_written(tmp_path, flags, what, caplog):
    """As the JAX CLI: tracing without a log dir, a log dir inside the
    index and a malformed --replica refuse with the one `!!!` line, and
    nothing is written."""
    from drep_tpu_torch.controller import main as torch_main
    from drep_tpu_torch.utils.logger import get_logger

    root = tmp_path / "root"
    root.mkdir()
    argv = ["index", "supervise", str(root), "--fleet_dir", str(tmp_path / "fleet"),
            *[f.replace("ROOT", str(root)) for f in flags]]
    # read the `!!!` line from the port's own logger: once any workflow of
    # the process ran setup_logger, that logger no longer propagates to the
    # root logger caplog listens on
    logger = get_logger()
    logger.addHandler(caplog.handler)
    try:
        with pytest.raises(SystemExit):
            torch_main(argv)
    finally:
        logger.removeHandler(caplog.handler)
    assert what in caplog.text
    assert not os.listdir(root) and not os.path.exists(tmp_path / "fleet")


# ---- the autoscaler's actuation -------------------------------------------------------


class _FakeSupervisor:
    """Records place/drain/tick; places healthy slots, drains the newest."""

    spawn_cmd = "serve x"

    def __init__(self):
        self.calls: list = []
        self.n = 0

    def tick(self):
        self.calls.append(("tick",))

    def place(self, partitions=None, count=1):
        self.calls.append(("place", partitions, count))
        out = []
        for _ in range(count):
            out.append({"slot_id": f"s{self.n:03d}", "state": "healthy", "address": f"r:{self.n}"})
            self.n += 1
        return out

    def drain(self, partitions=None, count=1, address=None):
        self.calls.append(("drain", partitions, count))
        return [{"slot_id": "s000", "address": "r:0"}][:count]

    def slots(self):
        return {}


def _status(queues: dict) -> dict:
    reps = {}
    for i, (scope, depths) in enumerate(sorted(queues.items())):
        for j, q in enumerate(depths):
            reps[f"h:{i}{j}"] = {"state": "healthy", "assigned": None if scope == "all" else
                                 [int(p) for p in scope.split(",")], "queue_depth": q, "draining": False}
    return {"replicas": {"replicas": reps}}


def test_autoscaler_actuates_as_jax_on_the_same_snapshots(tmp_path):
    """The same snapshots through both controllers, each with a recording
    supervisor: the same decisions, actuation strings, history, supervisor
    calls and decision-log keys (tests/test_supervisor.py:484)."""
    snaps = [_status({"0,1": [40], "2,3": [0, 0]}), _status({"0,1": [40, 30], "2,3": [0, 0]}),
             _status({"all": [5, 5, 5]}), _status({"0,1": [0], "2,3": [90]})]
    seen = {}
    for pkg, (fl, pol) in {"torch": (fleet, policy), "jax": (jax_fleet, jax_policy)}.items():
        it = iter(snaps)
        fake = _FakeSupervisor()
        log = str(tmp_path / f"{pkg}.jsonl")
        ctl = fl.FleetAutoscaleController(types.SimpleNamespace(status=lambda: next(it)),
                                          pol.Targets(deadline_at=None, cost_proc_s=2.0, min_procs=1, max_procs=3,
                                                      cooldown_s=0.0, max_spawn=1),
                                          queue_deadline_s=5.0, svc_s=0.2, decision_log=log, supervisor=fake)
        out = [{k: (d.verdict, d.delta, d.reason) for k, d in ctl.poll_once().items()} for _ in snaps]
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        seen[pkg] = (out, fake.calls, [(r["range"], r["actuation"], sorted(r)) for r in recs],
                     {k: [(h["verdict"], h["delta"]) for h in v] for k, v in ctl.history.items()})
    assert seen["torch"] == seen["jax"]
    verdicts = [v for tick in seen["torch"][0] for v, _, _ in tick.values()]
    assert "scale_up" in verdicts and "scale_down" in verdicts
    assert ("place", [0, 1], 1) in seen["torch"][1] and any(c[0] == "drain" for c in seen["torch"][1])


def test_autoscaler_drains_the_newest_slot_from_the_manifest(tmp_path, children):
    """A restarted controller's fresh supervisor adopts both replicas and
    drains the most recently placed one, then the other, then has nothing,
    as the JAX controller does (tests/test_supervisor.py:484)."""
    for pkg, (mod, fl, pol) in {"torch": (sup, fleet, policy), "jax": (jax_sup, jax_fleet, jax_policy)}.items():
        kids = children()
        a = mod.FleetSupervisor(str(tmp_path / pkg), spawn_fn=kids, spawn_cmd="serve live",
                                probe_fn=lambda addr: True, rng=random.Random(7))
        a.place(count=1)
        time.sleep(0.02)
        a.place(count=1)
        del a
        b = mod.FleetSupervisor(str(tmp_path / pkg), spawn_fn=kids, spawn_cmd="serve live",
                                probe_fn=lambda addr: True, rng=random.Random(7))
        assert b.recover()["adopted"] == ["s000", "s001"]
        ctl = fl.FleetAutoscaleController(types.SimpleNamespace(status=lambda: {}), pol.Targets(deadline_at=None),
                                          queue_deadline_s=5.0, svc_s=0.1, supervisor=b)
        assert "draining ['r:1']" in ctl._drain_replica("all", 1), pkg
        kids.procs[1].wait(timeout=10)
        b.tick()
        assert "s001" not in b.doc["slots"] and b.doc["slots"]["s000"]["state"] == "healthy"
        assert "draining ['r:0']" in ctl._drain_replica("all", 1)
        assert ctl._drain_replica("all", 1).startswith("skipped")


def test_autoscaler_spawn_needs_a_manifest_home_as_jax(tmp_path):
    client = types.SimpleNamespace(status=lambda: {}, request=lambda o: {})
    for fl, pol in ((fleet, policy), (jax_fleet, jax_policy)):
        with pytest.raises(ValueError, match="fleet_dir"):
            fl.FleetAutoscaleController(client, pol.Targets(deadline_at=None), queue_deadline_s=5.0, svc_s=0.1,
                                        spawn_cmd="index serve x")
        ctl = fl.FleetAutoscaleController(client, pol.Targets(deadline_at=None), queue_deadline_s=5.0, svc_s=0.1)
        assert ctl.supervisor is None
        assert ctl._spawn_replica("all", 1).startswith("skipped") and ctl._drain_replica("all", 1).startswith("skipped")
    ctl = fleet.FleetAutoscaleController(client, policy.Targets(deadline_at=None), queue_deadline_s=5.0, svc_s=0.1,
                                         fleet_dir=str(tmp_path / "fleet"))
    assert isinstance(ctl.supervisor, sup.FleetSupervisor) and ctl.supervisor.doc["generation"] == 1
