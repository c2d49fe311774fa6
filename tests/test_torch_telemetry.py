"""The port's event tracing (drep_tpu_torch/utils/telemetry.py), --profile
and the stage counters against the JAX package's, on the CPU.

- off is the default: no file, one shared no-op span; the env gate
  ``DREP_TORCH_EVENTS`` with an explicit flag winning over it;
- the line format is the JAX package's, so ``tools/trace_report.py`` and
  ``tools/scrub_store.py`` read a port log dir unchanged; a SIGKILL tears
  at most the final line; the run id survives a resume; a trace that
  cannot be written raises;
- ``compare``, ``dereplicate`` and ``compare --streaming_primary`` with
  ``--events on`` give the JAX package's ordered (ev, ph) list with the
  same arg keys on the same argv;
- ``--profile`` writes a Chrome trace (by default under
  ``<wd>/log/torch_trace``) and still writes ``perf_counters.json``;
- the serve daemon and the router leave the JAX package's serve events.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402

from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.workflows import compare_wrapper as jax_compare  # noqa: E402
from drep_tpu.workflows import dereplicate_wrapper as jax_dereplicate  # noqa: E402
from drep_tpu_torch.controller import main as torch_main  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig  # noqa: E402
from drep_tpu_torch.serve.router import RouterConfig, RouterServer  # noqa: E402
from drep_tpu_torch.utils import telemetry  # noqa: E402
from drep_tpu_torch.utils.profiling import Counters  # noqa: E402
from drep_tpu_torch.workflows import compare_wrapper, dereplicate_wrapper  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _sink_off(monkeypatch):
    """Each test starts with tracing off and the env gate unset."""
    monkeypatch.delenv(telemetry.EVENTS_ENV, raising=False)
    telemetry.configure()
    yield
    telemetry.configure()


@pytest.fixture(scope="module")
def genome_paths():
    return sorted(glob.glob(os.path.join(REPO, "tests", "genomes", "*.fasta")))


def _events(log_dir: str) -> list[dict]:
    return telemetry.read_events(log_dir)


def _shape(recs: list[dict]) -> list[tuple]:
    return [(r["ev"], r["ph"], tuple(sorted(r.get("args", {})))) for r in recs]


# ---- the sink ----------------------------------------------------------------


def test_off_by_default_creates_no_file(tmp_path, genome_paths):
    assert telemetry.configure(log_dir=str(tmp_path / "log")) is False
    telemetry.event("x", a=1)
    with telemetry.span("y"):
        pass
    assert not (tmp_path / "log").exists()
    wd = tmp_path / "wd"
    compare_wrapper(str(wd), genome_paths, device="cpu", skip_plots=True, processes=1)
    logs = os.listdir(wd / "log")
    assert not [f for f in logs if f.startswith("events.")] and "perf_counters.json" in logs


def test_noop_span_is_shared():
    assert telemetry.span("a") is telemetry.span("b", k=1)
    telemetry.configure(log_dir="/nonexistent-never-created", enabled=False)
    assert telemetry.span("a") is telemetry.span("c")


@pytest.mark.parametrize("env,flag,want", [
    (None, None, False), ("on", None, True), ("1", "off", False), ("off", "on", True), ("0", True, True),
])
def test_env_gate_with_explicit_flag_winning(tmp_path, monkeypatch, env, flag, want):
    if env is not None:
        monkeypatch.setenv(telemetry.EVENTS_ENV, env)
    assert telemetry.configure(log_dir=str(tmp_path), enabled=flag) is want
    assert telemetry.configure(log_dir=None, enabled=True) is False  # no log dir: off


def test_line_format_and_run_id_survive_a_resume(tmp_path):
    log = str(tmp_path / "log")
    telemetry.configure(log_dir=log, enabled=True, pid=3)
    with telemetry.span("stage:x", k=1):
        telemetry.event("fault", kind="retries", n=1)
    telemetry.configure(log_dir=log, enabled=True, pid=3)  # a resume: a new sink on the same dir
    telemetry.event("run_finished", pairs=0)
    telemetry.close()
    recs = _events(log)
    assert os.path.exists(os.path.join(log, "events.p3.jsonl"))
    assert [list(r) for r in recs][0] == ["run", "pid", "epoch", "ev", "ph", "mono", "wall", "args"]
    assert len({r["run"] for r in recs}) == 1 and {r["pid"] for r in recs} == {3}
    assert [(r["ev"], r["ph"]) for r in recs] == [("stage:x", "B"), ("fault", "i"), ("stage:x", "E"),
                                                  ("run_finished", "i")]
    assert recs[2]["args"]["k"] == 1 and recs[2]["args"]["dur"] >= 0
    assert telemetry.open_spans(recs) == {}
    other = str(tmp_path / "other")
    telemetry.configure(log_dir=other, enabled=True)
    telemetry.event("x")
    telemetry.close()
    assert _events(other)[0]["run"] != recs[0]["run"]


def test_span_records_the_error_and_unwritable_trace_raises(tmp_path):
    telemetry.configure(log_dir=str(tmp_path), enabled=True)
    with pytest.raises(KeyError):
        with telemetry.span("s"):
            raise KeyError("x")
    assert _events(str(tmp_path))[-1]["args"]["error"] == "KeyError"
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    telemetry.configure(log_dir=str(blocker / "log"), enabled=True)
    with pytest.raises(OSError):
        telemetry.event("x")


def test_sigkill_tears_at_most_the_final_line(tmp_path):
    """A process emitting as fast as it can, SIGKILLed: every line but the
    last parses; the port's reader skips the torn tail and the JAX
    package's trace_report renders the log."""
    log = str(tmp_path / "log")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from drep_tpu_torch.utils import telemetry\n"
            "telemetry.configure(log_dir=%r, enabled=True)\n"
            "i = 0\n"
            "while True:\n"
            "    with telemetry.span('stripe', bi=i, pad='x' * 512):\n"
            "        telemetry.event('shard_publish', shard=i)\n"
            "    i += 1\n" % (REPO, log))
    proc = subprocess.Popen([sys.executable, "-c", code])
    path = os.path.join(log, "events.p0.jsonl")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (not os.path.exists(path) or os.path.getsize(path) < 200_000):
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    with open(path) as f:
        lines = f.read().split("\n")
    tail = lines.pop()  # "" after a whole last line, else the torn one
    for line in lines[:-1]:
        json.loads(line)
    recs = _events(log)
    assert len(recs) >= len(lines) - 1 + (tail == "")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "trace_report.py"), log],
                         capture_output=True, text=True, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


# ---- the workflows against the JAX package -----------------------------------


@pytest.mark.parametrize("what", ["compare", "dereplicate", "streaming_primary"])
def test_event_stream_equals_jax(tmp_path, genome_paths, what):
    """The same argv through both packages: the same ordered (ev, ph) list
    with the same arg keys, stage spans and run_finished included. No
    count differs on these argvs (the secondary's calls, the streaming
    walk's stripes and shard publishes are the JAX package's one for
    one)."""
    run = {"dereplicate": (jax_dereplicate, dereplicate_wrapper)}.get(what, (jax_compare, compare_wrapper))
    kw = {"streaming_primary": True} if what == "streaming_primary" else {}
    run[0](str(tmp_path / "j"), genome_paths, skip_plots=True, processes=1, events="on", **kw)
    run[1](str(tmp_path / "t"), genome_paths, skip_plots=True, processes=1, events="on", device="cpu", **kw)
    mine, theirs = _events(str(tmp_path / "t" / "log")), _events(str(tmp_path / "j" / "log"))
    assert _shape(mine) == _shape(theirs)
    assert telemetry.open_spans(mine) == {}
    assert mine[-1]["ev"] == "run_finished" and mine[-1]["args"] == theirs[-1]["args"]


def test_trace_report_and_scrubber_read_a_port_workdir(tmp_path, genome_paths):
    wd = str(tmp_path / "wd")
    torch_main(["compare", wd, "-g", *genome_paths, "--device", "cpu", "--skip_plots", "-p", "1", "--events", "on",
                "--streaming_primary"])
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "trace_report.py"), os.path.join(wd, "log")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "stage:primary_compare" in out.stdout and "stage critical path" in out.stdout
    assert os.path.exists(os.path.join(wd, "log", "trace.json"))
    scrub = subprocess.run([sys.executable, os.path.join(REPO, "tools", "scrub_store.py"), wd],
                           capture_output=True, text=True, timeout=300)
    assert scrub.returncode == 0, scrub.stdout[-2000:] + scrub.stderr[-2000:]


@pytest.mark.parametrize("where", ["default", "given"])
def test_profile_writes_a_chrome_trace_and_the_counters(tmp_path, genome_paths, where):
    wd = tmp_path / "wd"
    argv = ["compare", str(wd), "-g", *genome_paths, "--device", "cpu", "--skip_plots", "-p", "1", "--profile"]
    if where == "given":
        argv.append(str(tmp_path / "prof"))
    torch_main(argv)
    trace = (wd / "log" / "torch_trace" if where == "default" else tmp_path / "prof") / "trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    with open(wd / "log" / "perf_counters.json") as f:
        rep = json.load(f)
    assert rep["stages"]["primary_compare"]["pairs"] == 10 and rep["total"]["pairs"] == 14


def test_counters_stage_and_fault_trace_as_jax(tmp_path):
    """``Counters.stage`` is a ``stage:<name>`` span, ``add_fault`` a
    ``fault`` instant, ``note_epoch`` an ``epoch`` instant and a stamped
    epoch on every later line, as in the JAX package."""
    telemetry.configure(log_dir=str(tmp_path), enabled=True)
    c = Counters()
    with c.stage("secondary_compare", pairs=6):
        c.add_fault("retries")
    c.note_epoch(2, "death")
    telemetry.event("after")
    telemetry.close()
    recs = _events(str(tmp_path))
    assert [(r["ev"], r["ph"]) for r in recs] == [("stage:secondary_compare", "B"), ("fault", "i"),
                                                  ("stage:secondary_compare", "E"), ("epoch", "i"), ("after", "i")]
    assert recs[1]["args"] == {"kind": "retries", "n": 1} and recs[-1]["epoch"] == 2
    rep = c.report()
    assert rep["stages"]["secondary_compare"]["pairs"] == 6 and rep["epoch_history"][0]["reason"] == "death"


# ---- serving -------------------------------------------------------------------


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    td = tmp_path_factory.mktemp("tele_fed")
    paths = lib.write_genome_set(str(td / "g"), [3, 2, 2], seed=3)
    loc = str(td / "fed")
    jax_build_federated(loc, paths, 3, processes=1, length=0)
    return loc, paths


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


def test_daemon_and_router_events(tmp_path, fed):
    """A traced fleet in one process (the router and two scoped replicas
    share the event log): the daemons' serve_load/serve_start, a
    serve_batch span a batch, route_start, one partition_classify span a
    scatter leg, serve_drain/serve_stop, every span closed."""
    loc, paths = fed
    log = str(tmp_path / "log")
    telemetry.configure(log_dir=log, enabled=True)
    kw = {"batch_window_ms": 20.0, "max_batch": 16, "poll_generation_s": 60.0}
    reps = [_serve(IndexServer(ServeConfig(index_loc=loc, device=CPU, **kw))) for _ in range(2)]
    rt, ra, trt = _serve(RouterServer(RouterConfig(index_loc=loc, replicas=[f"{reps[0][1]}=0,1", f"{reps[1][1]}=2"],
                                                   device=CPU, leg_timeout_s=120.0, hedge_delay_s=60.0, **kw)))
    try:
        with ServeClient(ra, timeout_s=300) as c:
            resps = c.classify_many(paths[:3])
        assert all(r["ok"] for r in resps)
        legs = sum(srv.stats.legs_total for srv, _a, _t in reps)
        batches = rt.stats.batches_total
    finally:
        _stop(rt, trt)
        for srv, _a, t in reps:
            _stop(srv, t)
        telemetry.close()
    recs = _events(log)
    counts: dict = {}
    for r in recs:
        counts[(r["ev"], r["ph"])] = counts.get((r["ev"], r["ph"]), 0) + 1
    assert telemetry.open_spans(recs) == {}
    assert counts[("serve_load", "E")] == counts[("serve_start", "i")] == 3
    assert counts[("route_start", "i")] == 1 and legs > 0 and counts[("partition_classify", "E")] == legs
    assert counts[("serve_batch", "E")] >= batches and counts[("serve_stop", "i")] == 3
    assert not any(ev.startswith("replica_") for ev, _ in counts)


def test_serve_cli_with_events_runs(tmp_path, fed, monkeypatch):
    """`index serve --events on --log_dir DIR` is accepted (no longer
    refused) and traces into DIR up to the serving loop."""
    from drep_tpu_torch import workflows

    loc, _paths = fed
    seen = []

    def run(server, log_dir):
        server.start()
        seen.append((telemetry.enabled(), log_dir))
        server.close()
        return 0

    monkeypatch.setattr(workflows, "_run_server", run)
    torch_main(["index", "serve", loc, "--device", "cpu", "--socket", str(tmp_path / "s.sock"), "--events", "on",
                "--log_dir", str(tmp_path / "log")])
    telemetry.close()
    assert seen == [(True, str(tmp_path / "log"))]
    evs = [r["ev"] for r in _events(str(tmp_path / "log"))]
    assert evs[:3] == ["serve_load", "serve_load", "serve_start"] and evs[-1] == "serve_stop"
