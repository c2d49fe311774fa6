"""`python -m drep_tpu_torch index ...` against `python -m drep_tpu index
...` on the fixture genomes, on the CPU: the same verdict lines on stdout
and the same store (compared as tests/test_torch_index.py compares
them), the refusals of what is not ported, and the guard that the index
path loads nothing of JAX or drep_tpu."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_stores_match, assert_verdicts_match  # noqa: E402

from drep_tpu.controller import main as jax_main  # noqa: E402
from drep_tpu_torch.controller import main as torch_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _verdicts(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, genome_paths):
    """Both CLIs: build on A-C, update with D-E, classify A and D (and
    classify again after a heal-only update). Returns the stores and
    the stdout of each classify."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for pkg, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        loc = str(root / pkg)
        capture = []
        for argv in (
            ["build", loc, "-g", *genome_paths[:3]],
            ["update", loc, "-g", *genome_paths[3:]],
            ["classify", loc, "-g", genome_paths[0], genome_paths[3]],
            ["update", loc],
            ["classify", loc, "-g", genome_paths[4]],
        ):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["index", *argv, "-p", "1", *extra])
            capture.append(buf.getvalue())
        out[pkg] = (loc, capture)
    return out


def test_cli_store_equals_jax(cli_runs):
    assert_stores_match(cli_runs["torch"][0], cli_runs["jax"][0])
    with open(os.path.join(cli_runs["torch"][0], "manifest.json")) as f:
        assert json.load(f)["generation"] == 1


@pytest.mark.parametrize("call", [2, 4])
def test_cli_classify_verdict_lines_equal_jax(cli_runs, call):
    got = _verdicts(cli_runs["torch"][1][call])
    want = _verdicts(cli_runs["jax"][1][call])
    assert len(got) == (2 if call == 2 else 1)
    assert_verdicts_match(got, want)
    assert not got[0]["novel_primary"] and got[0]["nearest_dist"] == 0.0


def test_cli_classify_writes_nothing(tmp_path, cli_runs, genome_paths):
    loc = cli_runs["torch"][0]
    before = lib.tree_digest(loc, exclude_dirs=())
    torch_main(["index", "classify", loc, "-g", *genome_paths[1:3], "-p", "1", "--device", "cpu"])
    assert lib.tree_digest(loc, exclude_dirs=()) == before


@pytest.mark.parametrize("op", ["build", "update", "classify", "serve", "route"])
def test_cli_without_device_asks_for_cpu(tmp_path, genome_paths, cli_runs, monkeypatch, op):
    """Without --device the index entry points want cuda; on a machine
    without it they raise asking for cpu, before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loc = str(tmp_path / "new") if op == "build" else cli_runs["torch"][0]
    before = lib.tree_digest(loc, exclude_dirs=()) if op != "build" else None
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(["index", op, loc, *(["-g", genome_paths[0]] if op not in ("serve", "route") else []), "-p", "1"])
    if op == "build":
        assert not os.path.exists(loc)
    else:
        assert lib.tree_digest(loc, exclude_dirs=()) == before


@pytest.fixture(scope="module")
def planted(tmp_path_factory) -> list[str]:
    """40 planted 6 kb genomes in 12 groups of 1-6, in a seeded order."""
    import numpy as np

    rng = np.random.default_rng(21)
    groups = [int(x) for x in rng.integers(1, 7, size=12)]
    groups[-1] += 40 - sum(groups)
    assert groups[-1] > 0
    paths = lib.write_genome_set(str(tmp_path_factory.mktemp("cli_planted")), groups, seed=22)
    return [paths[i] for i in rng.permutation(len(paths))]


# the federated lifecycle both CLIs run: a build over 3 partitions, an
# update, then the maintenance verbs with the flags the port refused
# before they were ported
FED_STEPS = [
    ("build", ["--partitions", "3", "-l", "0", "-ms", "256", "--streaming_block", "128"], (0, 30)),
    ("update", [], (30, 38)),
    ("split", ["--pid", "1"], None),
    ("merge", ["--pids", "1", "2"], None),
    ("compact", ["--min_generations", "2"], None),
]


@pytest.fixture(scope="module")
def fed_cli_runs(tmp_path_factory, planted):
    """Both CLIs through FED_STEPS on one federated root each, the root
    copied aside after every step. Returns {(package, op): root}."""
    import shutil

    root = tmp_path_factory.mktemp("fed_cli")
    out = {}
    for pkg, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        loc = str(root / pkg)
        for op, flags, genomes in FED_STEPS:
            g = ["-g", *planted[genomes[0]:genomes[1]]] if genomes else []
            main(["index", op, loc, *g, *flags, "-p", "1", *extra])
            out[(pkg, op)] = str(root / f"{pkg}_{op}")
            shutil.copytree(loc, out[(pkg, op)])
    return out


@pytest.mark.parametrize("op", [s[0] for s in FED_STEPS])
def test_cli_federated_lifecycle_equals_jax(fed_cli_runs, op):
    """`index build --partitions 3`, `update`, `split --pid 1`, `merge
    --pids 1 2` and `compact --min_generations 2` on the port's CLI leave
    the federation the JAX CLI leaves."""
    assert_stores_match(fed_cli_runs[("torch", op)], fed_cli_runs[("jax", op)])
    with open(os.path.join(fed_cli_runs[("torch", op)], "federation.json")) as f:
        m = json.load(f)
    assert m["n_partitions"] == (4 if op == "split" else 3) and "partial" not in m


@pytest.mark.parametrize("op,args,item", [
    ("supervise", ["--replica", "2"], "11c"),
])
def test_cli_unported_index_ops_raise(tmp_path, cli_runs, op, args, item):
    """`index supervise` (item 11c, ported): both CLIs, with no --spawn
    command, place the two slots, book each a death and print the same
    ready line; the manifests are equal (pids, instants and the jittered
    backoff normalised) and nothing under the index changes."""
    loc = cli_runs["torch"][0]
    before = lib.tree_digest(loc, exclude_dirs=())
    seen = {}
    for pkg, main in (("jax", jax_main), ("torch", torch_main)):
        fleet_dir = str(tmp_path / pkg)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["index", op, loc, *args, "--fleet_dir", fleet_dir, "--ticks", "1"])
        ready = json.loads(buf.getvalue().splitlines()[0])
        with open(os.path.join(fleet_dir, "fleet.json")) as f:
            doc = json.load(f)
        slots = {sid: (x["state"], x["partitions"], x["last_death_reason"], len(x["deaths"]), x["pid"])
                 for sid, x in doc["slots"].items()}
        seen[pkg] = (sorted(ready), ready["slots"], ready["adopted"], ready["supervising"] == fleet_dir,
                     doc["generation"], slots)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-1] == {s: ("backoff", None, "no spawn command for slot", 1, None) for s in ("s000", "s001")}
    assert lib.tree_digest(loc, exclude_dirs=()) == before


def _accepts_durable_io(monkeypatch, argv: list[str], io: dict) -> None:
    """Run an `index serve|route` argv up to the server's run loop (not
    entered): the durable-I/O flags reach utils/durableio.py, read back
    where the server would start serving."""
    from drep_tpu_torch import workflows
    from drep_tpu_torch.utils import durableio

    seen = []
    monkeypatch.setattr(workflows, "_run_server",
                        lambda server, log_dir: seen.append((durableio.io_retries(), durableio.fsync_enabled())) or 0)
    try:
        torch_main(argv)
    finally:
        durableio.configure()
    assert seen == [(io.get("retries", durableio.DEFAULT_IO_RETRIES), io.get("fsync", False))]


@pytest.mark.parametrize("flags,item", [
    (["--events", "on"], "log_dir"),
    (["--io_retries", "5"], None),
    (["--fsync"], None),
])
def test_cli_serve_refusals(tmp_path, cli_runs, flags, item, monkeypatch):
    """`index serve` refuses before anything is loaded what it cannot run
    (``--events on`` without a ``--log_dir``: the daemon writes nothing
    under the index, as the JAX CLI refuses it), and takes the
    durable-I/O flags (item = None) as the JAX CLI does; nothing under
    the index changes either way."""
    loc = cli_runs["torch"][0]
    before = lib.tree_digest(loc, exclude_dirs=())
    argv = [str(tmp_path / "log") if a == "LOG" else a for a in flags]
    if item is None:
        io = {"retries": 5} if "--io_retries" in flags else {"fsync": True}
        _accepts_durable_io(monkeypatch, ["index", "serve", loc, "--device", "cpu",
                                          "--socket", str(tmp_path / "s.sock"), *argv], io)
    else:
        with pytest.raises(SystemExit):  # the CLI's one `!!!` line for a UserInputError
            torch_main(["index", "serve", loc, "--device", "cpu", *argv])
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    assert not os.path.exists(tmp_path / "log")


@pytest.mark.parametrize("flags,item", [
    (["--fleet_manifest", "FLEET", "--log_dir", "LOG"], "11c"),
    (["--events", "on"], "log_dir"),
    (["--io_retries", "5"], None),
])
def test_cli_route_refusals(tmp_path, fed_cli_runs, flags, item, monkeypatch):
    """`index route` refuses before anything is read, bound or written
    ``--events on`` without a ``--log_dir``, as the JAX CLI does; it takes
    the durable-I/O flag (item = None) and, since item 11c, the fleet
    supervisor's manifest: the router it builds holds the manifest's
    healthy slot beside its --replica, with the manifest's ``supervision``
    view, and writes only under --log_dir."""
    loc = fed_cli_runs[("torch", "update")]
    before = lib.tree_digest(loc, exclude_dirs=())
    sub = {"LOG": str(tmp_path / "log"), "FLEET": str(tmp_path / "fleet.json")}
    argv = ["index", "route", loc, "--replica", "127.0.0.1:1", "--device", "cpu",
            "--socket", str(tmp_path / "r.sock"), *[sub.get(a, a) for a in flags]]
    if item is None:
        _accepts_durable_io(monkeypatch, argv, {"retries": 5})
    elif item == "log_dir":
        with pytest.raises(SystemExit):  # the CLI's one `!!!` line for a UserInputError
            torch_main(argv)
    else:
        from drep_tpu_torch import workflows
        from drep_tpu_torch.utils import durableio

        durableio.atomic_write_json(sub["FLEET"], {
            "version": 1, "generation": 2, "supervisor_pid": None, "slots": {
                "s000": {"slot_id": "s000", "partitions": [0], "address": "127.0.0.1:2", "pid": None,
                         "state": "healthy"}}})
        built = []
        monkeypatch.setattr(workflows, "_run_server", lambda server, log_dir: built.append(server) or 0)
        torch_main(argv)
        (srv,) = built
        assert {a: r["assigned"] for a, r in srv.table.health_map()["replicas"].items()} == {
            "127.0.0.1:1": None, "127.0.0.1:2": [0]}
        assert srv._supervision_view()["generation"] == 2 and sorted(srv._supervision_view()["slots"]) == ["s000"]
        assert os.path.isdir(tmp_path / "log")
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    assert not os.path.exists(tmp_path / "r.sock")
    assert os.path.exists(tmp_path / "log") == (item == "11c")


def _spawn_cli(tmp_path, name: str, argv: list[str]):
    """`python -m drep_tpu_torch <argv>` in the background, its stderr in a
    file (a daemon's pipe must not fill); returns (process, ready line
    dict, a reader of the stderr's tail)."""
    err_path = tmp_path / f"{name}.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "drep_tpu_torch", *argv], stdout=subprocess.PIPE,
                                stderr=err, text=True, cwd=REPO)

    def tail() -> str:
        return err_path.read_text()[-3000:]

    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=60)
        raise AssertionError(f"{name} died before its ready line (exit {proc.returncode}): {tail()}")
    return proc, json.loads(line), tail


def _sigterm(proc) -> int:
    import signal

    try:
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def test_cli_serves_a_federated_root(tmp_path, fed_cli_runs, planted):
    """`index serve` on a federated root loads the streaming resident: its
    verdict is the union-assembled `index classify` verdict of that genome
    with full coverage stamps, SIGTERM drains it to exit 0, and the root's
    tree is unchanged."""
    from drep_tpu_torch.index import index_classify
    from drep_tpu_torch.serve import ServeClient

    loc = fed_cli_runs[("torch", "update")]
    before = lib.tree_digest(loc, exclude_dirs=())
    want = index_classify(loc, planted[:1], device="cpu")[0]
    sock = str(tmp_path / "s.sock")
    proc, ready, tail = _spawn_cli(tmp_path, "serve", ["index", "serve", loc, "--device", "cpu", "--socket", sock,
                                                       "--resident_mb", "64"])
    try:
        assert ready["serving"] == sock and ready["generation"] == 1 and ready["n_genomes"] == 38
        with ServeClient(sock, timeout_s=300) as c:
            got = c.classify(planted[0])["verdict"]
            status = c.status()
    finally:
        rc = _sigterm(proc)
    assert rc == 0, tail()
    assert got.pop("partitions_unavailable") == [] and got.pop("partitions_consulted")
    assert got == want
    assert status["partitions"]["n_partitions"] == 3 and status["partitions"]["budget_bytes"] == 64 << 20
    assert lib.tree_digest(loc, exclude_dirs=()) == before


def test_cli_route_starts_and_answers(tmp_path, fed_cli_runs, planted):
    """`index route` parses its flags and starts in front of a replica: its
    verdict is the replica's, SIGTERM drains it to exit 0."""
    import threading

    from drep_tpu_torch.index import classify_batch, load_resident_index, sketch_queries
    from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig

    loc = fed_cli_runs[("torch", "update")]
    fed = load_resident_index(loc, device="cpu")
    want = classify_batch(fed, sketch_queries(fed, planted[:1]), joint=False)[0]
    replica = IndexServer(ServeConfig(index_loc=loc, poll_generation_s=60.0, device="cpu"))
    addr = replica.start()
    loop = threading.Thread(target=replica.serve_batches, daemon=True)
    loop.start()
    sock = str(tmp_path / "r.sock")
    try:
        proc, ready, tail = _spawn_cli(tmp_path, "route", [
            "index", "route", loc, "--replica", addr, "--device", "cpu", "--socket", sock, "--leg_timeout_s", "120",
            "--hedge_delay_s", "60", "--probe_interval_s", "0.2", "--max_inflight", "32",
        ])
        try:
            assert ready["serving"] == sock and ready["generation"] == 1
            with ServeClient(sock, timeout_s=300) as c:
                got = c.classify(planted[0])["verdict"]
                status = c.status()
        finally:
            rc = _sigterm(proc)
        assert rc == 0, tail()
    finally:
        replica.request_drain()
        loop.join(timeout=60)
        replica.close()
    assert got == want and got["partitions_unavailable"] == []
    assert status["role"] == "router" and status["max_queue"] == 32 and status["router"]["forwarded"] == 1
    assert replica.stats.requests_total == 1


@pytest.mark.parametrize("op,flags,item", [
    ("update", ["--io_retries", "5"], None),
    ("classify", ["--fsync"], None),
])
def test_cli_unported_flags_raise(tmp_path, genome_paths, op, flags, item, monkeypatch):
    """The index verbs take the JAX CLI's durable-I/O flags (item = None:
    now run, ROADMAP item 5): the policy is installed before the verb
    runs. A flag the port does not run would raise NotImplementedError
    naming its item before anything is sketched or written."""
    from drep_tpu_torch import index as index_pkg
    from drep_tpu_torch.utils import durableio

    loc = str(tmp_path / "idx")
    argv = ["index", op, loc, "-g", *genome_paths, "--device", "cpu", *flags]
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            torch_main(argv)
        assert not os.path.exists(loc)
        return
    seen = []
    name = {"update": "index_update", "classify": "index_classify"}[op]

    def verb(*a, **k):
        seen.append((durableio.io_retries(), durableio.fsync_enabled()))
        return [] if op == "classify" else {}

    monkeypatch.setattr(index_pkg, name, verb)
    try:
        torch_main(argv)
    finally:
        durableio.configure()
    want = (5, False) if op == "update" else (durableio.DEFAULT_IO_RETRIES, True)
    assert seen == [want]


@pytest.mark.parametrize("op,flags", [
    ("build", ["--partitions", "2"]),
    ("build", ["--fed_pods", "2"]),
    ("update", ["--fed_pods", "2"]),
    ("update", ["--params_file", "HANDOFF"]),
])
def test_cli_federated_flags_run_as_jax(tmp_path, genome_paths, op, flags):
    """The federated flags run as the JAX CLI runs them: `build
    --partitions 2` builds a federation, `--fed_pods` without one is
    ignored, and `update --params_file` materializes a missing store from
    a router's handoff (genomes A-C, then D-E or the handoff)."""
    from drep_tpu_torch.index import load_index, write_params_handoff
    from drep_tpu_torch.index.store import empty_index
    from drep_tpu_torch.index.update import sketch_batch

    handoff = str(tmp_path / "handoff.npz")
    if "HANDOFF" in flags:
        params = load_index(str(_plain_index(tmp_path, genome_paths))).params
        batch, results = sketch_batch(empty_index(params), genome_paths[3:], processes=1)
        write_params_handoff(handoff, params, batch, results)
    argv = [handoff if a == "HANDOFF" else a for a in flags]
    for pkg, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        loc = str(tmp_path / pkg)
        if op == "update" and "HANDOFF" not in flags:
            main(["index", "build", loc, "-g", *genome_paths[:3], "-p", "1", *extra])
        genomes = [] if "HANDOFF" in flags else ["-g", *(genome_paths[3:] if op == "update" else genome_paths)]
        main(["index", op, loc, *genomes, *argv, "-p", "1", *extra])
    assert_stores_match(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert os.path.exists(os.path.join(str(tmp_path / "torch"), "federation.json")) == ("--partitions" in flags)


def _plain_index(tmp_path, genome_paths) -> str:
    loc = str(tmp_path / "params_source")
    torch_main(["index", "build", loc, "-g", *genome_paths[:3], "-p", "1", "--device", "cpu"])
    return loc


def test_cli_federated_root_refuses(tmp_path, fed_cli_runs, planted):
    """`index update` and `index classify` on a federated root run
    through the CLI as the JAX CLI's do (they refused before the
    federation was ported); classify writes nothing under the root."""
    import shutil

    locs = {pkg: shutil.copytree(fed_cli_runs[(pkg, "update")], str(tmp_path / pkg)) for pkg in ("jax", "torch")}
    outs = {}
    for pkg, main, extra in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        main(["index", "update", locs[pkg], "-g", *planted[38:39], "-p", "1", *extra])
        before = lib.tree_digest(locs[pkg], exclude_dirs=())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["index", "classify", locs[pkg], "-g", planted[39], planted[0], "-p", "1", *extra])
        outs[pkg] = _verdicts(buf.getvalue())
        assert lib.tree_digest(locs[pkg], exclude_dirs=()) == before
    assert_stores_match(locs["torch"], locs["jax"])
    assert_verdicts_match(outs["torch"], outs["jax"])
    assert len(outs["torch"]) == 2 and outs["torch"][1]["nearest_dist"] == 0.0


def test_index_cli_subprocess_loads_no_jax_or_drep_tpu(tmp_path, genome_paths):
    """The index path (build, update, classify) in a fresh interpreter
    imports nothing of JAX or drep_tpu; classify prints its verdicts."""
    loc = str(tmp_path / "idx")
    code = (
        "import sys\n"
        "from drep_tpu_torch.controller import main\n"
        f"main(['index', 'build', {loc!r}, '-g', *{list(genome_paths[:4])!r}, '--device', 'cpu', '-p', '1'])\n"
        f"main(['index', 'update', {loc!r}, '-g', {genome_paths[4]!r}, '--device', 'cpu', '-p', '1'])\n"
        f"main(['index', 'classify', {loc!r}, '-g', {genome_paths[0]!r}, '--device', 'cpu', '-p', '1'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'drep_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "LOADED []" in res.stdout
    verdicts = _verdicts(res.stdout)
    assert len(verdicts) == 1 and verdicts[0]["genome"] == "genome_A.fasta" and verdicts[0]["generation"] == 1


def test_index_serve_subprocess_loads_no_jax_or_drep_tpu(tmp_path, genome_paths):
    """`index serve` in a fresh interpreter (build, serve on a unix
    socket, one classify through the client, SIGTERM) imports nothing of
    JAX or drep_tpu and drains to a clean return."""
    loc, sock = str(tmp_path / "idx"), str(tmp_path / "s.sock")
    code = (
        "import os, signal, sys, threading, time\n"
        "from drep_tpu_torch.controller import main\n"
        "from drep_tpu_torch.serve import ServeClient\n"
        f"main(['index', 'build', {loc!r}, '-g', *{list(genome_paths[:3])!r}, '--device', 'cpu', '-p', '1'])\n"
        "got = []\n"
        "def ask():\n"
        f"    while not os.path.exists({sock!r}):\n"
        "        time.sleep(0.05)\n"
        f"    with ServeClient({sock!r}) as c:\n"
        f"        got.append(c.classify({genome_paths[0]!r}))\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=ask, daemon=True).start()\n"
        f"main(['index', 'serve', {loc!r}, '--device', 'cpu', '--socket', {sock!r}])\n"
        "print('VERDICT', got[0]['verdict']['genome'], got[0]['generation'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'drep_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "LOADED []" in res.stdout and "VERDICT genome_A.fasta 0" in res.stdout
    assert not os.path.exists(sock)


def _serve_options(build_parser, op: str = "serve") -> dict:
    """option string -> (dest, default, choices, nargs, required) of
    `index <op>`."""
    def sub(parser, dest):
        return next(a for a in parser._subparsers._group_actions if a.dest == dest)

    serve = sub(sub(build_parser(), "operation").choices["index"], "index_op").choices[op]
    return {o: (a.dest, a.default, a.choices, a.nargs, a.required) for a in serve._actions for o in a.option_strings}


def test_cli_serve_parser_takes_every_jax_flag():
    """`index serve` takes every flag of the JAX CLI's, with its dest,
    default and choices, plus --device."""
    from drep_tpu.argparser import build_parser as jax_build_parser
    from drep_tpu_torch.argparser import build_parser

    got, want = _serve_options(build_parser), _serve_options(jax_build_parser)
    assert set(got) - set(want) == {"--device"}
    assert {o: got[o] for o in want} == want


@pytest.mark.parametrize("op", ["build", "update", "split", "merge", "compact", "route"])
def test_cli_index_parsers_take_every_jax_flag(op):
    """`index build|update` (their federated flags among them), `index
    split|merge|compact` and `index route` take every flag of the JAX
    CLI's, with its dest, default, choices, nargs and requiredness, plus
    --device."""
    from drep_tpu.argparser import build_parser as jax_build_parser
    from drep_tpu_torch.argparser import build_parser

    got, want = _serve_options(build_parser, op), _serve_options(jax_build_parser, op)
    assert set(got) - set(want) == {"--device"}
    assert {o: got[o] for o in want} == want
