"""The fault sites the port threads through the genome index, its
federation, its maintenance verbs and the fleet router
(drep_tpu_torch/utils/faults.py: index_update, meta_publish,
partition_update, partition_load, partition_classify, partition_split,
compaction, router_leg, replica_health), each injected with ``raise`` in
the port and the same spec in the JAX package, on the CPU: each leaves
the store, the partition health or the routed verdict the JAX package
leaves; ``kill`` at these sites SIGKILLs the caller in both packages. The
elastic pod's sites, its drain mode and the pod autoscaling controller's
``autoscale_decide`` parse into the JAX package's rules and fire as
theirs.
"""

import json
import os
import shutil
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_stores_match  # noqa: E402

from drep_tpu.index import FederatedResident as JaxFederatedResident  # noqa: E402
from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.index import build_from_paths as jax_build_from_paths  # noqa: E402
from drep_tpu.index import fed_compact as jax_fed_compact  # noqa: E402
from drep_tpu.index import fed_split as jax_fed_split  # noqa: E402
from drep_tpu.index import index_update as jax_index_update  # noqa: E402
from drep_tpu.serve import IndexServer as JaxIndexServer  # noqa: E402
from drep_tpu.serve import ServeClient as JaxServeClient  # noqa: E402
from drep_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from drep_tpu.serve.router import RouterConfig as JaxRouterConfig  # noqa: E402
from drep_tpu.serve.router import RouterServer as JaxRouterServer  # noqa: E402
from drep_tpu.utils import faults as jax_faults  # noqa: E402
from drep_tpu_torch.index import FederatedResident, fed_compact, fed_split, index_update, roll_forward  # noqa: E402
from drep_tpu_torch.index import maintenance as maint  # noqa: E402
from drep_tpu_torch.index import meta  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig  # noqa: E402
from drep_tpu_torch.serve.router import RouterConfig, RouterServer  # noqa: E402
from drep_tpu_torch.utils import faults  # noqa: E402

CPU = torch.device("cpu")
GROUPS = [3, 2, 2]


@pytest.fixture(autouse=True)
def _faults_off():
    """Each test installs its own spec in both packages; none leaks out."""
    yield
    faults.configure(None)
    jax_faults.configure(None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """7 planted genomes in groups of 3, 2, 2, two novel ones, and six
    unrelated ones (a batch that reaches several partitions)."""
    td = tmp_path_factory.mktemp("sites_g")
    return (lib.write_genome_set(str(td / "g"), GROUPS, seed=3),
            lib.write_genome_set(str(td / "q"), [2], seed=97, prefix="novel"),
            lib.write_genome_set(str(td / "m"), [1] * 6, seed=55, prefix="more"))


@pytest.fixture(scope="module")
def fed(tmp_path_factory, genomes):
    """A P = 3 federation of the 7 genomes with one update of the two
    novel ones on top, written by the JAX package."""
    loc = str(tmp_path_factory.mktemp("sites_fed") / "fed")
    jax_build_federated(loc, genomes[0], 3, processes=1, length=0)
    jax_index_update(loc, genomes[1], processes=1)
    return loc


@pytest.fixture(scope="module")
def fed0(tmp_path_factory, genomes):
    """The same federation before the update."""
    loc = str(tmp_path_factory.mktemp("sites_fed0") / "fed")
    jax_build_federated(loc, genomes[0], 3, processes=1, length=0)
    return loc


def _copy(src: str, dst) -> str:
    shutil.copytree(src, str(dst))
    return str(dst)


def _both(spec: str) -> None:
    faults.configure(spec)
    jax_faults.configure(spec)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("skip", [0, 1], ids=["admission", "prepublish"])
def test_index_update_site_keeps_generation_as_jax(tmp_path, genomes, skip):
    """``index_update:raise`` at the batch admission point (skip 0) and
    just before the manifest publish (skip 1): both packages raise and
    keep the prior generation's manifest; with the fault gone, the
    port's rerun writes the store the JAX package's rerun writes."""
    base = str(tmp_path / "base")
    jax_build_from_paths(base, genomes[0], processes=1, length=0)
    t, j = _copy(base, tmp_path / "t"), _copy(base, tmp_path / "j")
    manifest = _read(os.path.join(base, "manifest.json"))
    _both(f"index_update:raise:skip={skip}")
    with pytest.raises(faults.InjectedFault):
        index_update(t, genomes[1], processes=1, device=CPU)
    with pytest.raises(jax_faults.InjectedFault):
        jax_index_update(j, genomes[1], processes=1)
    for loc in (t, j):
        assert _read(os.path.join(loc, "manifest.json")) == manifest
    _both(None)
    index_update(t, genomes[1], processes=1, device=CPU)
    jax_index_update(j, genomes[1], processes=1)
    assert_stores_match(t, j)


def test_meta_publish_site_keeps_prior_generation_as_jax(tmp_path, fed0, genomes):
    """``meta_publish:raise`` on a federated update: both packages raise
    at the commit point and federation.json stays the prior generation's,
    byte for byte."""
    t, j = _copy(fed0, tmp_path / "t"), _copy(fed0, tmp_path / "j")
    before = _read(meta.meta_path(fed0))
    _both("meta_publish:raise")
    with pytest.raises(faults.InjectedFault):
        index_update(t, genomes[1], processes=1, device=CPU)
    with pytest.raises(jax_faults.InjectedFault):
        jax_index_update(j, genomes[1], processes=1)
    assert _read(meta.meta_path(t)) == _read(meta.meta_path(j)) == before
    assert meta.current_generation(t) == meta.current_generation(fed0)


def test_partition_update_site_publishes_partial_as_jax(tmp_path, fed0, genomes):
    """``partition_update:raise:max=1``: the first dirty partition's update
    fails, the others publish, and the meta is the JAX package's partial
    one (the same failed partition, the same unadmitted genomes)."""
    t, j = _copy(fed0, tmp_path / "t"), _copy(fed0, tmp_path / "j")
    _both("partition_update:raise:max=1")
    got = index_update(t, genomes[2], processes=1, device=CPU)
    want = jax_index_update(j, genomes[2], processes=1)
    mt, mj = (json.loads(_read(meta.meta_path(x))) for x in (t, j))
    assert mt["partial"] == mj["partial"] and mt["partial"]["failed_partitions"]
    assert mt["generation"] == mj["generation"] == got["generation"] == want["generation"]
    assert [e["n_genomes"] for e in mt["partitions"]] == [e["n_genomes"] for e in mj["partitions"]]


@pytest.mark.parametrize("site", ["partition_load", "partition_classify"])
def test_partition_sites_quarantine_as_jax(fed, site):
    """A served partition whose load raises is booked suspect, then
    quarantined at the second failure; one whose consult raises is booked
    suspect, reloads healthy at the next consult and is suspect again; the
    others stay untouched, in both packages alike. With the fault gone and
    the backoff spent, the port's partition loads again."""
    res = FederatedResident(fed, probe_backoff_s=0.0, device=CPU)
    jres = JaxFederatedResident(fed, probe_backoff_s=0.0)
    pid = max(res._slots, key=lambda p: res._slots[p].n)
    states = []
    for r in (res, jres):
        _both(f"{site}:raise")
        seen = []
        for _ in range(2):
            if site == "partition_load":
                assert r.ensure_resident(pid) is False
            else:
                assert r.ensure_resident(pid) is True
                assert r.classify_partition(pid, [], [], None) is None
            seen.append(r._slots[pid].state)
        states.append((seen, {p: s.state for p, s in r._slots.items() if p != pid}))
        _both(None)
    assert states[0] == states[1]
    assert states[0][0] == (["suspect", "quarantined"] if site == "partition_load" else ["suspect", "suspect"])
    assert res.ensure_resident(pid) is True and res._slots[pid].state == "healthy"


@pytest.mark.parametrize("verb", ["split", "compact"])
def test_maintenance_sites_then_roll_forward_converge(tmp_path, fed, verb):
    """``partition_split`` / ``compaction`` raised in the port at each of
    its kill points (staged, before the commit, before the gc): the
    port's roll_forward and a rerun converge to the store the JAX
    package's uninterrupted verb writes, as from the JAX package's own
    interrupt."""
    pid = max(json.loads(_read(meta.meta_path(fed)))["partitions"], key=lambda e: e["n_genomes"])["pid"]
    control = _copy(fed, tmp_path / "c")
    if verb == "split":
        jax_fed_split(control, pid, processes=1)
    else:
        jax_fed_compact(control, min_generations=2, processes=1)
    site = "partition_split" if verb == "split" else "compaction"
    for skip in (0, 1, 2):
        loc = _copy(fed, tmp_path / f"t{skip}")
        faults.configure(f"{site}:raise:skip={skip}")
        with pytest.raises(faults.InjectedFault):
            if verb == "split":
                fed_split(loc, pid, processes=1, device=CPU)
            else:
                fed_compact(loc, min_generations=2, processes=1, device=CPU)
        faults.configure(None)
        assert os.path.exists(maint.maint_path(loc))
        if verb == "split":
            fed_split(loc, pid, processes=1, device=CPU)
        else:
            fed_compact(loc, min_generations=2, processes=1, device=CPU)
        assert not os.path.exists(maint.maint_path(loc))
        lib.assert_stores_equal(loc, control)
        assert roll_forward(loc, device=CPU) is None


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


def _fleet(fed, jax: bool, **router_kw):
    """Two replicas scoped {0, 1} and {2} behind a router, of one package."""
    kw = {"batch_window_ms": 20.0, "max_batch": 16, "poll_generation_s": 60.0}
    if jax:
        reps = [_serve(JaxIndexServer(JaxServeConfig(index_loc=fed, **kw))) for _ in range(2)]
        rcfg = JaxRouterConfig(index_loc=fed, replicas=[f"{reps[0][1]}=0,1", f"{reps[1][1]}=2"], **kw, **router_kw)
        return reps, _serve(JaxRouterServer(rcfg))
    reps = [_serve(IndexServer(ServeConfig(index_loc=fed, device=CPU, **kw))) for _ in range(2)]
    rcfg = RouterConfig(index_loc=fed, replicas=[f"{reps[0][1]}=0,1", f"{reps[1][1]}=2"], device=CPU, **kw,
                        **router_kw)
    return reps, _serve(RouterServer(rcfg))


def test_router_leg_site_gives_partial_as_jax(fed, genomes):
    """``router_leg:raise``: every scatter leg fails, so each routed
    verdict is stamped PARTIAL with the partitions it could not consult,
    as the JAX package's router stamps it; no replica is blamed."""
    queries = genomes[0][:2]
    got = {}
    for pkg in ("torch", "jax"):
        reps, (rt, ra, trt) = _fleet(fed, pkg == "jax", leg_timeout_s=60.0, hedge_delay_s=60.0,
                                     probe_interval_s=30.0)
        _both("router_leg:raise")
        try:
            with (JaxServeClient if pkg == "jax" else ServeClient)(ra, timeout_s=300) as c:
                resps = c.classify_many(queries)
            got[pkg] = [(r["ok"], r["verdict"].get("partial"), r["verdict"]["partitions_unavailable"])
                        for r in resps]
            states = {a: s["state"] for a, s in rt.snapshot()["replicas"]["replicas"].items()}
        finally:
            _both(None)
            _stop(rt, trt)
            for srv, _a, t in reps:
                _stop(srv, t)
        assert set(states.values()) == {"healthy"}
    assert got["torch"] == got["jax"]
    assert all(ok and partial and unavailable for ok, partial, unavailable in got["torch"])


def test_replica_health_site_ejects_as_jax(fed):
    """``replica_health:raise``: each probe fails, so the router moves
    every replica healthy -> suspect -> ejected, as the JAX package's
    router does on the same spec."""
    seen = {}
    for pkg in ("torch", "jax"):
        _both("replica_health:raise")
        reps, (rt, _ra, trt) = _fleet(fed, pkg == "jax", probe_interval_s=0.05, probe_backoff_s=0.05,
                                      probe_max_s=0.1)
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                states = {s["state"] for s in rt.snapshot()["replicas"]["replicas"].values()}
                if states == {"ejected"}:
                    break
                time.sleep(0.05)
            seen[pkg] = states
        finally:
            _both(None)
            _stop(rt, trt)
            for srv, _a, t in reps:
                _stop(srv, t)
    assert seen["torch"] == seen["jax"] == {"ejected"}


@pytest.mark.parametrize("spec", ["process_death:kill", "ring_step:drain", "autoscale_decide:raise"])
def test_pod_modes_and_sites_parse_and_fire_as_jax(spec, tmp_path):
    """The elastic pod's sites and its drain mode and the pod autoscaling
    controller's site parse into the JAX package's rules; a ``drain`` fire
    asks this process for a planned departure in both packages (a ``kill``
    is held in tests/test_torch_pod.py's pods), and ``autoscale_decide``
    ends a controller's tick with InjectedFault in both, before the
    snapshot, counted once."""
    from drep_tpu.autoscale.controller import AutoscaleController as JaxAutoscaleController
    from drep_tpu.autoscale.policy import Targets as JaxTargets
    from drep_tpu.parallel import faulttol as jax_faulttol
    from drep_tpu.utils.profiling import counters as jax_counters
    from drep_tpu_torch.autoscale import AutoscaleController, Targets
    from drep_tpu_torch.parallel import faulttol
    from drep_tpu_torch.utils.profiling import counters

    jax_rules = jax_faults._parse(spec)
    fields = ("site", "mode", "prob", "seed", "secs", "device", "proc", "skip", "max_fires", "path_sub")
    assert ({k: [tuple(getattr(r, f) for f in fields) for r in v] for k, v in faults._parse(spec).items()}
            == {k: [tuple(getattr(r, f) for f in fields) for r in v] for k, v in jax_rules.items()})
    if spec.startswith("autoscale_decide"):
        try:
            for mod, ctl_cls, targets, ctr in ((faults, AutoscaleController, Targets, counters),
                                               (jax_faults, JaxAutoscaleController, JaxTargets, jax_counters)):
                ctr.reset()
                mod.configure(spec)
                log = tmp_path / f"{mod.__name__}.jsonl"
                ctl = ctl_cls(str(tmp_path / "ckpt"), targets(), decision_log=str(log))
                with pytest.raises(mod.InjectedFault):
                    ctl.poll_once()
                assert ctr.faults.get("injected_autoscale_decide_raise") == 1
                assert ctl.decisions == 0 and not log.exists()
        finally:
            for mod in (faults, jax_faults):
                mod.configure(None)
        return
    if ":drain" not in spec:
        return
    try:
        for mod, ft in ((faults, faulttol), (jax_faults, jax_faulttol)):
            mod.configure(spec)
            assert not ft.drain_requested()
            mod.fire(spec.split(":")[0])
            assert ft.drain_requested()
    finally:
        for mod, ft in ((faults, faulttol), (jax_faults, jax_faulttol)):
            mod.configure(None)
            ft.clear_drain()


@pytest.mark.parametrize("spec,site", [("index_update:kill", "index_update"), ("compaction:kill:skip=1", "compaction")])
def test_kill_mode_sigkills_the_caller_as_jax(spec, site):
    """``kill`` at an index site SIGKILLs the calling process at the
    matching fire, no cleanup run, in both packages; earlier fires pass."""
    import subprocess

    for mod in ("drep_tpu_torch", "drep_tpu"):
        code = (f"from {mod}.utils import faults\n"
                f"faults.configure({spec!r})\n"
                f"for i in range(3):\n"
                f"    print('fire', i, flush=True)\n"
                f"    faults.fire({site!r})\n"
                f"print('survived', flush=True)\n")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert res.returncode == -9, (mod, res.stderr[-2000:])
        assert res.stdout.split("\n")[:-1] == ["fire 0"] + (["fire 1"] if "skip=1" in spec else []), mod
