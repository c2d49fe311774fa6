"""The port's fleet router (drep_tpu_torch/serve/router.py) and the
daemon's classify_part legs against the JAX package's, on the CPU.

- units: replica specs, the per-hop budget rule, the replica table's
  health machine, its circuit breaker and its routing views, each equal
  to the JAX package's on the same event sequence;
- a port daemon's ``classify_part`` and ``prewarm`` replies equal the JAX
  daemon's for the same requests (distances at rtol 1e-6: each package
  runs its own Mash walk);
- in-process port replicas behind a port router on one P = 3 federation:
  scatter verdicts (scoped replicas) and forward verdicts (unscoped ones)
  equal the port's single daemon's as full dicts, byte for byte, and the
  JAX single daemon's (``nearest_dist`` at rtol 1e-6); a replica killed
  mid-traffic gives PARTIAL (strict: refused) and a ``fleet`` join
  restores full coverage; a hedged forward answers each query once with
  the first answer; a draining replica's refusals spill to PARTIAL; no
  usable replica is refused with ``no_replicas``; a plain root and a
  ``fleet_manifest`` (item 11c) are refused.
"""

import contextlib
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_verdicts_match  # noqa: E402

from drep_tpu.errors import UserInputError as JaxUserInputError  # noqa: E402
from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.serve import IndexServer as JaxIndexServer  # noqa: E402
from drep_tpu.serve import ServeClient as JaxServeClient  # noqa: E402
from drep_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from drep_tpu.serve import router as jax_router  # noqa: E402
from drep_tpu_torch.errors import UserInputError  # noqa: E402
from drep_tpu_torch.index import build_from_paths, load_resident_index, sketch_queries  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig, ServeError  # noqa: E402
from drep_tpu_torch.serve import router  # noqa: E402
from drep_tpu_torch.serve.router import (  # noqa: E402
    REPLICA_EJECTED,
    REPLICA_SUSPECT,
    ReplicaTable,
    RouterConfig,
    RouterServer,
)

CPU = torch.device("cpu")
GROUPS = [3, 2, 2]
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- units against the JAX package ----------------------------------------


@pytest.mark.parametrize("spec", ["h:9001", " h:9001 = 0-2,5 ", "/tmp/r.sock=2", "a:1=3,1-2,3",
                                  "=0,1", "h:1=", "h:1=x", "h:1=0-z"])
def test_parse_replica_spec_equals_jax(spec):
    try:
        want = jax_router.parse_replica_spec(spec)
    except JaxUserInputError as e:
        with pytest.raises(UserInputError) as ei:
            router.parse_replica_spec(spec)
        assert str(ei.value) == str(e)
    else:
        assert router.parse_replica_spec(spec) == want


def test_budget_decrement_equals_jax():
    for budget in (None, 0.0, 100.0, 1000.0, 12345.5):
        for elapsed in (0.0, 0.25, 5.0, 20.0):
            assert router.decrement_budget_ms(budget, elapsed) == jax_router.decrement_budget_ms(budget, elapsed)
    now = time.monotonic()
    for deadline in (None, now + 1.0, now + 0.75, now - 5.0):
        assert router.remaining_budget_ms(deadline, now=now) == jax_router.remaining_budget_ms(deadline, now=now)
    assert router.remaining_budget_ms(None) is None


def _slot_view(table, addr: str) -> dict:
    s = table._slots[addr]
    return {k: getattr(s, k) for k in ("state", "failures", "recoveries", "backoff_s", "probes", "generation",
                                       "queue_depth", "draining", "resident", "left", "breaker", "breaker_trips",
                                       "inflight", "assigned")}


def _lockstep(tables, events, check):
    """Apply each (method, args) event to both tables (port, JAX), then
    compare their views; a ('sleep', s) event waits."""
    for ev in events:
        if ev[0] == "sleep":
            time.sleep(ev[1])
        else:
            outs = [getattr(t, ev[0])(*ev[1:]) for t in tables]
            if ev[0] in ("leave", "usable", "__len__"):
                assert outs[0] == outs[1], ev
        check(*tables, ev)


_OK = {"generation": 3, "n_genomes": 7, "queue_depth": 2, "draining": False,
       "partitions": {"partitions": {"0": {"resident": True}, "1": {"resident": False}}}}


def test_replica_table_health_machine_equals_jax():
    """healthy -> suspect -> ejected with the doubling backoff to its cap,
    a recovery, leave and rejoin, the lease count: the JAX table's states
    after every event."""
    tables = [ReplicaTable(["a:1"], probe_backoff_s=0.05, probe_max_s=0.2),
              jax_router.ReplicaTable(["a:1"], probe_backoff_s=0.05, probe_max_s=0.2)]

    def check(t, jt, ev):
        assert _slot_view(t, "a:1") == _slot_view(jt, "a:1"), ev
        assert t.health_map() == jt.health_map(), ev
        assert t.usable() == jt.usable() and len(t) == len(jt)
        now = time.monotonic()
        assert t.probe_due(now) == jt.probe_due(now)
        assert [s.address for s in t.eligible(0)] == [s.address for s in jt.eligible(0)]

    events = [("join", "a:1")] + [("book_failure", "a:1", "boom")] * 5 + [
        ("book_success", "a:1", _OK), ("leave", "a:1"), ("leave", "ghost:9"), ("join", "a:1"),
        ("lease", "a:1"), ("lease", "a:1"), ("release", "a:1"), ("release", "a:1"), ("release", "a:1"),
    ]
    _lockstep(tables, events, check)
    assert tables[0]._slots["a:1"].recoveries == 1 and tables[0].retry_hint_s() == tables[1].retry_hint_s()


def test_replica_breaker_equals_jax():
    """The error-rate breaker over the health machine: flapping trips it
    open, a /healthz success does not close it, the half-open probe leg is
    bounded by the lease, a failed probe reopens, a leg success closes."""
    kw = {"probe_backoff_s": 0.05, "probe_max_s": 0.2, "breaker_errs": 3, "breaker_window_s": 10.0,
          "breaker_halfopen_s": 0.1}
    tables = [ReplicaTable(["a:1"], **kw), jax_router.ReplicaTable(["a:1"], **kw)]
    ok = {"generation": 0, "queue_depth": 0, "draining": False, "partitions": {}}

    def check(t, jt, ev):
        a, b = _slot_view(t, "a:1"), _slot_view(jt, "a:1")
        assert a == b, ev
        assert len(t._slots["a:1"].err_times) == len(jt._slots["a:1"].err_times)
        assert t.health_map() == jt.health_map(), ev
        assert [s.address for s in t.eligible(0)] == [s.address for s in jt.eligible(0)], ev

    events = [("book_failure", "a:1", "boom"), ("book_success", "a:1", ok)] * 2 + [
        ("book_failure", "a:1", "boom"), ("book_success", "a:1", ok), ("sleep", 0.11), ("lease", "a:1"),
        ("book_failure", "a:1", "probe failed"), ("release", "a:1"), ("sleep", 0.11), ("book_success", "a:1"),
    ] + [("book_failure", "a:1", "x")] * 3 + [("leave", "a:1"), ("join", "a:1")]
    _lockstep(tables, events, check)
    assert tables[0]._slots["a:1"].breaker == router.BREAKER_CLOSED


def test_replica_table_routing_views_equal_jax():
    specs = ["a:1=0,1", "b:1=2", "c:1"]
    tables = [ReplicaTable(specs, probe_backoff_s=0.1, probe_max_s=1.0),
              jax_router.ReplicaTable(specs, probe_backoff_s=0.1, probe_max_s=1.0)]

    def check(t, jt, ev):
        for pid in (0, 1, 2):
            assert [s.address for s in t.eligible(pid)] == [s.address for s in jt.eligible(pid)], (ev, pid)
        for pids in ({0, 1}, {0, 2}, {0, 1, 2}, {2}):
            assert [s.address for s in t.cover_targets(pids)] == [s.address for s in jt.cover_targets(pids)]

    b_status = {"generation": 0, "queue_depth": 5, "draining": False,
                "partitions": {"partitions": {"2": {"resident": True}}}}
    a_drain = {"generation": 0, "queue_depth": 0, "draining": True, "partitions": {}}
    events = [("book_success", "b:1", b_status), ("lease", "c:1"), ("lease", "c:1"), ("lease", "c:1"),
              ("book_success", "a:1", a_drain), ("book_failure", "c:1", "x"), ("book_failure", "c:1", "y")]
    _lockstep(tables, events, check)


# ---- in-process fleets ----------------------------------------------------


def _start_replica(loc, classify_fn=None, jax=False, **over):
    over.setdefault("batch_window_ms", 20.0)
    over.setdefault("max_batch", 16)
    over.setdefault("poll_generation_s", 60.0)
    if jax:
        srv = JaxIndexServer(JaxServeConfig(index_loc=loc, **over), classify_fn=classify_fn)
    else:
        srv = IndexServer(ServeConfig(index_loc=loc, device=CPU, **over), classify_fn=classify_fn)
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    return srv, addr, t


def _start_router(loc, replicas, **over):
    over.setdefault("batch_window_ms", 20.0)
    over.setdefault("max_batch", 16)
    over.setdefault("poll_generation_s", 60.0)
    # keep hedging and leg timeouts out of the way unless a test is about them
    over.setdefault("leg_timeout_s", 120.0)
    over.setdefault("hedge_delay_s", 60.0)
    over.setdefault("probe_interval_s", 0.2)
    over.setdefault("probe_backoff_s", 0.2)
    over.setdefault("probe_max_s", 0.5)
    srv = RouterServer(RouterConfig(index_loc=loc, replicas=list(replicas), device=CPU, **over))
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


def _abrupt_kill(srv):
    """An in-process stand-in for SIGKILL: shutdown() wakes the accept
    thread blocked in accept(), so the port refuses at once."""
    with contextlib.suppress(OSError):
        srv._listener.shutdown(socket.SHUT_RDWR)
    srv.close()
    srv.queue.drain()


@pytest.fixture(scope="module")
def fleet_store(tmp_path_factory):
    """The P = 3 federation, four queries across the groups (a novel one
    among them), and two oracles: the port's single daemon's and the JAX
    package's single daemon's replies to the same queries."""
    td = tmp_path_factory.mktemp("torch_fleet")
    paths = lib.write_genome_set(str(td / "g"), GROUPS, seed=SEED)
    loc = str(td / "fed")
    jax_build_federated(loc, paths, 3, length=0)
    novel = lib.write_genome_set(str(td / "q"), [1], seed=97, prefix="novel")
    queries = [paths[0], paths[1], paths[3]] + novel
    oracles = {}
    for pkg, client in (("torch", ServeClient), ("jax", JaxServeClient)):
        srv, addr, t = _start_replica(loc, jax=pkg == "jax")
        try:
            with client(addr, timeout_s=600) as c:
                resps = c.classify_many(queries)
            assert all(r.get("ok") for r in resps), resps
            oracles[pkg] = {q: r["verdict"] for q, r in zip(queries, resps)}
        finally:
            _stop(srv, t)
    assert_verdicts_match([oracles["torch"][q] for q in queries], [oracles["jax"][q] for q in queries])
    return loc, paths, queries, oracles["torch"], oracles["jax"]


def test_classify_part_and_prewarm_replies_equal_jax(fleet_store):
    """One leg and one prewarm, sent to a port replica and a JAX replica:
    the same replies (the leg's distances at rtol 1e-6), the same fence
    refusal, and the same refusals on a plain root."""
    loc, _paths, queries, _oracle, _jax_oracle = fleet_store
    fed = load_resident_index(loc, device=CPU)
    sq = sketch_queries(fed, queries)
    names = list(sq.admitted["genome"])
    bottoms = [[int(x) for x in sq.results[g]["bottom"]] for g in names]
    leg = {"op": "classify_part", "pid": 0, "generation": 0, "names": names, "bottoms": bottoms,
           "prune": None, "id": "leg-1"}
    got: dict = {}
    for pkg, client in (("torch", ServeClient), ("jax", JaxServeClient)):
        srv, addr, t = _start_replica(loc, jax=pkg == "jax")
        try:
            with client(addr, timeout_s=600) as c:
                got[pkg] = [c.request(leg), c.request(dict(leg, generation=5, id="leg-2")),
                            c.request({"op": "prewarm", "partitions": [1, 2, 9], "id": "pw"})]
            got[pkg + "_legs"] = srv.stats.legs_total
        finally:
            _stop(srv, t)
    (leg_t, fence_t, warm_t), (leg_j, fence_j, warm_j) = got["torch"], got["jax"]
    assert leg_t["ok"] and leg_t.keys() == leg_j.keys() and len(leg_t["ui"]) > 0
    assert {k: v for k, v in leg_t.items() if k != "dist"} == {k: v for k, v in leg_j.items() if k != "dist"}
    np.testing.assert_allclose(leg_t["dist"], leg_j["dist"], rtol=1e-6)
    assert fence_t == fence_j and fence_t["reason"] == "generation_mismatch" and fence_t["generation"] == 0
    assert warm_t == warm_j and warm_t["warmed"] == [1, 2] and warm_t["failed"] == [9]
    assert got["torch_legs"] == got["jax_legs"] == 1


def test_plain_root_refuses_federated_ops_as_jax(tmp_path, genome_paths_small):
    loc = str(tmp_path / "mono")
    build_from_paths(loc, genome_paths_small, length=0, device=CPU)
    replies = {}
    for pkg, client in (("torch", ServeClient), ("jax", JaxServeClient)):
        srv, addr, t = _start_replica(loc, jax=pkg == "jax")
        try:
            with client(addr, timeout_s=60) as c:
                replies[pkg] = [
                    c.request({"op": "classify_part", "pid": 0, "generation": 0, "names": ["q"],
                               "bottoms": [[1]], "id": "l"}),
                    c.request({"op": "prewarm", "partitions": [0], "id": "p"}),
                    c.request({"op": "fleet", "action": "join", "address": "h:1", "id": "f"}),
                ]
            assert "partitions" not in srv.snapshot()
        finally:
            _stop(srv, t)
    assert replies["torch"] == replies["jax"]
    assert [r["reason"] for r in replies["torch"]] == ["not_federated", "not_federated", "not_a_router"]
    # the router refuses a plain root after loading it, before serving
    with pytest.raises(UserInputError, match="FEDERATED"):
        RouterServer(RouterConfig(index_loc=loc, replicas=["127.0.0.1:9"], device=CPU)).start()


@pytest.fixture(scope="module")
def genome_paths_small(tmp_path_factory):
    return lib.write_genome_set(str(tmp_path_factory.mktemp("mono_g")), [2], seed=11)


def test_scatter_oracle_and_replica_loss_containment(fleet_store):
    """Scoped replicas ({0, 1} and {2}): no replica covers every candidate
    set, so every query scatters; the verdicts equal the single daemon's.
    Then the sole partition-2 replica dies: PARTIAL, strict refused; a
    replacement joins through the fleet op and full coverage returns."""
    loc, _paths, queries, oracle, jax_oracle = fleet_store
    r1, a1, t1 = _start_replica(loc)
    r2, a2, t2 = _start_replica(loc)
    rt, ra, trt = _start_router(loc, [f"{a1}=0,1", f"{a2}=2"])
    r3 = t3 = None
    try:
        with ServeClient(ra, timeout_s=600) as c:
            resps = c.classify_many(queries)
            for q, r in zip(queries, resps):
                assert r.get("ok"), r
                assert r["verdict"] == oracle[q], q
            assert_verdicts_match([r["verdict"] for r in resps], [jax_oracle[q] for q in queries])
            snap = rt.snapshot()
            assert snap["role"] == "router" and snap["partitions"]["resident_partitions"] >= 1
            stats = snap["router"]
            assert stats["scattered"] == len(queries) and stats["forwarded"] == 0
            assert stats["leg_failures"] == 0 and stats["legs_total"] >= 3
            assert r1.stats.legs_total + r2.stats.legs_total == stats["legs_total"]
            # the rectangles ran on the replicas; the router only merged
            assert rt._resident.work["compares"] == 0 and rt._resident.work["reclusters"] == len(queries)

            _abrupt_kill(r2)
            r = c.classify(queries[0])
            assert r["ok"], r
            assert r["verdict"]["partial"] is True
            assert 2 in r["verdict"]["partitions_unavailable"] and 2 not in r["verdict"]["partitions_consulted"]
            with pytest.raises(ServeError) as ei:
                c.classify(queries[0], strict=True)
            assert ei.value.reason == "partial_coverage" and ei.value.retry_after_s > 0
            assert rt.snapshot()["router"]["partial_verdicts"] >= 1

            r3, a3, t3 = _start_replica(loc)
            jr = c.request({"op": "fleet", "action": "join", "address": a3, "partitions": [2]})
            assert jr["ok"] and jr["replicas"] == 3
            assert r3.snapshot()["partitions"]["partitions"]["2"]["resident"]  # the join's prewarm
            r = c.classify(queries[0])
            assert r["ok"] and r["verdict"] == oracle[queries[0]]
            health = rt.snapshot()["replicas"]["replicas"]
            assert health[a3]["state"] == "healthy"
            assert health[a2]["state"] in (REPLICA_SUSPECT, REPLICA_EJECTED)
    finally:
        for srv, t in ((rt, trt), (r1, t1), (r3, t3)):
            if srv is not None:
                _stop(srv, t)
        r2.queue.drain()
        t2.join(timeout=60)


def test_forward_oracle_sketch_cache_and_leave(fleet_store):
    """Unscoped replicas cover every candidate set: whole queries forward
    as plain classifies, the verdicts equal the single daemon's; a second
    round rides the router's sketch cache; a leave keeps serving on the
    survivor."""
    loc, _paths, queries, oracle, jax_oracle = fleet_store
    r1, a1, t1 = _start_replica(loc)
    r2, a2, t2 = _start_replica(loc)
    rt, ra, trt = _start_router(loc, [a1, a2])
    try:
        with ServeClient(ra, timeout_s=600) as c:
            for rnd in (1, 2):
                resps = c.classify_many(queries)
                for q, r in zip(queries, resps):
                    assert r.get("ok"), r
                    assert r["verdict"] == oracle[q], (q, rnd)
                assert_verdicts_match([r["verdict"] for r in resps], [jax_oracle[q] for q in queries])
            stats = rt.snapshot()["router"]
            assert stats["forwarded"] == 2 * len(queries) and stats["scattered"] == 0
            assert len(rt._sketch_cache) == len(queries)
            assert rt._resident.work["reclusters"] == 0  # the replicas answered whole
            lr = c.request({"op": "fleet", "action": "leave", "address": a1})
            assert lr["ok"] and lr["known"] and lr["replicas"] == 1
            assert not c.request({"op": "fleet", "action": "leave", "address": "ghost:1"})["known"]
            r = c.classify(queries[0])
            assert r["ok"] and r["verdict"] == oracle[queries[0]]
    finally:
        for srv, t in ((rt, trt), (r1, t1), (r2, t2)):
            _stop(srv, t)


def test_hedged_forward_first_answer_wins(fleet_store):
    """The primary replica stalls past the hedge delay: a duplicate goes
    to the second replica, whose answer wins; each query is answered once."""
    loc, _paths, queries, _oracle, _jax_oracle = fleet_store
    flags = {"a": threading.Event(), "b": threading.Event()}

    def mk_stub(key, tag):
        def classify(resident, paths):
            if flags[key].is_set():
                time.sleep(2.0)
            return {os.path.basename(p): {"genome": os.path.basename(p), "stub": tag,
                                          "generation": int(resident.generation)} for p in paths}
        return classify

    ra_srv, aa, ta = _start_replica(loc, classify_fn=mk_stub("a", "A"))
    rb_srv, ab, tb = _start_replica(loc, classify_fn=mk_stub("b", "B"))
    slow = min(aa, ab)  # load ties break by address: stall the first pick
    flags["a" if slow == aa else "b"].set()
    fast_tag = "B" if slow == aa else "A"
    rt, ra, trt = _start_router(loc, [aa, ab], hedge_delay_s=0.3, leg_timeout_s=60.0)
    try:
        with ServeClient(ra, timeout_s=600) as c:
            resp = c.classify(queries[0])
            assert resp["ok"] and resp["verdict"]["stub"] == fast_tag
            stats = rt.snapshot()["router"]
            assert stats["hedges"] >= 1 and stats["hedge_wins"] >= 1
            assert stats["forwarded"] == 1 and stats["scattered"] == 0
            resps = c.classify_many(queries[:2])
            assert len(resps) == 2 and all(r["ok"] for r in resps)
    finally:
        for srv, t in ((rt, trt), (ra_srv, ta), (rb_srv, tb)):
            _stop(srv, t)


def test_overload_spill_on_draining_replica(fleet_store):
    """Every leg meets the sole replica's draining refusals: the legs spill
    to an all-partitions-unavailable PARTIAL (strict: refused), counted."""
    loc, _paths, queries, _oracle, _jax_oracle = fleet_store
    r1, a1, t1 = _start_replica(loc)
    rt, ra, trt = _start_router(loc, [a1], probe_interval_s=60.0)
    try:
        deadline = time.monotonic() + 30
        while rt.snapshot()["replicas"]["replicas"][a1]["probes"] < 1:
            assert time.monotonic() < deadline, "the router never probed its replica"
            time.sleep(0.02)
        r1.queue.drain()  # the listener stays open: every answer is a refusal
        with ServeClient(ra, timeout_s=600) as c:
            r = c.classify(queries[0])
            assert r["ok"], r
            assert r["verdict"]["partial"] is True and r["verdict"]["partitions_consulted"] == []
            assert set(r["verdict"]["partitions_unavailable"]) == {0, 1, 2}
            with pytest.raises(ServeError) as ei:
                c.classify(queries[0], strict=True)
            assert ei.value.reason == "partial_coverage"
            stats = rt.snapshot()["router"]
            assert stats["overload_spills"] >= 1 and stats["partial_verdicts"] >= 1
    finally:
        _stop(rt, trt)
        r1.queue.drain()
        t1.join(timeout=60)
        r1.close()


def test_no_usable_replica_refusal(fleet_store):
    loc, _paths, queries, _oracle, _jax_oracle = fleet_store
    rt, ra, trt = _start_router(loc, ["127.0.0.1:9"], probe_interval_s=0.05, probe_backoff_s=0.1,
                                probe_max_s=0.2)
    try:
        deadline = time.monotonic() + 30
        while rt.snapshot()["replicas"]["replicas"]["127.0.0.1:9"]["state"] != REPLICA_EJECTED:
            assert time.monotonic() < deadline, "the replica was never ejected"
            time.sleep(0.05)
        with ServeClient(ra, timeout_s=600) as c:
            with pytest.raises(ServeError) as ei:
                c.classify(queries[0])
        assert ei.value.reason == "no_replicas" and ei.value.retry_after_s > 0
    finally:
        _stop(rt, trt)


def test_router_warns_when_a_leg_can_pass_the_line_limit(fleet_store):
    """A leg is one protocol line of its queries' bottoms: at sketch size
    1000, a batch bound of 64 can pass the 1 MiB line and the router says
    so at start; 16 cannot."""
    import logging

    from drep_tpu_torch.utils.logger import get_logger

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages: list[str] = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    loc, _paths, _queries, _oracle, _jax_oracle = fleet_store
    logger = get_logger()  # the port's logger may not propagate (setup_logger)
    for max_batch, warned in ((64, True), (16, False)):
        records = Records()
        logger.addHandler(records)
        try:
            rt, _ra, trt = _start_router(loc, ["127.0.0.1:9"], max_batch=max_batch)
            _stop(rt, trt)
        finally:
            logger.removeHandler(records)
        hits = [m for m in records.messages if "protocol's" in m]
        assert bool(hits) == warned, hits
        if warned:
            assert "at or below 47" in hits[0]


def test_fleet_manifest_refused_before_loading(fleet_store, tmp_path):
    """The supervisor's manifest is item 11c: the router refuses it before
    it reads the root or binds."""
    loc, _paths, _queries, _oracle, _jax_oracle = fleet_store
    before = lib.tree_digest(loc, exclude_dirs=())
    with pytest.raises(NotImplementedError, match="item 11c"):
        RouterServer(RouterConfig(index_loc=str(tmp_path / "missing"), fleet_manifest=str(tmp_path / "fleet.json"),
                                  socket_path=str(tmp_path / "r.sock"), device=CPU))
    assert not os.path.exists(tmp_path / "r.sock")
    assert lib.tree_digest(loc, exclude_dirs=()) == before


# ---- F7: a batch whose budget runs out between its legs and its merge -----

F7_DEFAULT_MS = 5000.0  # the daemon's default budget, cut from 30 s


def _hold_past_short_budgets(srv, monkeypatch) -> None:
    """Wrap the router's leg gather: the legs run and answer, then, where
    the batch's budget ends within F7_DEFAULT_MS, the gather returns only
    once it has passed (a slow host between 13b's legs and its merge)."""
    gather = srv._gather_legs

    def held(*args):
        out = gather(*args)
        deadline = args[-1]  # budget_deadline, the last argument in both packages
        if deadline is not None and deadline - time.monotonic() < F7_DEFAULT_MS / 1000.0:
            time.sleep(max(0.0, deadline - time.monotonic()) + 0.05)
        return out

    monkeypatch.setattr(srv, "_gather_legs", held)


def test_expired_default_budget_gives_stamped_partial_as_jax(fleet_store, monkeypatch):
    """F7's cause on the CPU. Clients that send no deadline_ms get the
    daemon's default budget; a router batch whose budget runs out after
    its legs have answered merges with every partition booked
    unavailable: verdicts stamped PARTIAL (``partitions_unavailable``
    non-empty), never a full verdict that differs from the daemon's, in
    the port's router and the JAX package's alike, with the replicas'
    walks done. The same queries stamped with a budget the batch cannot
    spend (600 000 ms, as chip_smoke's 13a/13b now send) equal the
    single daemon's verdicts."""
    from drep_tpu.serve.router import RouterConfig as JaxRouterConfig
    from drep_tpu.serve.router import RouterServer as JaxRouterServer
    from drep_tpu.utils.profiling import counters as jax_counters
    from drep_tpu_torch.serve import daemon
    from drep_tpu_torch.utils.profiling import counters

    loc, _paths, queries, oracle, jax_oracle = fleet_store
    monkeypatch.setattr(daemon, "DEADLINE_DEFAULT_MS", F7_DEFAULT_MS)
    stamps = {}
    for pkg in ("torch", "jax"):
        r1, a1, t1 = _start_replica(loc, jax=pkg == "jax")
        r2, a2, t2 = _start_replica(loc, jax=pkg == "jax")
        specs = [f"{a1}=0,1", f"{a2}=2"]
        if pkg == "torch":
            rt, ra, trt = _start_router(loc, specs)
        else:
            rt = JaxRouterServer(JaxRouterConfig(
                index_loc=loc, replicas=specs, batch_window_ms=20.0, max_batch=16, poll_generation_s=60.0,
                leg_timeout_s=120.0, hedge_delay_s=60.0, probe_interval_s=0.2, probe_backoff_s=0.2,
                probe_max_s=0.5))
            rt._deadline_default_ms = F7_DEFAULT_MS
            ra = rt.start()
            trt = threading.Thread(target=rt.serve_batches, daemon=True)
            trt.start()
        _hold_past_short_budgets(rt, monkeypatch)
        # admission refuses a budget below the queue's ETA, which the
        # process's earlier batches (the oracles') would set past 3 s
        (counters if pkg == "torch" else jax_counters).reset()
        client = ServeClient if pkg == "torch" else JaxServeClient
        try:
            with client(ra, timeout_s=600) as c:
                resps = c.classify_many(queries)  # no deadline_ms: the default budget
                walks = r1.stats.legs_total + r2.stats.legs_total
                stamped = c.classify_many(queries, deadline_ms=600_000.0)
            stats = rt.snapshot()["router"]
        finally:
            for srv, t in ((rt, trt), (r1, t1), (r2, t2)):
                _stop(srv, t)
        want = oracle if pkg == "torch" else jax_oracle
        assert all(r.get("ok") for r in resps + stamped), resps + stamped
        verdicts = [r["verdict"] for r in resps]
        assert walks > 0  # the legs ran: the verdicts are PARTIAL at the merge
        for q, v in zip(queries, verdicts):
            assert v.get("partial") is True and v["partitions_unavailable"], (pkg, q, v)
            assert v != want[q]  # a PARTIAL verdict reads as a wrong one when compared unstripped
        # a leg that waited past the budget for its replica's compute slot
        # fails too (fewer walks): PARTIAL all the same
        assert stats["partial_verdicts"] == len(queries)
        assert [r["verdict"] for r in stamped] == [want[q] for q in queries]
        stamps[pkg] = [(v["partitions_consulted"], v["partitions_unavailable"]) for v in verdicts]
    assert stamps["torch"] == stamps["jax"]
