"""The port's serving tier (drep_tpu_torch/serve, index/resident_device.py)
against the JAX package's on the CPU: the contract of tests/test_serve.py,
on the same fixture shape (three groups of four genomes at streaming
block 4, plus three queries).

- the wire: protocol functions byte-identical to drep_tpu/serve/protocol.py
  on a table of frames (garbled CRC included), the admission queue and the
  ETA rule the same on the same sequences, and either package's client
  against the other package's daemon;
- classify_batch(joint=False) equal to the port's and the JAX package's
  one-shot classify (prune off and lsh), through the sketch matrix held on
  the device: one upload per generation, edges equal to the union path's
  bit for bit, a forced gap overflow taking the union path (counted) with
  the same verdicts;
- the daemon: concurrent clients in fewer batches than clients, the
  status/HTTP shim, a hot swap mid-stream, backpressure and drain,
  deadline shedding, cancel and the ETA refusal, a poisoned batch, the
  log_dir refusal and SIGTERM's drain to exit 0; the index tree's digest
  unchanged throughout.
"""

import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_verdicts_match  # noqa: E402

from drep_tpu.index import index_classify as jax_index_classify  # noqa: E402
from drep_tpu.serve import AdmissionQueue as JaxAdmissionQueue  # noqa: E402
from drep_tpu.serve import IndexServer as JaxIndexServer  # noqa: E402
from drep_tpu.serve import PendingRequest as JaxPendingRequest  # noqa: E402
from drep_tpu.serve import ServeClient as JaxServeClient  # noqa: E402
from drep_tpu.serve import ServeConfig as JaxServeConfig  # noqa: E402
from drep_tpu.serve import protocol as jax_protocol  # noqa: E402
from drep_tpu.serve.batcher import queue_eta_s as jax_queue_eta_s  # noqa: E402
from drep_tpu.utils.profiling import Histogram as JaxHistogram  # noqa: E402
from drep_tpu_torch.errors import UserInputError  # noqa: E402
from drep_tpu_torch.index import (  # noqa: E402
    build_from_paths,
    classify_batch,
    index_classify,
    index_update,
    load_resident_index,
    resident_device,
    sketch_queries,
)
from drep_tpu_torch.index.classify import _scratch_index  # noqa: E402
from drep_tpu_torch.index.update import _admit_batch, _rect_edges  # noqa: E402
from drep_tpu_torch.serve import (  # noqa: E402
    AdmissionQueue,
    IndexServer,
    PendingRequest,
    ServeClient,
    ServeConfig,
    ServeError,
)
from drep_tpu_torch.serve import protocol  # noqa: E402
from drep_tpu_torch.serve.batcher import queue_eta_s  # noqa: E402
from drep_tpu_torch.utils.profiling import Counters, Histogram, counters, prom_text  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the wire, against the JAX package's ---------------------------------

_SEALED = protocol.seal({"ok": True, "id": "ab12", "verdict": {"genome": "q.fa", "nearest_dist": 0.0123}})
_GARBLED = _SEALED.replace(b"ab12", b"xb12")
_HTTP_HEAD = b"POST /classify HTTP/1.0\r\n"
_HTTP_REST = b'Content-Type: application/json\r\nContent-Length: 21\r\n\r\n{"genome": "/x/a.fa"}'

# (function, arguments): each runs on both packages; the result, or the
# exception's type name and message, must be equal
PROTOCOL_CASES = [
    ("seal", ({"ok": True, "id": "ab12", "verdict": {"genome": "q.fa", "nearest_dist": 0.0123}},)),
    ("seal", ({"op": "classify", "genome": "/x/a.fa", "id": 7, "deadline_ms": 250.5},)),
    ("seal", ({"ok": False, "error": "naïve — ünïcode", "id": None, "retry_after_s": 0.05},)),
    ("check_crc", (_SEALED,)),
    ("check_crc", (_SEALED[:-1] + b"\r\n",)),
    ("check_crc", (_GARBLED,)),
    ("check_crc", (protocol.encode({"ok": True, "id": "ab12"}),)),
    ("unseal", (_SEALED,)),
    ("unseal", (_GARBLED,)),
    ("unseal", (b"not json\n",)),
    ("unseal", (b'"just a string"\n',)),
    ("parse_request", (b'{"op": "classify", "genome": "/x/a.fa", "id": 7}',)),
    ("parse_request", (b'{"op": "classify", "genome": "/x.fa", "deadline_ms": 250.5, "strict": true}',)),
    ("parse_request", (b'{"op": "classify", "genome": "/x.fa", "deadline_ms": true}',)),
    ("parse_request", (b'{"op": "classify", "genome": "/x.fa", "strict": "no"}',)),
    ("parse_request", (b'{"op": "classify"}',)),
    ("parse_request", (b'{"op": "cancel", "id": "ab12"}',)),
    ("parse_request", (b'{"op": "cancel", "id": 7}',)),
    ("parse_request", (b'{"op": "classify_part", "pid": 2, "generation": 7, "names": ["q:a"], '
                       b'"bottoms": [[1, 2]], "prune": null}',)),
    ("parse_request", (b'{"op": "fleet", "action": "join", "address": "h:1", "partitions": [0, 2]}',)),
    ("parse_request", (b'{"op": "prewarm", "partitions": []}',)),
    ("parse_request", (b'{"op": "nope"}',)),
    ("parse_request", (b"not json",)),
    ("parse_request", (b"x" * (protocol.MAX_LINE_BYTES + 1),)),
    ("error_response", ("full",), {"req_id": 7, "reason": "backpressure", "retry_after_s": 0.123456}),
    ("error_response", ("bad",)),
    ("classify_response", ({"genome": "q.fa", "generation": 3},),
     {"req_id": "ab", "batch_size": 4, "queue_ms": 1.23456, "batch_ms": 7.0}),
    ("looks_like_http", (b"GET /healthz HTTP/1.0\r\n",)),
    ("looks_like_http", (b'{"op": "ping"}\n',)),
    ("http_response", (200, {"ok": True, "generation": 0})),
    ("http_response", (503, {"ok": False, "reason": "draining"}), {"retry_after_s": 2.6}),
    ("http_to_request", ("GET", "/healthz?x=1", b"")),
    ("http_to_request", ("POST", "/classify", b'{"genome": "/x.fa", "id": "r1", "deadline_ms": 500}')),
    ("http_to_request", ("POST", "/classify", b'{"genome": "/x.fa", "strict": "false"}')),
    ("http_to_request", ("GET", "/nope", b"")),
    ("http_request", (_HTTP_HEAD, _HTTP_REST)),
    ("http_request", (b"GET\r\n", b"\r\n")),
]


def _call(mod, case):
    name, args = case[0], case[1]
    kwargs = case[2] if len(case) > 2 else {}
    if name == "http_request":  # the second argument is the rest of the stream
        args = (args[0], io.BytesIO(args[1]))
    try:
        return ("ok", getattr(mod, name)(*args, **kwargs))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", PROTOCOL_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(PROTOCOL_CASES)])
def test_protocol_equals_jax(case):
    assert _call(protocol, case) == _call(jax_protocol, case)


def test_seal_always_carries_the_crc():
    """No knob: every frame is sealed, and a crc-less frame still passes."""
    obj = {"ok": True, "id": "ab12"}
    line = protocol.seal(obj)
    assert b',"crc":' in line and protocol.unseal(line) == obj
    assert protocol.unseal(protocol.encode(obj)) == obj


def _queue_trace(queue_cls, pending_cls):
    """One admission sequence: batching, backpressure, basename deferral,
    deadline shedding, cancel and drain; returns what each step gave."""
    now = time.monotonic()
    shed: list = []
    q = queue_cls(max_queue=4, on_shed=lambda r: shed.append(r.req_id))
    out = []

    def mk(path, rid, deadline=None):
        return pending_cls(genome=path, reply=lambda r: None, req_id=rid, deadline=deadline)

    for path, rid, dl in (("/a/x.fa", "1", None), ("/a/y.fa", "2", now - 1.0), ("/b/x.fa", "3", None),
                          ("/a/z.fa", "4", now + 60.0), ("/c/w.fa", "5", None)):
        out.append(q.submit(mk(path, rid, dl)))
    out.append([r.req_id for r in q.next_batch(max_batch=8, window_s=0.0)])
    out.append(list(shed))
    out.append([r.req_id for r in q.next_batch(max_batch=8, window_s=0.0)])
    for path, rid in (("/a/x.fa", "6"), ("/a/x.fa", "7"), ("/d/v.fa", "8")):
        out.append(q.submit(mk(path, rid)))
    out.append(q.cancel("8").req_id)
    out.append((q.cancel("8"), q.cancel("ghost"), q.cancel(None), q.depth()))
    out.append([r.req_id for r in q.next_batch(max_batch=1, window_s=0.0)])
    q.drain()
    out.append((q.submit(mk("/e/u.fa", "9")), q.draining))
    out.append([r.req_id for r in q.next_batch(8, 0.0)])
    out.append(q.next_batch(8, 0.0))
    return out


def test_admission_queue_equals_jax():
    got = _queue_trace(AdmissionQueue, PendingRequest)
    assert got == _queue_trace(JaxAdmissionQueue, JaxPendingRequest)
    assert got[4] == "backpressure" and got[5] == ["1", "4"] and got[6] == ["2"]


@pytest.mark.parametrize("depth,max_batch,window_s,batches_ms", [
    (0, 8, 0.05, None), (16, 8, 0.05, None), (0, 1, 0.0, None),
    (0, 8, 0.05, [100.0, 200.0, 300.0]), (16, 8, 0.05, [100.0, 200.0, 300.0]),
    (7, 0, 0.002, [5.0] * 40 + [900.0]),
])
def test_queue_eta_equals_jax(depth, max_batch, window_s, batches_ms):
    h, jh = (None, None) if batches_ms is None else (Histogram(size=32), JaxHistogram(size=32))
    for ms in batches_ms or ():
        h.observe(ms)
        jh.observe(ms)
    got = queue_eta_s(depth, max_batch, window_s, h)
    assert got == jax_queue_eta_s(depth, max_batch, window_s, jh)
    if batches_ms is None:
        assert got == pytest.approx((depth // max(1, max_batch) + 1) * window_s)


def test_histogram_report_and_prom(tmp_path):
    h, jh = Histogram(size=100), JaxHistogram(size=100)
    for v in range(1, 1001):
        h.observe(float(v))
        jh.observe(float(v))
    assert h.summary() == jh.summary() and h.percentile(0.5) == jh.percentile(0.5)
    c = Counters()
    c.observe("serve_request_ms", 5.0)
    c.observe("serve_request_ms", 15.0)
    c.add_fault("serve_rejected")
    c.set_gauge("serve_generation", 3)
    with c.stage("serve_batch"):
        pass
    rep = c.report()
    assert rep["histograms"]["serve_request_ms"]["count"] == 2
    assert rep["fault_tolerance"] == {"serve_rejected": 1} and rep["stages"]["serve_batch"]["calls"] == 1
    text = prom_text(c)
    assert 'drep_tpu_latency{name="serve_request_ms",stat="p99"} 15.0' in text
    assert 'drep_tpu_gauge{name="serve_generation"} 3.0' in text
    assert json.load(open(c.write(str(tmp_path))))["gauges"] == {"serve_generation": 3.0}
    c.reset()
    assert not c.hists and not c.stages


# ---- the resident rectangle ------------------------------------------------


@pytest.fixture(scope="module")
def serve_index(tmp_path_factory):
    """One small structured index (three groups, so LSH pruning has tiles
    to skip) and three queries (two indexed genomes, one novel)."""
    td = tmp_path_factory.mktemp("serve_idx")
    paths = lib.write_genome_set(str(td / "g"), [4, 4, 4], seed=5)
    loc = str(td / "idx")
    build_from_paths(loc, paths, length=0, streaming_block=4, device=CPU)
    queries = [paths[1], paths[5]] + lib.write_genome_set(str(td / "q"), [1], seed=77, prefix="novel")
    oneshot = {q: index_classify(loc, [q], device=CPU)[0] for q in queries}
    return loc, queries, oneshot


@pytest.mark.parametrize("prune", ["off", "lsh"])
def test_classify_separate_equals_oneshot_and_jax(serve_index, prune):
    loc, queries, oneshot = serve_index
    digest = lib.tree_digest(loc, exclude_dirs=())
    resident = load_resident_index(loc)
    got = classify_batch(resident, sketch_queries(resident, queries), prune_cfg={"primary_prune": prune},
                         joint=False, device=CPU)
    assert [v["genome"] for v in got] == [os.path.basename(q) for q in queries]
    for q, v in zip(queries, got):
        assert v == oneshot[q], (prune, q)
        assert_verdicts_match([v], jax_index_classify(loc, [q], primary_prune=prune))
    assert got[2]["novel_primary"] and not got[0]["novel_primary"]
    assert resident.n == 12 and resident.generation == 0
    assert lib.tree_digest(loc, exclude_dirs=()) == digest


def test_resident_uploads_once_per_generation(serve_index):
    loc, queries, oneshot = serve_index
    resident_device.reset_for_tests()
    resident = load_resident_index(loc)
    for _ in range(3):
        got = classify_batch(resident, sketch_queries(resident, queries), joint=False, device=CPU)
        assert got == [oneshot[q] for q in queries]
    assert resident_device.upload_count() == 1, "re-uploaded per batch"
    assert resident_device.fallback_count() == 0
    assert counters.gauges.get("serve_resident_uploads") == 1.0
    # a hot swap installs a fresh resident object: one more upload
    fresh = load_resident_index(loc)
    assert resident_device.prewarm_resident(fresh, CPU)
    assert resident_device.upload_count() == 2
    assert classify_batch(fresh, sketch_queries(fresh, queries), joint=False, device=CPU) == got
    assert resident_device.upload_count() == 2


@pytest.mark.parametrize("tight", [False, True])
def test_resident_edges_equal_union_edges(serve_index, monkeypatch, tight):
    """The resident rectangle's (ii, jj, dd) equal the union path's edges
    with ii < n_old, bit for bit; `tight` narrows the id space to three
    ids a rank (one spare a gap), which the two indexed queries still fit."""
    loc, queries, _ = serve_index
    resident = load_resident_index(loc)
    n_old = resident.n
    if tight:
        vocab = np.unique(np.concatenate([np.asarray(b)[: int(resident.params["sketch_size"])]
                                          for b in resident.bottom]))
        monkeypatch.setattr(resident_device, "ID_SPAN", 3 * (vocab.size + 1))
        queries = queries[:2]
    sq = sketch_queries(resident, queries)
    ii, jj, dd = resident_device.rect_edges_device(resident, sq, n_old, CPU)
    assert resident_device.pack_for(resident, CPU).stride == (3 if tight else resident_device.ID_SPAN // (
        resident_device.pack_for(resident, CPU).vocab.size + 1))
    scratch = _scratch_index(resident)
    _admit_batch(scratch, sq.admitted, sq.results, resident.generation + 1)
    uii, ujj, udd, _ = _rect_edges(scratch, n_old, None, device=CPU)
    sel = uii < n_old
    order = np.lexsort((ujj[sel], uii[sel]))
    assert len(ii) > len(queries)
    assert np.array_equal(ii, uii[sel][order]) and np.array_equal(jj, ujj[sel][order])
    assert dd.dtype == np.float32 and dd.tobytes() == udd[sel][order].tobytes()


def test_gap_overflow_takes_union_path(serve_index, monkeypatch):
    """A query row with more misses in one gap than the stride holds
    takes the union path, counted once, with the same verdicts."""
    loc, queries, oneshot = serve_index
    resident = load_resident_index(loc)
    vocab = np.unique(np.concatenate([np.asarray(b)[: int(resident.params["sketch_size"])]
                                      for b in resident.bottom]))
    monkeypatch.setattr(resident_device, "ID_SPAN", 3 * (vocab.size + 1))
    resident_device.reset_for_tests()
    sq = sketch_queries(resident, queries)
    pack = resident_device.pack_for(resident, CPU)
    assert resident_device._map_queries(pack, [sq.results[g]["bottom"] for g in sq.admitted["genome"]]) == (
        None, None)
    got = classify_batch(resident, sq, joint=False, device=CPU)
    assert got == [oneshot[q] for q in queries]
    assert resident_device.fallback_count() == 1 and resident_device.upload_count() == 1


# ---- the daemon ------------------------------------------------------------


def _start_server(loc, **over):
    classify_fn = over.pop("classify_fn", None)
    kw = {"batch_window_ms": 200.0, "max_batch": 16, "poll_generation_s": 0.1, "device": "cpu"}
    kw.update(over)
    srv = IndexServer(ServeConfig(index_loc=loc, **kw), classify_fn=classify_fn)
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    return srv, addr, t


def _stop_server(srv, t):
    srv.request_drain()
    t.join(timeout=30)
    srv.close()
    assert not t.is_alive()


def _concurrent(addr, queries, client_cls=ServeClient):
    results: dict[str, dict] = {}
    errors: list = []
    barrier = threading.Barrier(len(queries))

    def one(q):
        try:
            with client_cls(addr) as c:
                barrier.wait()
                results[q] = c.classify(q)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one, args=(q,)) for q in queries]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and not any(th.is_alive() for th in threads)
    return results


@pytest.mark.parametrize("prune", ["off", "lsh"])
def test_concurrent_clients_match_oneshot_fewer_batches(serve_index, prune):
    loc, queries, oneshot = serve_index
    digest = lib.tree_digest(loc, exclude_dirs=())
    counters.reset()
    resident_device.reset_for_tests()
    srv, addr, t = _start_server(loc, prune_cfg={"primary_prune": prune})
    try:
        results = _concurrent(addr, queries)
        for q in queries:
            assert results[q]["verdict"] == oneshot[q], q
        assert srv.stats.batches_total < len(queries)
        assert counters.stages["serve_batch"].calls == srv.stats.batches_total
        assert max(r["batch_size"] for r in results.values()) >= 2
        assert resident_device.upload_count() == 1 and resident_device.fallback_count() == 0
    finally:
        _stop_server(srv, t)
    assert lib.tree_digest(loc, exclude_dirs=()) == digest


def test_status_snapshot_http_shim_and_refused_ops(serve_index):
    loc, queries, oneshot = serve_index
    srv, addr, t = _start_server(loc, batch_window_ms=1.0)
    try:
        with ServeClient(addr) as c:
            assert c.classify(queries[0])["verdict"] == oneshot[queries[0]]
            st = c.status()
            assert c.ping() == {"ok": True, "op": "ping", "generation": 0}
            for req, reason in (({"op": "classify_part", "pid": 0, "generation": 0, "names": ["a"],
                                  "bottoms": [[1]], "id": "p"}, "not_federated"),
                                ({"op": "prewarm", "partitions": [0], "id": "w"}, "not_federated"),
                                ({"op": "fleet", "action": "join", "address": "h:1", "id": "f"}, "not_a_router")):
                resp = c.request(req)
                assert not resp["ok"] and resp["reason"] == reason and resp["id"] == req["id"]
        assert st["generation"] == 0 and st["n_genomes"] == 12 and "update_pod" not in st
        assert st["requests_total"] == 1 and st["batches_total"] == 1
        assert st["latency_ms"]["serve_request_ms"]["count"] >= 1
        with urllib.request.urlopen(f"http://{addr}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["generation"] == 0 and health["n_genomes"] == 12
        body = json.dumps({"genome": queries[1]}).encode()
        req = urllib.request.Request(f"http://{addr}/classify", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            doc = json.loads(resp.read())
        assert doc["ok"] and doc["verdict"] == oneshot[queries[1]]
    finally:
        _stop_server(srv, t)


def test_hot_swap_generation_mid_stream(tmp_path):
    """Publish generation 1 under a serving daemon: no request dropped or
    misclassified, each verdict equal to the one-shot answer at the
    generation it is stamped with, one more upload for the swap."""
    paths = lib.write_genome_set(str(tmp_path / "g"), [3, 2], seed=5)
    extra = lib.write_genome_set(str(tmp_path / "x"), [1], seed=31, prefix="x")
    queries = lib.write_genome_set(str(tmp_path / "q"), [2], seed=77, prefix="q")
    loc = str(tmp_path / "idx")
    build_from_paths(loc, paths[:4], length=0, device=CPU)
    frozen = str(tmp_path / "idx_gen0")
    shutil.copytree(loc, frozen)
    resident_device.reset_for_tests()
    srv, addr, t = _start_server(loc, batch_window_ms=1.0)
    responses: list[dict] = []
    stop = threading.Event()
    errors: list = []

    def stream():
        try:
            with ServeClient(addr) as c:
                i = 0
                while not stop.is_set():
                    responses.append(c.classify(queries[i % len(queries)]))
                    i += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    streamer = threading.Thread(target=stream, daemon=True)
    streamer.start()
    try:
        deadline = time.monotonic() + 60
        while not responses and time.monotonic() < deadline:
            time.sleep(0.01)
        index_update(loc, [paths[4]], device=CPU)
        digest_after_update = lib.tree_digest(loc, exclude_dirs=())
        while time.monotonic() < deadline and not any(r["generation"] == 1 for r in responses):
            time.sleep(0.05)
        stop.set()
        streamer.join(timeout=60)
        assert not errors and not streamer.is_alive()
        assert {r["generation"] for r in responses} == {0, 1}
        assert srv.stats.swaps_total == 1 and resident_device.upload_count() == 2
        oracle = {(0, q): index_classify(frozen, [q], device=CPU)[0] for q in queries} | {
            (1, q): index_classify(loc, [q], device=CPU)[0] for q in queries}
        by_name = {os.path.basename(q): q for q in queries}
        for r in responses:
            assert r["verdict"] == oracle[(r["generation"], by_name[r["verdict"]["genome"]])]
        with ServeClient(addr) as c:
            r = c.classify(extra[0])
        assert r["generation"] == 1 and r["verdict"] == index_classify(loc, [extra[0]], device=CPU)[0]
    finally:
        stop.set()
        _stop_server(srv, t)
    assert lib.tree_digest(loc, exclude_dirs=()) == digest_after_update


def test_backpressure_and_drain_refusals(serve_index):
    loc, _queries, _ = serve_index
    started = threading.Event()

    def slow_classify(resident, paths):
        started.set()
        time.sleep(0.4)
        return {os.path.basename(p): {"genome": os.path.basename(p), "generation": int(resident.generation)}
                for p in paths}

    srv, addr, t = _start_server(loc, max_queue=2, max_batch=1, batch_window_ms=0.0, poll_generation_s=60.0,
                                 classify_fn=slow_classify)
    try:
        fake = [os.path.join(loc, "manifest.json")] * 5  # any readable file
        first_resp: list = []
        opener = threading.Thread(
            target=lambda: first_resp.extend(ServeClient(addr, timeout_s=60).classify_many(fake[:1])),
            daemon=True,
        )
        opener.start()
        assert started.wait(timeout=30)
        with ServeClient(addr, timeout_s=60) as c:
            resps = c.classify_many(fake[1:])
        opener.join(timeout=30)
        ok = [r for r in first_resp + resps if r.get("ok")]
        refused = [r for r in first_resp + resps if not r.get("ok")]
        assert len(ok) == 3 and len(refused) == 2, (first_resp, resps)
        for r in refused:
            assert r["reason"] == "backpressure" and r["retry_after_s"] > 0
        assert srv.stats.rejected_total == 2
        srv.request_drain()
        with pytest.raises((ServeError, OSError)) as ei:
            with ServeClient(addr, timeout_s=10) as c2:
                c2.classify(fake[0])
        if isinstance(ei.value, ServeError):
            assert ei.value.reason in ("draining", "disconnected")
    finally:
        srv.queue.drain()
        t.join(timeout=30)
        srv.close()


def test_daemon_deadline_shed_cancel_and_eta_refusal(serve_index):
    loc, _queries, _ = serve_index
    started = threading.Event()
    release = threading.Event()
    dispatched: list[str] = []

    def gated_classify(resident, paths):
        dispatched.extend(os.path.basename(p) for p in paths)
        started.set()
        release.wait(timeout=30)
        return {os.path.basename(p): {"genome": os.path.basename(p), "generation": int(resident.generation)}
                for p in paths}

    counters.reset()  # a fresh serve_batch_ms histogram: ETA = window only
    srv, addr, t = _start_server(loc, max_queue=8, max_batch=1, batch_window_ms=0.0, poll_generation_s=60.0,
                                 classify_fn=gated_classify)
    try:
        blocker = os.path.join(loc, "manifest.json")
        opener = threading.Thread(target=lambda: ServeClient(addr, timeout_s=60).classify(blocker), daemon=True)
        opener.start()
        assert started.wait(timeout=30)
        with ServeClient(addr, timeout_s=60) as c:
            c._send({"op": "classify", "genome": blocker, "id": "victim", "deadline_ms": 100})
            c._send({"op": "classify", "genome": blocker, "id": "v2"})
            deadline = time.monotonic() + 30
            while srv.queue.depth() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert srv.queue.depth() == 2
            with ServeClient(addr, timeout_s=30) as c2:
                assert c2.cancel("v2") is True
                assert c2.cancel("ghost") is False
            gone = c._recv_for("v2")
            assert not gone["ok"] and gone["reason"] == "cancelled"
            time.sleep(0.25)  # the victim's 100 ms budget burns in queue
            release.set()
            shed = c._recv_for("victim")
            assert not shed["ok"] and shed["reason"] == "deadline_exceeded" and shed["retry_after_s"] > 0
        opener.join(timeout=60)
        assert dispatched == ["manifest.json"]
        assert srv.stats.deadline_shed == 1 and srv.stats.cancels == 1
        snap = srv.snapshot()
        assert snap["deadline_shed"] == 1 and snap["cancels"] == 1
        # the histogram now knows a batch takes ~250 ms+: a 10 ms budget is
        # refused at admission
        with pytest.raises(ServeError) as ei:
            with ServeClient(addr, timeout_s=30) as c3:
                c3.classify(blocker, deadline_ms=10)
        assert ei.value.reason == "deadline_exceeded" and ei.value.retry_after_s > 0
        deadline = time.monotonic() + 10
        while srv.stats.deadline_shed < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats.deadline_shed == 2 and dispatched == ["manifest.json"]
    finally:
        release.set()
        _stop_server(srv, t)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_zero_default_deadline_admits_and_answers(serve_index, monkeypatch, package):
    """A default budget of 0 means none: a request without deadline_ms is
    neither refused at admission (the queue ETA is the batch window, above
    0) nor shed, and is answered, in both packages' daemons."""
    loc, queries, oneshot = serve_index
    monkeypatch.setenv("DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS", "0")
    monkeypatch.setenv("DREP_TPU_SERVE_DEADLINE_DEFAULT_MS", "0")
    counters.reset()
    if package == "port":
        srv, addr, t = _start_server(loc, batch_window_ms=200.0, poll_generation_s=60.0)
    else:
        srv = JaxIndexServer(JaxServeConfig(index_loc=loc, batch_window_ms=200.0, max_batch=16,
                                            poll_generation_s=60.0))
        addr = srv.start()
        t = threading.Thread(target=srv.serve_batches, daemon=True)
        t.start()
    try:
        assert srv._budget_ms({}) is None
        with ServeClient(addr, timeout_s=120) as c:
            resp = c.classify(queries[0])
        assert resp["ok"] and resp["verdict"] == oneshot[queries[0]]
        assert srv.stats.deadline_shed == 0 and srv.stats.rejected_total == 0
    finally:
        _stop_server(srv, t)


def test_poisoned_batch_isolates_the_bad_query(serve_index, tmp_path):
    loc, queries, oneshot = serve_index
    bad = str(tmp_path / "bad.fasta")
    with open(bad, "wb") as f:
        f.write(b"\x00\x01 definitely not fasta\n")
    srv, addr, t = _start_server(loc, batch_window_ms=300.0)
    try:
        with ServeClient(addr, timeout_s=120) as c:
            resps = c.classify_many([queries[0], bad, queries[1]])
        assert resps[0]["verdict"] == oneshot[queries[0]] and resps[2]["verdict"] == oneshot[queries[1]]
        assert not resps[1]["ok"] and resps[1]["reason"] == "classify_failed"
        assert "bad.fasta" in resps[1]["error"]
        assert counters.faults.get("serve_batch_poisoned", 0) >= 1
    finally:
        _stop_server(srv, t)


def test_serve_wrapper_refuses_log_dir_inside_index(tmp_path):
    from drep_tpu_torch.workflows import index_serve_wrapper

    loc = str(tmp_path / "idx")
    os.makedirs(loc)
    with pytest.raises(UserInputError, match="read-only"):
        index_serve_wrapper(loc, log_dir=os.path.join(loc, "log"), device="cpu")
    assert os.listdir(loc) == []


# ---- either package's client against the other's daemon --------------------


def test_jax_client_against_port_daemon(serve_index):
    loc, queries, oneshot = serve_index
    digest = lib.tree_digest(loc, exclude_dirs=())
    srv, addr, t = _start_server(loc)
    try:
        results = _concurrent(addr, queries, client_cls=JaxServeClient)
        for q in queries:
            assert results[q]["verdict"] == oneshot[q], q
        assert srv.stats.batches_total < len(queries)
    finally:
        _stop_server(srv, t)
    assert lib.tree_digest(loc, exclude_dirs=()) == digest


def test_port_client_against_jax_daemon(serve_index):
    loc, queries, _ = serve_index
    digest = lib.tree_digest(loc, exclude_dirs=())
    srv = JaxIndexServer(JaxServeConfig(index_loc=loc, batch_window_ms=200.0, max_batch=16,
                                        poll_generation_s=60.0))
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    try:
        results = _concurrent(addr, queries)
        for q in queries:
            assert results[q]["verdict"] == jax_index_classify(loc, [q])[0], q
        with ServeClient(addr) as c:
            assert c.status()["n_genomes"] == 12
    finally:
        _stop_server(srv, t)
    assert lib.tree_digest(loc, exclude_dirs=()) == digest


# ---- the CLI daemon ----------------------------------------------------------


def test_cli_daemon_sigterm_drains_cleanly(tmp_path):
    paths = lib.write_genome_set(str(tmp_path / "g"), [2, 1], seed=9)
    loc = str(tmp_path / "idx")
    build_from_paths(loc, paths, length=0, device=CPU)
    digest = lib.tree_digest(loc, exclude_dirs=())
    q = lib.write_genome_set(str(tmp_path / "q"), [1], seed=3, prefix="q")
    sock = str(tmp_path / "serve.sock")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "drep_tpu_torch", "index", "serve", loc, "--device", "cpu",
         "--socket", sock, "--batch_window_ms", "20", "--log_dir", str(tmp_path / "log")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO, env=env,
    )
    try:
        line = proc.stdout.readline()
        assert line, "daemon died before its ready line"
        ready = json.loads(line)
        assert ready["serving"] == sock and ready["generation"] == 0 and ready["n_genomes"] == 3
        with ServeClient(sock, timeout_s=300) as c:
            resps = c.classify_many(q + [paths[0]])
        assert [r["verdict"] for r in resps] == [index_classify(loc, [p], device=CPU)[0] for p in q + [paths[0]]]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        with pytest.raises((ConnectionRefusedError, OSError, ServeError)):
            ServeClient(sock, timeout_s=5).ping()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert lib.tree_digest(loc, exclude_dirs=()) == digest
    perf = json.load(open(tmp_path / "log" / "perf_counters.json"))
    assert perf["histograms"]["serve_request_ms"]["count"] == 2
