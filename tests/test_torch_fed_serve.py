"""The port's streaming federated resident (drep_tpu_torch/index/
federation.py::FederatedResident, classify_batch_federated) and the
daemon's federated ops against the JAX package's, on the CPU.

One P = 3 federation of three groups (3, 2, 2 genomes, split across
partitions at this seed), built by the JAX package, is read by both
packages' residents:

- ``bitmap_contains_any`` equal to the JAX package's on seeded codes;
- the spine: n, generation, names, the union mapping, route candidates
  and the health map equal;
- streaming verdicts, joint and separate, equal the JAX package's
  streaming verdicts as full dicts (``nearest_dist`` at rtol 1e-6: each
  package runs its own Mash walk, and XLA's and numpy's float32 log can
  differ in the last bit), and the port's union classify exactly once
  the coverage stamps are stripped; the root's tree digest unchanged;
- the LRU budget: the same loads, evictions and peak;
- on a copy with one partition's manifest bit-rotted: the same
  quarantine, reason and PARTIAL verdicts, the same transitive
  exclusion stamp; a strict daemon refuses with ``partial_coverage`` and
  ``retry_after_s``; once healed, a probe restores full coverage.
"""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_verdicts_match  # noqa: E402

from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.index import classify_batch as jax_classify_batch  # noqa: E402
from drep_tpu.index import load_resident_index as jax_load_resident_index  # noqa: E402
from drep_tpu.index import sketch_queries as jax_sketch_queries  # noqa: E402
from drep_tpu.index.federation import FederatedResident as JaxFederatedResident  # noqa: E402
from drep_tpu.index.federation import _affected_by_exclusion as jax_affected  # noqa: E402
from drep_tpu.ops import rangepart as jax_rangepart  # noqa: E402
from drep_tpu.utils.durableio import _flip_bit  # noqa: E402
from drep_tpu_torch.index import (  # noqa: E402
    FederatedResident,
    classify_batch,
    load_resident_index,
    sketch_queries,
)
from drep_tpu_torch.index.federation import _affected_by_exclusion  # noqa: E402
from drep_tpu_torch.ops import rangepart  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig, ServeError  # noqa: E402

CPU = torch.device("cpu")
GROUPS = [3, 2, 2]
SEED = 3
# health-map fields that read the clock
_CLOCK_FIELDS = ("last_probe_ago_s", "next_probe_in_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(verdict: dict) -> dict:
    """A streaming verdict without its coverage stamps: the union path's shape."""
    return {k: v for k, v in verdict.items() if k not in ("partitions_consulted", "partitions_unavailable", "partial")}


def _health(fed) -> dict:
    """A resident's health map without the fields that read the clock."""
    hm = dict(fed.health_map())
    hm["partitions"] = {
        pid: {k: v for k, v in entry.items() if k not in _CLOCK_FIELDS} for pid, entry in hm["partitions"].items()
    }
    return hm


@pytest.fixture(scope="module")
def fed_store(tmp_path_factory):
    """The P = 3 federation and two queries: an indexed member and a novel genome."""
    td = tmp_path_factory.mktemp("torch_fed_serve")
    paths = lib.write_genome_set(str(td / "g"), GROUPS, seed=SEED)
    loc = str(td / "fed")
    jax_build_federated(loc, paths, 3, length=0)
    novel = lib.write_genome_set(str(td / "q"), [1], seed=97, prefix="novel")
    return loc, paths, paths[:1] + novel


@pytest.fixture()
def damaged_copy(fed_store, tmp_path):
    """A copy with the manifest of the partition holding the first genome
    bit-rotted, and a query whose component never touches it."""
    loc, paths, _queries = fed_store
    copy = str(tmp_path / "fed_damaged")
    shutil.copytree(loc, copy)
    fed = load_resident_index(copy, device=CPU)
    victim = int(fed.part_of[fed.names.index(os.path.basename(paths[0]))])
    safe = paths[3]  # group 1 co-locates in one partition at this seed
    assert int(fed.part_of[fed.names.index(os.path.basename(safe))]) != victim
    mf = os.path.join(copy, f"part_{victim:03d}", "manifest.json")
    orig = open(mf, "rb").read()
    _flip_bit(mf)
    return copy, victim, paths, safe, mf, orig


def test_bitmap_contains_any_equals_jax():
    rng = np.random.default_rng(11)
    bits = rangepart.ROUTE_SUMMARY_BITS
    assert bits == jax_rangepart.ROUTE_SUMMARY_BITS
    rows = [np.sort(rng.integers(0, 2**63, size=50, dtype=np.uint64)) for _ in range(4)]
    bitmap = rangepart.code_summary_bitmap(rows, bits)
    assert np.array_equal(bitmap, jax_rangepart.code_summary_bitmap(rows, bits))
    hits = 0
    for t in range(200):
        if t % 3 == 0:  # codes of an indexed row, plus strays
            codes = np.unique(np.concatenate([rangepart.coarse_codes(rows[t % 4], bits)[:2],
                                              rng.integers(0, 1 << bits, size=3)]))
        else:
            codes = np.unique(rng.integers(0, 1 << bits, size=int(rng.integers(0, 6))))
        got = rangepart.bitmap_contains_any(bitmap, codes)
        assert got == jax_rangepart.bitmap_contains_any(bitmap, codes)
        hits += got
    assert 0 < hits < 200
    assert rangepart.bitmap_contains_any(bitmap, np.empty(0, np.int64)) is False


def test_resident_spine_equals_jax(fed_store):
    loc, _paths, queries = fed_store
    fed = load_resident_index(loc, device=CPU)
    jfed = jax_load_resident_index(loc)
    assert isinstance(fed, FederatedResident) and isinstance(jfed, JaxFederatedResident)
    assert (fed.n, fed.generation, fed.params) == (jfed.n, jfed.generation, jfed.params) == (7, 0, jfed.params)
    assert fed.names == jfed.names and fed.union.locations == jfed.union.locations
    assert np.array_equal(fed.part_of, jfed.part_of) and np.array_equal(fed.local_of, jfed.local_of)
    assert all(np.array_equal(a, b) for a, b in zip(fed.edges_excluding(set()), jfed.edges_excluding(set())))
    sq = sketch_queries(fed, queries)
    bottoms = [np.asarray(sq.results[g]["bottom"], np.uint64) for g in sq.admitted["genome"]]
    assert fed.route_candidates(bottoms) == jfed.route_candidates(bottoms)
    # the spine loads no sketch payload
    assert _health(fed) == _health(jfed) and fed.health_map()["resident_partitions"] == 0
    assert fed.retry_hint_s() == jfed.retry_hint_s()


@pytest.mark.parametrize("joint", [False, True], ids=["separate", "joint"])
def test_streaming_verdicts_equal_jax_and_union(fed_store, joint):
    """Streaming verdicts equal the JAX package's streaming ones as full
    dicts, and the port's union-assembled classify once stripped; the
    resident writes nothing under the root."""
    loc, _paths, queries = fed_store
    digest = lib.tree_digest(loc, exclude_dirs=())
    fed = load_resident_index(loc, device=CPU)
    got = classify_batch(fed, sketch_queries(fed, queries), joint=joint, device=CPU)
    jfed = jax_load_resident_index(loc)
    want = jax_classify_batch(jfed, jax_sketch_queries(jfed, queries), joint=joint)
    assert_verdicts_match(got, want)
    assert all(v["partitions_unavailable"] == [] and v["partitions_consulted"] for v in got)
    union = load_resident_index(loc, streaming=False)
    oracle = classify_batch(union, sketch_queries(union, queries), joint=joint, device=CPU)
    assert [_strip(v) for v in got] == oracle
    assert _health(fed) == _health(jfed)
    # one rectangle per consulted partition, one stripe each at this size
    assert fed.work["compares"] == fed.work["stripes"] == len({p for v in got for p in v["partitions_consulted"]})
    assert fed.work["reclusters"] == (1 if joint else len(queries))
    assert lib.tree_digest(loc, exclude_dirs=()) == digest


def test_lru_budget_equals_jax(fed_store):
    """Under a budget of ~1.5 partitions, queries spanning all three are
    answered one batch each as the JAX package answers them, with the same
    loads, evictions and peak, settled under the budget after each batch."""
    loc, _paths, _queries = fed_store
    probe = load_resident_index(loc, device=CPU)
    by_pid: dict[int, str] = {}
    for p, location in zip(probe.part_of, probe.union.locations):
        by_pid.setdefault(int(p), location)
    span = [by_pid[p] for p in sorted(by_pid)]
    assert len(span) == 3
    probe.ensure_resident(0)
    budget = int(probe._slots[0].resident_bytes * 1.5)
    fed = FederatedResident(loc, device=CPU)
    jfed = JaxFederatedResident(loc)
    fed.budget_bytes = jfed.budget_bytes = budget
    for q in span:
        got = classify_batch(fed, sketch_queries(fed, [q]), joint=False)[0]
        want = jax_classify_batch(jfed, jax_sketch_queries(jfed, [q]), joint=False)[0]
        assert_verdicts_match([got], [want])
        assert got["partitions_unavailable"] == []
        assert fed._resident_total <= fed.budget_bytes
        assert _health(fed) == _health(jfed)
    hm = fed.health_map()
    assert hm["evictions"] >= 1 and hm["peak_resident_partitions"] < 3, hm
    # resident_mb is the same budget in MiB
    assert FederatedResident(loc, resident_mb=2, device=CPU).budget_bytes == 2 << 20


def test_bit_rotted_partition_partial_equals_jax(damaged_copy):
    """A rotted partition manifest quarantines that partition at the spine
    load in both packages (the same reason text); the query touching it
    gets the JAX package's PARTIAL verdict, joint and separate, the
    unaffected one its full verdict, and the transitive exclusion stamp
    (a partition reached only through dropped edges) is the JAX package's."""
    copy, victim, paths, safe, _mf, _orig = damaged_copy
    fed = FederatedResident(copy, device=CPU)
    jfed = JaxFederatedResident(copy)
    hm = fed.health_map()
    assert hm["quarantined"] == [victim] and _health(fed) == _health(jfed)
    entry = hm["partitions"][str(victim)]
    assert f"partition {victim}" in entry["reason"] and "--partition" in entry["heal_hint"]
    for joint in (False, True):
        got = classify_batch(fed, sketch_queries(fed, [paths[0], safe]), joint=joint)
        want = jax_classify_batch(jfed, jax_sketch_queries(jfed, [paths[0], safe]), joint=joint)
        assert_verdicts_match(got, want)
        assert got[0]["partial"] is True and victim in got[0]["partitions_unavailable"]
        assert victim not in got[0]["partitions_consulted"]
    # the spanning-group member reaches the victim only through dropped edges
    u_span = fed.names.index(os.path.basename(paths[1]))
    assert int(fed.part_of[u_span]) != victim
    u_safe = fed.names.index(os.path.basename(safe))
    for u in (u_span, u_safe):
        q_edges = [(np.asarray([u], np.int64), np.asarray([0.05], np.float32))]
        assert _affected_by_exclusion(fed, q_edges, {victim}) == jax_affected(jfed, q_edges, {victim})
    q_edges = [(np.asarray([u_span], np.int64), np.asarray([0.05], np.float32))]
    assert _affected_by_exclusion(fed, q_edges, {victim}) == [{victim}]


def test_strict_daemon_partial_coverage_then_recovery(damaged_copy):
    """The daemon on the damaged copy: a strict classify is refused with
    ``partial_coverage`` and ``retry_after_s``, the plain one answers the
    stamped PARTIAL verdict, the snapshot carries the health map; once the
    manifest is restored the next probe recovers the partition."""
    copy, victim, paths, _safe, mf, orig = damaged_copy
    srv = IndexServer(ServeConfig(index_loc=copy, batch_window_ms=1.0, poll_generation_s=60.0, device=CPU))
    addr = srv.start()
    loop = threading.Thread(target=srv.serve_batches, daemon=True)
    loop.start()
    try:
        with ServeClient(addr, timeout_s=300) as c:
            with pytest.raises(ServeError) as ei:
                c.classify(paths[0], strict=True)
            assert ei.value.reason == "partial_coverage"
            assert ei.value.retry_after_s and ei.value.retry_after_s > 0
            r = c.classify(paths[0])
            assert r["ok"] and r["verdict"]["partial"] is True
            assert victim in r["verdict"]["partitions_unavailable"]
            snap = srv.snapshot()
            assert snap["partitions"]["quarantined"] == [victim] and snap["partial_refusals"] == 1
            with open(mf, "wb") as f:
                f.write(orig)
            time.sleep(srv._resident.retry_hint_s() + 0.05)  # the quarantine's reload probe is due
            r = c.classify(paths[0], strict=True)
            assert r["ok"] and r["verdict"]["partitions_unavailable"] == [] and "partial" not in r["verdict"]
        hm = srv.snapshot()["partitions"]
        assert hm["recoveries"] == 1 and hm["partitions"][str(victim)]["state"] == "healthy"
    finally:
        srv.request_drain()
        loop.join(timeout=60)
        srv.close()


def test_streaming_resident_wants_cuda_unless_asked(fed_store, monkeypatch):
    """No quiet CPU path: without CUDA and without device='cpu' the
    streaming resident refuses before it reads anything."""
    loc, _paths, _queries = fed_store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_resident_index(loc)
    assert load_resident_index(loc, device=CPU).device == CPU
