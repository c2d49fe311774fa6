"""The port's federated genome index (drep_tpu_torch/index/federation.py,
index/meta.py) against the JAX package's on the same FASTAs, on the CPU.

Stores are compared as tests/test_torch_index.py compares them, extended
to a federation: federation.json and every partition manifest byte-equal,
every npz payload array-equal, except the `dist` (and `__crc__`) of an
edge or cross shard that each package computed with its own Mash walk,
held at rtol=1e-6 with (ii, jj) equal. Verdicts are compared field by
field, `nearest_dist` at rtol=1e-6.

The planted set stays below 512 genomes at --streaming_block 128, where
both packages' walks take the same stripes.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_stores_match, assert_verdicts_match  # noqa: E402

from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.index import classify as jax_classify  # noqa: E402
from drep_tpu.index import index_update as jax_index_update  # noqa: E402
from drep_tpu.index import meta as jax_meta  # noqa: E402
from drep_tpu.ops import rangepart as jax_rangepart  # noqa: E402
from drep_tpu_torch.errors import UserInputError  # noqa: E402
from drep_tpu_torch.index import (  # noqa: E402
    build_federated,
    index_classify,
    index_update,
    load_index,
    read_params_handoff,
    write_params_handoff,
)
from drep_tpu_torch.index import federation as fed_mod  # noqa: E402
from drep_tpu_torch.index import meta  # noqa: E402
from drep_tpu_torch.ops import rangepart  # noqa: E402
from drep_tpu_torch.workflows import dereplicate_wrapper  # noqa: E402

CPU = "cpu"
PLANTED = {"length": 0, "MASH_sketch": 256, "streaming_block": 128}
# the base build, a 20-genome batch and a K = 1 trickle; the genomes past
# the last step are classify queries
SCHEDULE = [(0, 60), (60, 80), (80, 81)]
LIFECYCLE_P = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst


def _meta(loc: str) -> dict:
    with open(os.path.join(loc, "federation.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def planted(tmp_path_factory) -> list[str]:
    """90 planted 6 kb genomes in 24 groups of 1-7, in a seeded order."""
    rng = np.random.default_rng(5)
    groups = [int(x) for x in rng.integers(1, 8, size=24)]
    groups[-1] += 90 - sum(groups)
    assert groups[-1] > 0
    paths = lib.write_genome_set(str(tmp_path_factory.mktemp("fed_planted")), groups, seed=7)
    return [paths[i] for i in rng.permutation(len(paths))]


@pytest.fixture(scope="module")
def builds(tmp_path_factory, planted):
    """Both packages' `build_federated` of the first 60 genomes at P = 2,
    3 and 5. Returns {(package, P): root}."""
    root = tmp_path_factory.mktemp("fed_builds")
    lo, hi = SCHEDULE[0]
    out = {}
    for p in (2, 3, 5):
        out[("jax", p)] = str(root / f"jax_p{p}")
        jax_build_federated(out[("jax", p)], planted[lo:hi], p, processes=1, **PLANTED)
        out[("torch", p)] = str(root / f"torch_p{p}")
        summary = build_federated(out[("torch", p)], planted[lo:hi], p, processes=1, device=CPU, **PLANTED)
        assert summary["generation"] == 0 and summary["n_genomes"] == hi - lo
    return out


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory, planted, builds):
    """Both packages through SCHEDULE on one federation at P = 3, the
    root after every step copied aside. Returns {(package, step): root}."""
    root = tmp_path_factory.mktemp("fed_lifecycle")
    out = {}
    for pkg in ("jax", "torch"):
        loc = _copy(builds[(pkg, LIFECYCLE_P)], str(root / pkg))
        out[(pkg, 0)] = builds[(pkg, LIFECYCLE_P)]
        for step in range(1, len(SCHEDULE)):
            lo, hi = SCHEDULE[step]
            if pkg == "jax":
                jax_index_update(loc, planted[lo:hi], processes=1)
            else:
                summary = index_update(loc, planted[lo:hi], processes=1, device=CPU)
                assert summary["admitted"] == hi - lo and summary["generation"] == step
                assert summary["partitions_failed"] == []
            out[(pkg, step)] = _copy(loc, str(root / f"{pkg}_step{step}"))
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, planted):
    """The port's from-scratch `dereplicate --streaming_primary` on the
    build's 60 genomes: (primary partition, secondary partition, winners
    keyed by member set)."""
    wd = str(tmp_path_factory.mktemp("fed_oracle"))
    lo, hi = SCHEDULE[0]
    wdb = dereplicate_wrapper(wd, planted[lo:hi], device=CPU, skip_plots=True, streaming_primary=True,
                              processes=1, length=0, MASH_sketch=256, streaming_block=128)
    cdb = pd.read_csv(os.path.join(wd, "data_tables", "Cdb.csv"))
    prim: dict[int, set] = {}
    sec: dict[str, set] = {}
    for g, p, s in zip(cdb["genome"], cdb["primary_cluster"], cdb["secondary_cluster"]):
        prim.setdefault(int(p), set()).add(g)
        sec.setdefault(str(s), set()).add(g)
    by = cdb.set_index("genome")["secondary_cluster"]
    winners = {frozenset(g for g in cdb["genome"] if by[g] == row.cluster): row.genome for row in wdb.itertuples()}
    return set(map(frozenset, prim.values())), set(map(frozenset, sec.values())), winners


# ---- 1. routing and the range-partition helpers ---------------------------


def test_partition_bounds_equal_jax():
    for p in (2, 3, 5, 7, 999):
        assert meta.partition_bounds(p) == jax_meta.partition_bounds(p)
    for p in (0, 1, 1000):
        with pytest.raises(UserInputError, match="--partitions must be in"):
            meta.partition_bounds(p)


def test_route_code_and_partition_equal_jax():
    rng = np.random.default_rng(0)
    rows = [np.sort(rng.integers(0, 2**64 - 1, size=int(rng.integers(0, 40)), dtype=np.uint64)) for _ in range(300)]
    rows += [np.array([0], np.uint64), np.array([2**64 - 1], np.uint64)]
    codes = [meta.route_code(r) for r in rows]
    assert codes == [jax_meta.route_code(r) for r in rows]
    for p in (2, 3, 5, 64):
        bounds = meta.partition_bounds(p)
        got = [meta.route_partition(c, bounds) for c in codes]
        assert got == [jax_meta.route_partition(c, bounds) for c in codes]
        assert set(got) <= set(range(p))


def test_rangepart_codes_equal_jax():
    rng = np.random.default_rng(1)
    rows = [np.sort(rng.integers(0, 2**64 - 1, size=int(rng.integers(0, 300)), dtype=np.uint64)) for _ in range(50)]
    got, want = rangepart.hash_code_matrix(rows), jax_rangepart.hash_code_matrix(rows)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for r in rows[:10]:
        assert np.array_equal(rangepart.coarse_codes(r), jax_rangepart.coarse_codes(r))
    got, want = rangepart.code_summary_bitmap(rows), jax_rangepart.code_summary_bitmap(rows)
    assert got.dtype == want.dtype == np.uint64 and np.array_equal(got, want)
    assert rangepart.HASH_CODE_SHIFT == jax_rangepart.HASH_CODE_SHIFT
    assert rangepart.ROUTE_SUMMARY_BITS == jax_rangepart.ROUTE_SUMMARY_BITS


# ---- 2. the build -------------------------------------------------------


@pytest.mark.parametrize("p", [2, 3, 5])
def test_build_federated_equals_jax(builds, p):
    """build_federated at P partitions: federation.json, every partition
    store and the cross/state/routing families equal the JAX package's."""
    assert_stores_match(builds[("torch", p)], builds[("jax", p)])
    m = _meta(builds[("torch", p)])
    assert m["n_partitions"] == p and m["generation"] == 0
    assert sum(e["n_genomes"] for e in m["partitions"]) == SCHEDULE[0][1]


@pytest.mark.parametrize("p", [2, 3, 5])
def test_build_federated_equals_from_scratch(builds, oracle, p):
    """The pinned invariant: the union's labels (up to renumbering) and
    winner sets equal the from-scratch streaming-primary dereplicate's."""
    idx = load_index(builds[("torch", p)])
    po, so, wo = oracle
    assert lib.primary_partition(idx) == po
    assert lib.secondary_partition(idx) == so
    assert lib.winners_by_members(idx) == wo
    assert len(po) > 10 and len(np.unique(idx.fed_part_of)) > 1


# ---- 3. updates -----------------------------------------------------------


@pytest.mark.parametrize("step", range(1, len(SCHEDULE)))
def test_lifecycle_equals_jax(lifecycle, step):
    """A 20-genome batch, then a K = 1 trickle: each step's federation
    equals the JAX package's."""
    assert_stores_match(lifecycle[("torch", step)], lifecycle[("jax", step)])
    idx = load_index(lifecycle[("torch", step)])
    assert idx.generation == step and idx.n == SCHEDULE[step][1]


@pytest.mark.parametrize("direction", ["jax_root_port_update", "port_root_jax_update"])
def test_update_across_packages(tmp_path, lifecycle, planted, direction):
    lo, hi = SCHEDULE[1]
    if direction == "jax_root_port_update":
        loc = _copy(lifecycle[("jax", 0)], str(tmp_path / "f"))
        index_update(loc, planted[lo:hi], processes=1, device=CPU)
        assert_stores_match(loc, lifecycle[("jax", 1)])
    else:
        loc = _copy(lifecycle[("torch", 0)], str(tmp_path / "f"))
        jax_index_update(loc, planted[lo:hi], processes=1)
        assert_stores_match(loc, lifecycle[("torch", 1)])


def test_fed_pods_equal_in_process(tmp_path, lifecycle, planted):
    """`fed_pods=2`: every dirty partition updated by a `python -m
    drep_tpu_torch index update --params_file ... --device cpu` pod; the
    federation equals the in-process update's, and no handoff is left."""
    lo, hi = SCHEDULE[1]
    loc = _copy(lifecycle[("torch", 0)], str(tmp_path / "f"))
    summary = index_update(loc, planted[lo:hi], processes=1, fed_pods=2, device=CPU)
    assert summary["partitions_failed"] == [] and summary["admitted"] == hi - lo
    assert set(fed_mod.STATS["pod_rcs"].values()) == {0} and len(fed_mod.STATS["pod_rcs"]) > 1
    assert_stores_match(loc, lifecycle[("torch", 1)], exact=True)
    assert not [f for f in os.listdir(os.path.join(loc, "log")) if f.startswith("handoff_")]


def test_params_handoff_round_trip(tmp_path, planted):
    """A handoff read back gives the batch, the sketches and the params
    it was written from (the JAX package reads the same file)."""
    from drep_tpu.index.federation import read_params_handoff as jax_read
    from drep_tpu_torch.index.store import empty_index
    from drep_tpu_torch.index.update import sketch_batch

    params = {"sketch_size": 256, "kmer_size": 21, "scale": 200, "hash": "splitmix64", "filter_length": 0}
    batch, results = sketch_batch(empty_index(params), planted[:4], processes=1)
    path = str(tmp_path / "h.npz")
    write_params_handoff(path, params, batch, results)
    for read in (read_params_handoff, jax_read):
        back = read(path)
        assert back["params"] == params
        pd.testing.assert_frame_equal(back["batch"], batch)
        for g in batch["genome"]:
            for k, v in results[g].items():
                assert np.array_equal(back["results"][g][k], v), (g, k)


def test_unreadable_partition_publishes_the_jax_partial_meta(tmp_path, lifecycle, planted):
    """A partition that cannot load (its sketch shard and state both
    gone): the update admits nothing and republishes the meta at the same
    generation stamped `partitions_unavailable`, as the JAX package does;
    a heal pass once the files are back clears the stamp."""
    lo, hi = SCHEDULE[1]
    loc = str(tmp_path / "f")
    lost = [os.path.join("part_001", "sketches", "sketch_g000000.npz"),
            os.path.join("part_001", "state", "state_g000000.npz")]
    got = {}
    for pkg in ("jax", "torch"):
        shutil.rmtree(loc, ignore_errors=True)
        _copy(lifecycle[("jax", 0)], loc)
        for rel in lost:
            os.replace(os.path.join(loc, rel), os.path.join(str(tmp_path), os.path.basename(rel)))
        if pkg == "jax":
            summary = jax_index_update(loc, planted[lo:hi], processes=1)
        else:
            summary = index_update(loc, planted[lo:hi], processes=1, device=CPU)
        with open(os.path.join(loc, "federation.json"), "rb") as f:
            got[pkg] = (summary, f.read())
        for rel in lost:
            os.replace(os.path.join(str(tmp_path), os.path.basename(rel)), os.path.join(loc, rel))
    assert got["torch"][0]["partitions_unavailable"] == [1] and got["torch"][0]["admitted"] == 0
    assert "double fault" in got["torch"][0]["partial"]["reason"]
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert _meta(loc)["generation"] == 0 and "partial" in _meta(loc)
    healed = index_update(loc, None, processes=1, device=CPU)
    assert healed["admitted"] == 0 and healed["generation"] == 0 and "partial" not in _meta(loc)


# ---- 4. classify ------------------------------------------------------------


def test_federated_classify_equals_jax(lifecycle, planted):
    """One-shot `index classify` on a federated root answers from the
    union as the JAX package does, and writes nothing under the root."""
    step = len(SCHEDULE) - 1
    loc, jloc = lifecycle[("torch", step)], lifecycle[("jax", step)]
    paths = planted[SCHEDULE[-1][1]:] + [planted[0]]
    before = lib.tree_digest(loc, exclude_dirs=())
    got = index_classify(loc, paths, processes=1, device=CPU)
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    want = jax_classify.index_classify(jloc, paths, processes=1)
    assert_verdicts_match(got, want)
    assert got[-1]["nearest_dist"] == 0.0 and got[-1]["generation"] == step


# ---- 5. heal ----------------------------------------------------------------


def _rot(path: str) -> None:
    with open(path, "r+b") as f:
        f.truncate(60)


@pytest.mark.parametrize("fault", ["partition_edges", "cross_shard", "union_state"])
def test_heal_equals_jax(tmp_path, lifecycle, fault):
    """A heal pass (`index update` with no genomes) on a federation with
    a torn partition edge shard, cross shard or union state repairs it
    to the store the JAX package heals it to, at the same generation."""
    src = lifecycle[("jax", 1)]
    rel = {"partition_edges": os.path.join("part_000", "edges", "edges_g000000.npz"),
           "cross_shard": os.path.join("cross", "cross_g000001.npz"),
           "union_state": os.path.join("state", "fedstate_g000001.npz")}[fault]
    loc, jloc = _copy(src, str(tmp_path / "t")), _copy(src, str(tmp_path / "j"))
    for d in (loc, jloc):
        _rot(os.path.join(d, rel))
    with pytest.raises(UserInputError):
        load_index(loc)  # the read-only load refuses the damage
    summary = index_update(loc, None, processes=1, device=CPU)
    jsummary = jax_index_update(jloc, None, processes=1)
    assert summary["generation"] == jsummary["generation"] == 1
    assert summary["healed"] == jsummary["healed"]
    # a rotted union state reclusters the union (as the JAX package's, it
    # is not listed among the healed files)
    assert bool(summary["healed"]) == (fault != "union_state")
    assert_stores_match(loc, jloc)
    assert_stores_match(loc, src)


# ---- 6. serving a federated root ------------------------------------------


def test_daemon_serves_a_federated_root(tmp_path, lifecycle, planted):
    """The daemon on a federated root loads the streaming resident (the
    spine, no sketch payload until a consult) and answers each query with
    the union-assembled classify verdict plus full coverage stamps; the
    generation poller's read runs; nothing under the root is written."""
    import threading

    from drep_tpu_torch.index import classify_batch, load_resident_index, sketch_queries
    from drep_tpu_torch.index.federation import FederatedResident
    from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig

    loc = lifecycle[("torch", 1)]
    before = lib.tree_digest(loc, exclude_dirs=())
    queries = planted[SCHEDULE[-1][1]:SCHEDULE[-1][1] + 3]
    union = load_resident_index(loc, streaming=False)
    assert union.n == SCHEDULE[1][1]
    want = classify_batch(union, sketch_queries(union, queries), joint=False, device=CPU)
    srv = IndexServer(ServeConfig(index_loc=loc, socket_path=str(tmp_path / "s.sock"), poll_generation_s=0.1,
                                  resident_mb=64, device=CPU))
    srv.start()
    loop = threading.Thread(target=srv.serve_batches, daemon=True)
    loop.start()
    try:
        assert isinstance(srv._resident, FederatedResident) and srv._resident.budget_bytes == 64 << 20
        assert srv.snapshot()["partitions"]["resident_partitions"] == 0
        with ServeClient(str(tmp_path / "s.sock"), timeout_s=300) as c:
            resps = c.classify_many(queries)
        time.sleep(0.3)  # a few generation polls
        assert srv.stats.swaps_total == 0
    finally:
        srv.request_drain()
        loop.join(timeout=60)
        srv.close()
    got = [r["verdict"] for r in resps]
    for v in got:
        assert v.pop("partitions_unavailable") == [] and v.pop("partitions_consulted")
    assert got == want
    assert meta.current_generation(loc) == 1 == jax_meta.current_generation(loc)
    assert lib.tree_digest(loc, exclude_dirs=()) == before
