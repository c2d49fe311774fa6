"""The port's genome index (drep_tpu_torch/index) against the JAX
package's drep_tpu/index on the same FASTAs, on the CPU.

Stores are compared payload by payload (npz zip timestamps differ): the
same file set, manifest.json byte-equal, every npz member array-equal.
One member is held to a tolerance, the `dist` of an edge shard that the
two packages computed each with its own Mash walk (with the shard's
`__crc__`, which covers it): the JAX package takes the float32 log on
its CPU device and the port in numpy, so a distance may differ in its
last float32 bit. They are held at rtol=1e-6, the tolerance
tests/test_torch_streaming.py holds the same walks' edges to, and their
(ii, jj) must be equal. Where both stores take their edges from one
source (one workdir's Mdb, shards the other package wrote), the payloads
are equal outright. Verdicts are compared field by field the same way:
`nearest_dist` (that edge's distance) at rtol=1e-6, everything else
equal, float64 scores exactly.

The planted sets stay below 512 genomes, where the JAX package's CPU
`auto` estimator is still the sort estimator, and use --streaming_block
128 at sketch widths up to 1024, where both packages' block rules give
the same stripes (so their pending stores resume across the packages).
"""

import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402

from drep_tpu.errors import UserInputError as JaxUserInputError  # noqa: E402
from drep_tpu.index import build_from_paths as jax_build_from_paths  # noqa: E402
from drep_tpu.index import build_from_workdir as jax_build_from_workdir  # noqa: E402
from drep_tpu.index import classify as jax_classify  # noqa: E402
from drep_tpu.index import index_update as jax_index_update  # noqa: E402
from drep_tpu.index import update as jax_update  # noqa: E402
from drep_tpu.workflows import compare_wrapper as jax_compare  # noqa: E402
from drep_tpu_torch.errors import UserInputError  # noqa: E402
from drep_tpu_torch.index import (  # noqa: E402
    build_from_paths,
    build_from_workdir,
    classify_batch,
    index_classify,
    index_update,
    load_index,
    load_resident_index,
    sketch_queries,
)
from drep_tpu_torch.index import update as update_mod  # noqa: E402
from drep_tpu_torch.parallel import streaming  # noqa: E402
from drep_tpu_torch.utils.logger import get_logger  # noqa: E402
from drep_tpu_torch.workflows import compare_wrapper, dereplicate_wrapper  # noqa: E402

CPU = "cpu"
# the planted sets' index parameters (bootstrap builds)
PLANTED = {"length": 0, "MASH_sketch": 256, "streaming_block": 128}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- comparisons -------------------------------------------------------


def _files(root: str) -> set[str]:
    out = set()
    for dirpath, dirs, fs in os.walk(root):
        dirs[:] = [d for d in dirs if d != "log"]
        out |= {os.path.relpath(os.path.join(dirpath, f), root) for f in fs}
    return out


def _walk_family(rel: str) -> bool:
    """An edge shard of a store (a federation partition's too) or a
    federation's cross shard: a payload of Mash distances."""
    parts = rel.split(os.sep)
    return len(parts) >= 2 and parts[-2] in ("edges", "cross")


def assert_stores_match(got: str, want: str, exact: bool = False) -> None:
    """`got` == `want` payload by payload (a plain store, or a federation:
    federation.json, its partitions, cross/, state/ and routing/); an
    edge or cross shard's dist (and its __crc__) at rtol=1e-6 unless
    `exact` (module docstring)."""
    assert _files(got) == _files(want)
    for rel in sorted(_files(got)):
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".json"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files), rel
            loose = () if exact or not _walk_family(rel) else ("dist", "__crc__")
            for k in za.files:
                if k not in loose:
                    assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), (rel, k)
            if "dist" in loose:
                assert za["dist"].dtype == zb["dist"].dtype == np.float32
                np.testing.assert_allclose(za["dist"], zb["dist"], rtol=1e-6, err_msg=rel)


def assert_verdicts_match(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "nearest_dist" and g[k] is not None and w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
            else:
                assert g[k] == w[k], (k, g, w)


def _copy(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst


# ---- genome sets -------------------------------------------------------


@pytest.fixture(scope="module")
def planted(tmp_path_factory) -> list[str]:
    """200 planted 6 kb genomes in 36 groups of 1-9 (members ~1% point
    mutations of their group's base), in a seeded random order."""
    rng = np.random.default_rng(11)
    groups = [int(x) for x in rng.integers(1, 10, size=36)]
    groups[-1] += 200 - sum(groups)
    assert groups[-1] > 0
    paths = lib.write_genome_set(str(tmp_path_factory.mktemp("planted")), groups, seed=3)
    return [paths[i] for i in rng.permutation(len(paths))]


# the planted schedule: a build, then updates of 60 genomes, a K = 1
# trickle, and an LSH-pruned batch; the last 10 genomes are classify queries
SCHEDULE = [(0, 120), (120, 180), (180, 181), (181, 190)]
PRUNED_STEP = 3


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory, planted):
    """Both packages through SCHEDULE on one store each; the store after
    every step is copied aside. Returns {(package, step): store dir}."""
    root = tmp_path_factory.mktemp("lifecycle")
    out = {}
    for pkg in ("jax", "torch"):
        loc = str(root / pkg)
        for step, (lo, hi) in enumerate(SCHEDULE):
            batch = planted[lo:hi]
            prune = {"primary_prune": "lsh"} if step == PRUNED_STEP else {}
            if pkg == "jax":
                if step == 0:
                    jax_build_from_paths(loc, batch, processes=1, **PLANTED)
                else:
                    jax_index_update(loc, batch, processes=1, **prune)
            elif step == 0:
                build_from_paths(loc, batch, processes=1, device=CPU, **PLANTED)
            else:
                summary = index_update(loc, batch, processes=1, device=CPU, **prune)
                assert summary["admitted"] == hi - lo and summary["generation"] == step
                if step == PRUNED_STEP:
                    assert summary["primary_prune"] == "lsh"
            out[(pkg, step)] = _copy(loc, str(root / f"{pkg}_step{step}"))
    return out


# ---- 1. build ----------------------------------------------------------


def test_build_from_paths_fixture_equals_jax(tmp_path, genome_paths):
    jax_build_from_paths(str(tmp_path / "j"), genome_paths, processes=1)
    summary = build_from_paths(str(tmp_path / "t"), genome_paths, processes=1, device=CPU)
    assert summary["n_genomes"] == 5 and summary["primary_clusters"] == 2
    assert summary["secondary_clusters"] == 3
    assert_stores_match(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("step", range(len(SCHEDULE)))
def test_planted_lifecycle_store_equals_jax(lifecycle, step):
    """The bootstrap build, a 60-genome update, a K = 1 trickle and an
    LSH-pruned update: each step's store equals the JAX package's."""
    assert_stores_match(lifecycle[("torch", step)], lifecycle[("jax", step)])
    idx = load_index(lifecycle[("torch", step)])
    assert idx.generation == step and idx.n == SCHEDULE[step][1]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_build_from_workdir_equals_jax(tmp_path, genome_paths, writer):
    """Both packages snapshot one streaming-primary workdir (written by
    either package): the stores are equal outright, edges included (the
    Mdb's float32 distances round-trip through the CSV exactly)."""
    wd = str(tmp_path / "wd")
    if writer == "torch":
        compare_wrapper(wd, genome_paths, device=CPU, skip_plots=True, streaming_primary=True, processes=1)
    else:
        jax_compare(wd, genome_paths, skip_plots=True, streaming_primary=True, processes=1)
    jax_build_from_workdir(str(tmp_path / "j"), wd)
    summary = build_from_workdir(str(tmp_path / "t"), wd)
    assert summary == {"n_genomes": 5, "generation": 0, "primary_clusters": 2, "secondary_clusters": 3}
    assert_stores_match(str(tmp_path / "t"), str(tmp_path / "j"), exact=True)
    cdb = pd.read_csv(os.path.join(wd, "data_tables", "Cdb.csv")).set_index("genome")
    idx = load_index(str(tmp_path / "t"))
    assert list(idx.secondary_names()) == list(cdb.loc[idx.names, "secondary_cluster"])


def test_build_from_workdir_warns_on_a_dense_estimator(tmp_path, genome_paths):
    """A source run whose estimator resolved to the dense `sort` warns,
    as the JAX package does, and still snapshots."""
    wd = str(tmp_path / "wd")
    compare_wrapper(wd, genome_paths, device=CPU, skip_plots=True, processes=1)
    records = []

    class Keep(__import__("logging").Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    get_logger().addHandler(handler)
    try:
        build_from_workdir(str(tmp_path / "t"), wd)
    finally:
        get_logger().removeHandler(handler)
    assert any("resolved to 'sort'" in m and "streaming sort" in m for m in records), records


# ---- 2-3. updates, across the packages ---------------------------------


@pytest.mark.parametrize("direction", ["jax_store_port_update", "port_store_jax_update"])
def test_update_across_packages(tmp_path, lifecycle, planted, direction):
    """A store built by one package, updated by the other, equals the
    store its own package's update published."""
    lo, hi = SCHEDULE[1]
    if direction == "jax_store_port_update":
        loc = _copy(lifecycle[("jax", 0)], str(tmp_path / "s"))
        index_update(loc, planted[lo:hi], processes=1, device=CPU)
        assert_stores_match(loc, lifecycle[("jax", 1)])
        # the generation-0 shards the JAX package wrote stay as they were
        for rel in ("edges/edges_g000000.npz", "sketches/sketch_g000000.npz"):
            assert lib.npz_payloads_equal(os.path.join(loc, rel), os.path.join(lifecycle[("jax", 0)], rel))
    else:
        loc = _copy(lifecycle[("torch", 0)], str(tmp_path / "s"))
        jax_index_update(loc, planted[lo:hi], processes=1)
        assert_stores_match(loc, lifecycle[("torch", 1)])


# ---- 4. the pinned invariant ------------------------------------------


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, planted):
    """The port's from-scratch `dereplicate --streaming_primary` on the
    first 190 planted genomes: (primary partition, secondary partition,
    winners keyed by member set)."""
    wd = str(tmp_path_factory.mktemp("oracle_wd"))
    wdb = dereplicate_wrapper(wd, planted[:190], device=CPU, skip_plots=True, streaming_primary=True,
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


@pytest.mark.parametrize("seed", [0, 1])
def test_incremental_equals_from_scratch(tmp_path, planted, oracle, seed):
    """Build + updates over randomized splits of 190 planted genomes give
    the labels (up to renumbering) and winners of the port's from-scratch
    streaming-primary dereplicate on the union."""
    rng = np.random.default_rng(seed)
    order = [planted[i] for i in rng.permutation(190)]
    cuts = sorted(rng.choice(np.arange(20, 189), size=3, replace=False).tolist()) + [190]
    loc = str(tmp_path / "idx")
    build_from_paths(loc, order[: cuts[0]], processes=1, device=CPU, **PLANTED)
    index_update(loc, [order[cuts[1] - 1]], processes=1, device=CPU)  # a K = 1 trickle
    rest = order[cuts[0] : cuts[1] - 1] + order[cuts[1] :]
    for lo, hi in ((0, len(rest) // 2), (len(rest) // 2, len(rest))):
        index_update(loc, rest[lo:hi], processes=1, device=CPU)
    idx = load_index(loc)
    po, so, wo = oracle
    assert lib.primary_partition(idx) == po
    assert lib.secondary_partition(idx) == so
    assert lib.winners_by_members(idx) == wo
    assert len(po) > 20 and len(so) > len(po) // 2


# ---- 5. classify ------------------------------------------------------


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("k", [3, 10])
def test_classify_batch_equals_jax(lifecycle, planted, joint, k):
    """classify_batch from one resident load, both joint modes, K = 3 (the
    JAX package pads it to 4) and 10: the verdicts equal the JAX
    package's, and the index tree's digest is unchanged."""
    loc = lifecycle[("torch", len(SCHEDULE) - 1)]
    jloc = lifecycle[("jax", len(SCHEDULE) - 1)]
    # planted queries beyond the index, and indexed genomes' own FASTAs
    paths = planted[190 : 190 + k - 2] + [planted[0], planted[150]]
    before = lib.tree_digest(loc, exclude_dirs=())
    resident = load_resident_index(loc)
    queries = sketch_queries(resident, paths, processes=1)
    got = classify_batch(resident, queries, processes=1, joint=joint, device=CPU)
    jres = jax_classify.load_resident_index(jloc, streaming=False)
    want = jax_classify.classify_batch(jres, jax_classify.sketch_queries(jres, paths, processes=1),
                                       processes=1, joint=joint)
    assert_verdicts_match(got, want)
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    assert [v["genome"] for v in got] == [os.path.basename(p) for p in paths]
    assert not got[-1]["novel_primary"] and got[-1]["nearest_dist"] == 0.0
    # the resident index is untouched: a second batch answers the same
    again = classify_batch(resident, queries, processes=1, joint=joint, device=CPU)
    assert again == got


def test_index_classify_equals_jax_and_writes_nothing(tmp_path, genome_paths):
    """The one-shot classify (load + sketch + one joint batch) on the
    fixture index, an indexed genome and a filtered query among them."""
    loc, jloc = str(tmp_path / "t"), str(tmp_path / "j")
    build_from_paths(loc, genome_paths[:3], processes=1, device=CPU)
    jax_build_from_paths(jloc, genome_paths[:3], processes=1)
    short = lib.write_genome_set(str(tmp_path / "q"), [1], seed=4, prefix="q")
    queries = genome_paths[3:] + genome_paths[:1] + short
    before = lib.tree_digest(loc, exclude_dirs=())
    got = index_classify(loc, queries, processes=1, device=CPU)
    assert lib.tree_digest(loc, exclude_dirs=()) == before
    want = jax_classify.index_classify(jloc, queries, processes=1)
    assert_verdicts_match(got, want)
    assert got[-1]["filtered"] and got[0]["secondary_cluster"] != got[2]["secondary_cluster"]
    pruned = index_classify(loc, queries, processes=1, device=CPU, primary_prune="lsh")
    assert pruned == got


# ---- 6. the heal matrix -----------------------------------------------


def _damage(loc: str, fault: str) -> None:
    if fault in ("edge_corrupt", "double"):
        path = os.path.join(loc, "edges", "edges_g000000.npz")
        with open(path, "r+b") as f:
            f.truncate(60)
    if fault in ("sketch_missing", "double"):
        os.remove(os.path.join(loc, "sketches", "sketch_g000001.npz"))
    if fault in ("state_rot", "double"):
        path = os.path.join(loc, "state", "state_g000001.npz")
        mid = os.path.getsize(path) // 2
        with open(path, "r+b") as f:
            f.seek(mid)
            byte = f.read(1)
            f.seek(mid)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.fixture(scope="module")
def fixture_store(tmp_path_factory, genome_paths):
    """A two-generation fixture store written by the JAX package."""
    loc = str(tmp_path_factory.mktemp("heal") / "idx")
    jax_build_from_paths(loc, genome_paths[:3], processes=1)
    jax_index_update(loc, genome_paths[3:], processes=1)
    return loc


@pytest.mark.parametrize("fault", ["edge_corrupt", "sketch_missing", "state_rot"])
def test_heal_equals_jax(tmp_path, fixture_store, fault):
    """A heal pass (`index update` with no genomes) repairs each fault to
    the store the JAX package heals it to, without a generation bump."""
    loc = _copy(fixture_store, str(tmp_path / "t"))
    jloc = _copy(fixture_store, str(tmp_path / "j"))
    for d in (loc, jloc):
        _damage(d, fault)
    with pytest.raises(UserInputError):
        load_index(loc)  # classify's read-only load refuses the damage
    summary = index_update(loc, None, processes=1, device=CPU)
    jsummary = jax_index_update(jloc, None, processes=1)
    assert summary["generation"] == jsummary["generation"] == 1
    assert summary["healed"] == jsummary["healed"]
    assert_stores_match(loc, jloc)
    assert_stores_match(loc, fixture_store)


def test_double_fault_refuses(tmp_path, fixture_store):
    loc = _copy(fixture_store, str(tmp_path / "t"))
    _damage(loc, "double")
    with pytest.raises(UserInputError, match="double fault"):
        index_update(loc, None, processes=1, device=CPU)
    jloc = _copy(fixture_store, str(tmp_path / "j"))
    _damage(jloc, "double")
    with pytest.raises(JaxUserInputError, match="double fault"):
        jax_index_update(jloc, None, processes=1)


# ---- 7. the pending checkpoint ----------------------------------------


def test_update_resumes_jax_pending_shards(tmp_path, lifecycle, planted, monkeypatch):
    """The JAX package's update is killed after its rectangle: its pending
    store holds every stripe's shard; half are deleted. The port's update
    of the same batch resumes the other half from them and publishes the
    uninterrupted store."""
    lo, hi = SCHEDULE[1]
    loc = _copy(lifecycle[("jax", 0)], str(tmp_path / "s"))

    def killed(*a, **k):
        raise KeyboardInterrupt("killed before the publish")

    monkeypatch.setattr(jax_update, "publish_generation", killed)
    with pytest.raises(KeyboardInterrupt):
        jax_index_update(loc, planted[lo:hi], processes=1)
    monkeypatch.undo()
    pending = os.path.join(loc, "pending", "g000001")
    shards = sorted(f for f in os.listdir(pending) if f.startswith("row_"))
    assert len(shards) == 2
    os.remove(os.path.join(pending, shards[0]))
    index_update(loc, planted[lo:hi], processes=1, device=CPU)
    assert streaming.STATS["stripes_resumed"] == 1 and streaming.STATS["launches"] == 1
    assert update_mod.STATS["rect_stripes_resumed"] == 1
    assert_stores_match(loc, lifecycle[("jax", 1)])
    assert not os.path.exists(os.path.join(loc, "pending"))


# ---- 8. refusals ------------------------------------------------------


def test_federated_root_and_arguments_refuse(tmp_path, genome_paths, monkeypatch):
    """A federated root loads, updates and classifies as the union, and
    loads as the streaming resident by default (read-only); what refuses
    there is a partition pod's --params_file (the JAX package's
    UserInputError).
    On a plain root --fed_pods is ignored and a --params_file handoff
    materializes a missing store's generation 0; a build over an
    existing index raises the JAX package's UserInputError."""
    from drep_tpu_torch.index import build_federated, read_params_handoff, write_params_handoff
    from drep_tpu_torch.index.store import empty_index
    from drep_tpu_torch.index.update import sketch_batch

    fed = str(tmp_path / "fed")
    build_federated(fed, genome_paths[:3], 2, processes=1, device=CPU)
    before = lib.tree_digest(fed, exclude_dirs=())
    from drep_tpu_torch.index.federation import FederatedResident

    streaming = load_resident_index(fed, device=CPU)
    assert isinstance(streaming, FederatedResident) and streaming.n == 3
    assert lib.tree_digest(fed, exclude_dirs=()) == before
    union = load_resident_index(fed, streaming=False)
    assert union.n == 3 and load_index(fed, heal=True).n == 3
    assert index_classify(fed, genome_paths[:1], processes=1, device=CPU)[0]["nearest_dist"] == 0.0
    with pytest.raises(UserInputError, match="FEDERATED"):
        build_from_paths(fed, genome_paths, device=CPU)
    with pytest.raises(UserInputError, match="targets ONE partition store"):
        index_update(fed, genome_paths[3:], device=CPU, params_file="handoff.npz")
    summary = index_update(fed, genome_paths[3:], processes=1, device=CPU)
    assert summary["generation"] == 1 and summary["n_genomes"] == 5
    # a plain root: the handoff materializes generation 0; fed_pods is ignored
    idx = load_index(fed)
    handoff = str(tmp_path / "handoff.npz")
    batch, results = sketch_batch(empty_index(idx.params), genome_paths[:2], processes=1)
    write_params_handoff(handoff, idx.params, batch, results)
    plain = str(tmp_path / "plain")
    summary = index_update(plain, None, processes=1, device=CPU, params_file=handoff)
    assert summary["generation"] == 0 and summary["n_genomes"] == 2
    assert read_params_handoff(handoff)["params"] == load_index(plain).params
    summary = index_update(plain, genome_paths[2:3], processes=1, device=CPU, fed_pods=2)
    assert summary["generation"] == 1 and summary["n_genomes"] == 3
    with pytest.raises(UserInputError, match="build refuses to overwrite"):
        build_from_paths(plain, genome_paths[1:2], processes=1, device=CPU)


def test_entry_points_refuse_cpu_without_being_asked(tmp_path, genome_paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_from_paths(str(tmp_path / "i"), genome_paths)
    assert not os.path.exists(tmp_path / "i")


def test_secondary_for_cluster_rows_equal_from_scratch(tmp_path, genome_paths):
    """secondary_for_cluster's Ndb rows and labels for each primary
    cluster equal those of a from-scratch d_cluster_wrapper run (which
    batches the clusters into one one-shot call): the Ndb written from
    them is byte-identical."""
    from drep_tpu_torch import schemas
    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.ingest import make_bdb, sketch_genomes
    from drep_tpu_torch.workdir import WorkDirectory

    wd = WorkDirectory(str(tmp_path / "wd"))
    bdb = make_bdb(genome_paths)
    cdb = controller.d_cluster_wrapper(wd, bdb, device=CPU, processes=1)
    gs = sketch_genomes(bdb, wd=wd)
    kw = {**controller.CLUSTER_DEFAULTS, "device": torch.device(CPU)}
    parts = []
    for pc in sorted(set(cdb["primary_cluster"])):
        members = [i for i, p in enumerate(cdb["primary_cluster"]) if p == pc]
        if len(members) < 2:
            continue
        rows, labels, _ = controller.secondary_for_cluster(gs, bdb, members, pc, kw)
        parts.append(rows)
        assert [f"{pc}_{int(lab)}" for lab in labels] == list(cdb["secondary_cluster"].iloc[members])
    again = WorkDirectory(str(tmp_path / "again"))
    again.store_db(schemas.validate(pd.concat(parts, ignore_index=True), "Ndb"), "Ndb")
    table = os.path.join("data_tables", "Ndb.csv")
    with open(os.path.join(wd.location, table), "rb") as f, open(os.path.join(again.location, table), "rb") as g:
        assert f.read() == g.read()
