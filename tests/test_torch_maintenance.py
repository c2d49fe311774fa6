"""The port's index maintenance verbs (drep_tpu_torch/index/maintenance.py:
compact_store, fed_split, fed_merge, fed_compact, roll_forward) against
the JAX package's, on the CPU.

Each verb starts from a store the JAX package wrote and moves no
distance (split and merge restrict the union edge graph, compaction
copies it), so the stores are compared exactly: the same file set, every
manifest and federation.json byte-equal, every npz payload array-equal.
Transactions the JAX package left interrupted at each of its kill points
(its fault sites, raised in process) are converged by the port's
roll_forward and rerun to the store the uninterrupted JAX verb writes.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402
from test_torch_index import assert_stores_match  # noqa: E402

from drep_tpu.errors import UserInputError as JaxUserInputError  # noqa: E402
from drep_tpu.index import build_federated as jax_build_federated  # noqa: E402
from drep_tpu.index import build_from_paths as jax_build_from_paths  # noqa: E402
from drep_tpu.index import compact_store as jax_compact_store  # noqa: E402
from drep_tpu.index import fed_compact as jax_fed_compact  # noqa: E402
from drep_tpu.index import fed_merge as jax_fed_merge  # noqa: E402
from drep_tpu.index import fed_split as jax_fed_split  # noqa: E402
from drep_tpu.index import index_update as jax_index_update  # noqa: E402
from drep_tpu.utils import faults  # noqa: E402
from drep_tpu_torch.errors import UserInputError  # noqa: E402
from drep_tpu_torch.index import (  # noqa: E402
    compact_store,
    fed_compact,
    fed_merge,
    fed_split,
    index_classify,
    index_update,
    load_index,
    roll_forward,
)
from drep_tpu_torch.index import maintenance as maint  # noqa: E402
from drep_tpu_torch.index import meta  # noqa: E402

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANTED = {"length": 0, "MASH_sketch": 256, "streaming_block": 128}


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


def _union(loc: str):
    idx = load_index(loc)
    return lib.primary_partition(idx), lib.secondary_partition(idx), lib.winners_by_members(idx)


def _without_generation(verdicts: list[dict]) -> list[dict]:
    return [{k: v for k, v in d.items() if k != "generation"} for d in verdicts]


@pytest.fixture(scope="module")
def planted(tmp_path_factory) -> list[str]:
    """56 planted 6 kb genomes in 16 groups of 1-6, in a seeded order; the
    last 6 are queries."""
    rng = np.random.default_rng(8)
    groups = [int(x) for x in rng.integers(1, 7, size=16)]
    groups[-1] += 56 - sum(groups)
    assert groups[-1] > 0
    paths = lib.write_genome_set(str(tmp_path_factory.mktemp("maint_planted")), groups, seed=9)
    return [paths[i] for i in rng.permutation(len(paths))]


@pytest.fixture(scope="module")
def plain(tmp_path_factory, planted) -> str:
    """A plain store of three generations, written by the JAX package."""
    loc = str(tmp_path_factory.mktemp("maint_plain") / "idx")
    jax_build_from_paths(loc, planted[:30], processes=1, **PLANTED)
    jax_index_update(loc, planted[30:40], processes=1)
    jax_index_update(loc, planted[40:45], processes=1)
    return loc


@pytest.fixture(scope="module")
def fed(tmp_path_factory, planted) -> str:
    """A three-partition federation with one update on top (so each
    partition a batch reached holds two generations), written by the JAX
    package."""
    loc = str(tmp_path_factory.mktemp("maint_fed") / "fed")
    jax_build_federated(loc, planted[:36], 3, processes=1, **PLANTED)
    jax_index_update(loc, planted[36:50], processes=1)
    return loc


def _splittable_pid(loc: str) -> int:
    """The partition with the most genomes (at least two range codes)."""
    m = _meta(loc)
    return max(m["partitions"], key=lambda e: e["n_genomes"])["pid"]


# ---- 1. the plain store's compaction ----------------------------------------


def test_compact_store_equals_jax(tmp_path, plain):
    """compact_store folds the three generations into one at generation
    3, as the JAX package's does; a second call only sweeps."""
    loc, jloc = _copy(plain, str(tmp_path / "t" / "idx")), _copy(plain, str(tmp_path / "j" / "idx"))
    summary = compact_store(loc, processes=1, device=CPU)
    jsummary = jax_compact_store(jloc, processes=1)
    assert summary == jsummary and summary["generation"] == 3 and summary["compacted"] == ["idx"]
    lib.assert_stores_equal(loc, jloc)
    assert sorted(os.listdir(os.path.join(loc, "edges"))) == ["edges_g000003.npz"]
    again = compact_store(loc, processes=1, device=CPU)
    assert again["compacted"] == [] and again["skipped"] == ["single-generation store"]
    lib.assert_stores_equal(loc, jloc)


@pytest.fixture(scope="module")
def compacted(tmp_path_factory, plain) -> str:
    loc = _copy(plain, str(tmp_path_factory.mktemp("maint_compacted") / "idx"))
    compact_store(loc, processes=1, device=CPU)
    return loc


def test_compacted_store_classifies_as_its_twin(compacted, plain, planted):
    """Classify on the compacted store gives the uncompacted twin's
    verdicts but for the generation stamp (one higher)."""
    queries = planted[50:] + [planted[3]]
    got = index_classify(compacted, queries, processes=1, device=CPU)
    want = index_classify(plain, queries, processes=1, device=CPU)
    assert _without_generation(got) == _without_generation(want)
    assert {v["generation"] for v in got} == {3} and {v["generation"] for v in want} == {2}


def test_compacted_store_updates_as_its_twin(tmp_path, compacted, plain, planted):
    """The same batch admitted to the compacted store and to its twin:
    the same union, edges, labels, scores and winners."""
    a, b = _copy(compacted, str(tmp_path / "a")), _copy(plain, str(tmp_path / "b"))
    for loc in (a, b):
        index_update(loc, planted[45:50], processes=1, device=CPU)
    ia, ib = load_index(a), load_index(b)
    # each batch's admitting generation, the last one's a generation higher
    assert ia.names == ib.names and np.array_equal(ia.admitted[:45], ib.admitted[:45])
    assert set(ia.admitted[45:]) == {4} and set(ib.admitted[45:]) == {3}
    # the same edge set (the compacted store holds it as one sorted shard)
    oa, ob = np.lexsort(ia.edges[1::-1]), np.lexsort(ib.edges[1::-1])
    for x, y in zip(ia.edges, ib.edges):
        assert np.array_equal(x[oa], y[ob])
    assert np.array_equal(ia.primary, ib.primary) and np.array_equal(ia.suffix, ib.suffix)
    assert np.array_equal(ia.score, ib.score) and ia.winners.equals(ib.winners)


# ---- 2. split, merge and compaction of a federation ------------------------


def test_fed_split_equals_jax(tmp_path, fed, planted):
    """fed_split bisects the largest partition as the JAX package's does;
    the union's partitions, winners and verdicts stay."""
    pid = _splittable_pid(fed)
    loc, jloc = _copy(fed, str(tmp_path / "t")), _copy(fed, str(tmp_path / "j"))
    before = _union(loc)
    queries = planted[50:]
    v_before = index_classify(loc, queries, processes=1, device=CPU)
    summary = fed_split(loc, pid, processes=1, device=CPU)
    jsummary = jax_fed_split(jloc, pid, processes=1)
    assert summary == jsummary and summary["n_partitions"] == 4 and summary["generation"] == 2
    lib.assert_stores_equal(loc, jloc)
    assert _union(loc) == before
    assert _without_generation(index_classify(loc, queries, processes=1, device=CPU)) == _without_generation(v_before)


def test_fed_merge_equals_jax(tmp_path, fed, planted):
    loc, jloc = _copy(fed, str(tmp_path / "t")), _copy(fed, str(tmp_path / "j"))
    before = _union(loc)
    queries = planted[50:]
    v_before = index_classify(loc, queries, processes=1, device=CPU)
    summary = fed_merge(loc, 0, 1, processes=1, device=CPU)
    jsummary = jax_fed_merge(jloc, 0, 1, processes=1)
    assert summary == jsummary and summary["n_partitions"] == 2
    lib.assert_stores_equal(loc, jloc)
    assert _union(loc) == before
    assert _without_generation(index_classify(loc, queries, processes=1, device=CPU)) == _without_generation(v_before)


@pytest.mark.parametrize("scope", ["pid", "threshold"])
def test_fed_compact_equals_jax(tmp_path, fed, planted, scope):
    """fed_compact of one partition (--pid) or of every partition past
    --min_generations 2: the JAX package's store, the union unchanged."""
    loc, jloc = _copy(fed, str(tmp_path / "t")), _copy(fed, str(tmp_path / "j"))
    kw = {"pid": _splittable_pid(fed)} if scope == "pid" else {"min_generations": 2}
    before = _union(loc)
    summary = fed_compact(loc, processes=1, device=CPU, **kw)
    jsummary = jax_fed_compact(jloc, processes=1, **kw)
    assert summary == jsummary and summary["compacted"] and summary["generation"] == 2
    lib.assert_stores_equal(loc, jloc)
    assert _union(loc) == before
    # the compacted partitions hold one generation: a rerun leaves them
    again = fed_compact(loc, processes=1, device=CPU, **kw)
    assert again["compacted"] == [] and again["generation"] == 2


@pytest.mark.parametrize("call", ["split_unknown", "merge_not_adjacent", "merge_same", "compact_unknown"])
def test_maintenance_refusals_equal_jax(fed, call):
    """The verbs refuse what the JAX package refuses, with its message,
    and write nothing."""
    port, jax = {
        "split_unknown": (lambda: fed_split(fed, 99, device=CPU), lambda: jax_fed_split(fed, 99)),
        "merge_not_adjacent": (lambda: fed_merge(fed, 0, 2, device=CPU), lambda: jax_fed_merge(fed, 0, 2)),
        "merge_same": (lambda: fed_merge(fed, 1, 1, device=CPU), lambda: jax_fed_merge(fed, 1, 1)),
        "compact_unknown": (lambda: fed_compact(fed, pid=99, device=CPU), lambda: jax_fed_compact(fed, pid=99)),
    }[call]
    before = lib.tree_digest(fed, exclude_dirs=())
    with pytest.raises(UserInputError) as got:
        port()
    with pytest.raises(JaxUserInputError) as want:
        jax()
    assert str(got.value) == str(want.value)
    assert lib.tree_digest(fed, exclude_dirs=()) == before


# ---- 3. roll_forward of the JAX package's interrupted transactions ---------


@pytest.mark.parametrize("skip", [0, 1, 2], ids=["staged", "precommit", "pregc"])
@pytest.mark.parametrize("verb", ["split", "compact"])
def test_roll_forward_converges_jax_interrupt(tmp_path, fed, verb, skip):
    """The JAX package's split (its partition_split site) or compaction
    (its compaction site) interrupted at each kill point; the port's
    roll_forward and a rerun of the verb converge to the store the
    uninterrupted JAX verb writes."""
    pid = _splittable_pid(fed)
    loc, control = _copy(fed, str(tmp_path / "t")), _copy(fed, str(tmp_path / "c"))
    if verb == "split":
        site, jax_run = "partition_split", lambda d: jax_fed_split(d, pid, processes=1)
        port_run = lambda: fed_split(loc, pid, processes=1, device=CPU)  # noqa: E731
    else:
        site, jax_run = "compaction", lambda d: jax_fed_compact(d, min_generations=2, processes=1)
        port_run = lambda: fed_compact(loc, min_generations=2, processes=1, device=CPU)  # noqa: E731
    jax_run(control)
    faults.configure(f"{site}:raise:1.0:skip={skip}")
    try:
        with pytest.raises(faults.InjectedFault):
            jax_run(loc)
    finally:
        faults.configure(None)
    assert os.path.exists(maint.maint_path(loc))
    # the verb rolls the transaction forward (or back) first, then reruns
    rerun = port_run()
    assert not os.path.exists(maint.maint_path(loc))
    if verb == "split" and skip < 2:
        assert rerun["generation"] == 2 and rerun["n_partitions"] == 4
    elif verb == "split":
        assert rerun == {"op": "split", "generation": 2, "already_committed": True, "parents": [pid]}
    else:
        assert rerun["compacted"] == [] and rerun["already_committed"] and rerun["generation"] == 2
    lib.assert_stores_equal(loc, control)
    assert roll_forward(loc, device=CPU) is None


def test_recordless_compaction_interrupt_adopted(tmp_path, fed):
    """A JAX compaction interrupted after its partition manifests
    published, its transaction record lost: the port's roll_forward
    adopts the partitions one generation ahead with unchanged genome
    counts and republishes the meta."""
    loc, control = _copy(fed, str(tmp_path / "t")), _copy(fed, str(tmp_path / "c"))
    jax_fed_compact(control, min_generations=2, processes=1)
    faults.configure("compaction:raise:1.0:skip=1")
    try:
        with pytest.raises(faults.InjectedFault):
            jax_fed_compact(loc, min_generations=2, processes=1)
    finally:
        faults.configure(None)
    os.remove(maint.maint_path(loc))
    rolled = roll_forward(loc, device=CPU)
    assert rolled and rolled["op"] == "compact" and rolled["rolled"] == "forward"
    assert meta.current_generation(loc) == 2
    lib.assert_stores_equal(loc, control)


# ---- 4. the CLI in a fresh interpreter -------------------------------------


def test_cli_lifecycle_subprocess_loads_no_jax_or_drep_tpu(tmp_path, planted):
    """`python -m drep_tpu_torch index build --partitions 3 ... --device
    cpu`, an update with two pods, then split, merge and compact, in a
    fresh interpreter: it imports nothing of JAX or drep_tpu, and the
    federation equals the JAX CLI's on the same argv."""
    from drep_tpu.controller import main as jax_main

    argv = [
        ["build", "{loc}", "--partitions", "3", "-g", *planted[:30], "-l", "0", "-ms", "256",
         "--streaming_block", "128"],
        ["update", "{loc}", "-g", *planted[30:40], "--fed_pods", "2"],
        ["split", "{loc}", "--pid", "{pid}"],
        ["merge", "{loc}", "--pids", "0", "1"],
        ["compact", "{loc}", "--min_generations", "2"],
    ]
    loc, jloc = str(tmp_path / "t"), str(tmp_path / "j")

    def fill(args, where):
        pid = _splittable_pid(where) if os.path.exists(os.path.join(where, "federation.json")) else -1
        return [a.format(loc=where, pid=pid) for a in args]

    code = (
        "import json, os, sys\n"
        "from drep_tpu_torch.controller import main\n"
        f"loc, steps = {loc!r}, {argv!r}\n"
        "for args in steps:\n"
        "    pid = -1\n"
        "    if os.path.exists(os.path.join(loc, 'federation.json')):\n"
        "        parts = json.load(open(os.path.join(loc, 'federation.json')))['partitions']\n"
        "        pid = max(parts, key=lambda e: e['n_genomes'])['pid']\n"
        "    main(['index', *[a.format(loc=loc, pid=pid) for a in args], '-p', '1', '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'drep_tpu'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "LOADED []" in res.stdout
    for args in argv:
        jax_main(["index", *fill(args, jloc), "-p", "1"])
    assert_stores_match(loc, jloc)
    m = _meta(loc)
    assert m["n_partitions"] == 3 and m["generation"] >= 3 and "partial" not in m
    assert not os.path.exists(maint.maint_path(loc))
