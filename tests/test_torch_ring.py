"""The port's dense ring (plain ring step on the CPU) against the JAX
package's ring on its virtual CPU devices: the schedule helpers, one ring
step (tile and rotated operand), and the sharded Mash and containment
matrices at odd and even D, half and full grid.

The JAX side is held on its `ring_comm="ppermute"` ring, not the fused
interpret path. Shared and intersection counts are integers and compared
exactly; Mash distances come from a float32 log taken on the device in the
JAX ring and in numpy here, so they agree to the repo's atol=1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from drep_tpu.ops.containment import pack_scaled_sketches as jax_pack_scaled_sketches
from drep_tpu.ops.minhash import _pair_shared
from drep_tpu.ops.minhash import pack_sketches as jax_pack_sketches
from drep_tpu.parallel import allpairs as jring
from drep_tpu.parallel.mesh import AXIS
from drep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from drep_tpu_torch.cluster import engines
from drep_tpu_torch.ops import ring
from drep_tpu_torch.ops.containment import all_vs_all_containment_matmul, pack_scaled_sketches
from drep_tpu_torch.ops.mash import all_vs_all_mash, shared_counts_to_distance
from drep_tpu_torch.ops.minhash import PAD_ID, pack_sketches
from drep_tpu_torch.parallel import allpairs
from drep_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
K = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hermetic_ring_config():
    """The JAX package keeps run-wide ring flags; start every test from its
    defaults (a JAX d_cluster_wrapper elsewhere in the worker sets a block
    store base)."""
    jring.configure_ring()
    yield
    jring.configure_ring()


def _sketch_set(rng, n: int, s: int) -> list[np.ndarray]:
    """n sorted unique uint64 sketches of up to s hashes, sharing a random
    share of one pool (so pairs overlap from nothing to most), ragged."""
    base = np.unique(rng.integers(0, 2**62, size=6 * s * n, dtype=np.uint64))
    rng.shuffle(base)
    shared = base[:s]
    out = []
    for i in range(n):
        own = base[s * (i + 1) : s * (i + 2)]
        mix = int(s * rng.random() * 0.8)
        keep = s - int(rng.integers(0, s // 3)) if i % 3 else s
        out.append(np.sort(np.unique(np.concatenate([shared[:mix], own[: s - mix]]))[:keep]))
    return out


def _packs(kind: str, n: int, seed: int):
    """(port pack, JAX pack) of the same sketches; the id matrices agree."""
    rng = np.random.default_rng(seed)
    names = [f"g{i}" for i in range(n)]
    if kind == "mash":
        sk = _sketch_set(rng, n, 48)
        ours, theirs = pack_sketches(sk, names, 48), jax_pack_sketches(sk, names, 48)
    else:
        sk = _sketch_set(rng, n, 100)
        ours, theirs = pack_scaled_sketches(sk, names), jax_pack_scaled_sketches(sk, names)
    np.testing.assert_array_equal(ours.ids, theirs.ids)
    return ours, theirs


@pytest.mark.parametrize("d", range(1, 9))
def test_schedule_helpers_equal_jax(d):
    assert allpairs.half_ring_steps(d) == jring.half_ring_steps(d)
    for half in (True, False):
        assert allpairs.ring_tiles_computed(d, half) == jring.ring_tiles_computed(d, half)
        assert allpairs.ring_schedule(d, half) == jring.ring_schedule(d, half)
        assert len(allpairs.ring_schedule(d, half)) == allpairs.ring_tiles_computed(d, half)
    for a in range(d):
        for b in range(d):
            assert allpairs._ring_block_computed(a, b, d) == jring._ring_block_computed(a, b, d)
            assert allpairs.ring_step_of(a, b, d) == jring.ring_step_of(a, b, d)
    rng = np.random.default_rng(d)
    mat = rng.integers(0, 1000, size=(3 * d, 3 * d)).astype(np.float32)
    got, want = mat.copy(), mat.copy()
    allpairs.mirror_half_ring(got, d)
    jring.mirror_half_ring(want, d)
    np.testing.assert_array_equal(got, want)


def _step_inputs(kind: str, rng, d: int, n_local: int):
    """A and B operands for one ring step: A and B differ; containment rows
    carry in-row repeats in some rows (the ring's own definition counts each
    copy)."""
    width = 40
    rows = 2 * d * n_local
    ids = np.full((rows, width), PAD_ID, np.int32)
    counts = np.zeros(rows, np.int32)
    for r in range(rows):
        m = 0 if r % 5 == 4 else int(rng.integers(1, width + 1))
        if kind == "containment" and r % 2:
            row = np.sort(rng.integers(0, 90, size=m))
        else:
            row = np.sort(rng.choice(90, size=m, replace=False))
        ids[r, :m] = row
        counts[r] = m
    half = d * n_local
    return ids[:half], counts[:half], ids[half:], counts[half:]


@pytest.mark.parametrize("kind", ["mash", "containment"])
def test_ring_step_plain_equals_jax_step(kind):
    """One rotating step on a D = 3 mesh: the port's plain step per position
    against the JAX `_ring_step_fn(kind, k, mesh, rotate=True)`."""
    d, n_local = 3, 7
    a_ids, a_cnt, b_ids, b_cnt = _step_inputs(kind, np.random.default_rng(7), d, n_local)
    mesh = jax_make_mesh(d)
    rows, vec = NamedSharding(mesh, P(AXIS, None)), NamedSharding(mesh, P(AXIS))
    fn, _ = jring._ring_step_fn(kind, K, mesh, True)
    j_tile, j_ids, j_cnt = (
        np.asarray(x)
        for x in fn(jax.device_put(a_ids, rows), jax.device_put(a_cnt, vec),
                    jax.device_put(b_ids, rows), jax.device_put(b_cnt, vec))
    )
    dst = [(torch.empty((n_local, a_ids.shape[1]), dtype=torch.int32), torch.empty(n_local, dtype=torch.int32))
           for _ in range(d)]
    tiles = []
    for m in range(d):
        sl = slice(m * n_local, (m + 1) * n_local)
        op = [torch.from_numpy(x[sl].copy()) for x in (a_ids, a_cnt, b_ids, b_cnt)]
        tiles.append(ring.ring_step_plain(kind, *op, *dst[(m + 1) % d]).numpy())
    np.testing.assert_array_equal(np.concatenate([x.numpy() for x, _ in dst]), j_ids)
    np.testing.assert_array_equal(np.concatenate([c.numpy() for _, c in dst]), j_cnt)
    shared = np.concatenate(tiles)
    if kind == "containment":
        assert shared.astype(np.float32).tobytes() == j_tile.tobytes()
        return
    pair = jax.vmap(jax.vmap(lambda a, na, b, nb: _pair_shared(a, b, na, nb)[0],
                             in_axes=(None, None, 0, 0)), in_axes=(0, 0, None, None))
    width = a_ids.shape[1]
    for m in range(d):
        sl = slice(m * n_local, (m + 1) * n_local)
        want = np.asarray(pair(jnp.asarray(a_ids[sl]), jnp.asarray(a_cnt[sl]),
                               jnp.asarray(b_ids[sl]), jnp.asarray(b_cnt[sl])))
        np.testing.assert_array_equal(tiles[m], want)
        dist, _ = shared_counts_to_distance(tiles[m], a_cnt[sl], b_cnt[sl], width, K)
        np.testing.assert_allclose(dist, j_tile[sl], rtol=0, atol=1e-7)


def test_ring_step_wrapper_checks_operands():
    ids = torch.from_numpy(np.sort(np.random.default_rng(1).integers(0, 50, (6, 8)), axis=1).astype(np.int32))
    cnt = torch.full((6,), 8, dtype=torch.int32)
    dst = (torch.empty_like(ids), torch.empty_like(cnt))
    got = ring.ring_step("containment", ids, cnt, ids, cnt, *dst)
    assert torch.equal(got, ring.ring_step_plain("containment", ids, cnt, ids, cnt))
    assert torch.equal(dst[0], ids) and torch.equal(dst[1], cnt)
    assert ring.LAUNCHES["ring_step"] == 0  # the CPU runs the plain version
    with pytest.raises(ValueError, match="overlaps"):
        ring.ring_step("mash", ids, cnt, ids, cnt, ids, torch.empty_like(cnt))
    with pytest.raises(ValueError, match="kind"):
        ring.ring_step("jaccard", ids, cnt, ids, cnt)
    with pytest.raises(ValueError, match="both receive buffers"):
        ring.ring_step("mash", ids, cnt, ids, cnt, dst[0], None)
    with pytest.raises(TypeError, match="int32"):
        ring.ring_step("mash", ids.long(), cnt, ids, cnt)


_JAX_RINGS: dict = {}


def _jax_ring(kind: str, d: int, full_grid: bool, theirs):
    """The JAX ppermute ring's matrices, once per (kind, D, grid)."""
    key = (kind, d, full_grid)
    if key not in _JAX_RINGS:
        mesh = jax_make_mesh(d)
        if kind == "mash":
            _JAX_RINGS[key] = (jring.sharded_mash_allpairs(
                theirs, k=K, mesh=mesh, full_grid=full_grid, ring_comm="ppermute"),)
        else:
            _JAX_RINGS[key] = jring.sharded_containment_allpairs(
                theirs, k=K, mesh=mesh, full_grid=full_grid, ring_comm="ppermute")
    return _JAX_RINGS[key]


@pytest.mark.parametrize("full_grid", [False, True], ids=["half", "full"])
@pytest.mark.parametrize("d", [2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["mash", "containment"])
def test_sharded_allpairs_equal_jax_ring_and_single_device(kind, d, full_grid):
    """N = 22 genomes, a multiple of none of D = 3, 4, 5: the last block is
    padded."""
    ours, theirs = _packs(kind, 22, seed=3)
    mesh = make_mesh(d, CPU)
    want = _jax_ring(kind, d, full_grid, theirs)
    if kind == "mash":
        got = allpairs.sharded_mash_allpairs(ours, k=K, mesh=mesh, full_grid=full_grid)
        np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-7)
        single = all_vs_all_mash(ours, k=K, device=CPU)[0]
        assert got.tobytes() == single.tobytes()
    else:
        ani, cov = allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh, full_grid=full_grid)
        assert ani.tobytes() == want[0].tobytes() and cov.tobytes() == want[1].tobytes()
        single = all_vs_all_containment_matmul(ours, k=K, device=CPU)
        assert ani.tobytes() == single[0].tobytes() and cov.tobytes() == single[1].tobytes()


@pytest.mark.parametrize(
    "mesh_shape,n,size",
    [(None, 100, None), (1, 100, None), (4, 63, None), (4, 64, 4), (3, 200, 3)],
)
def test_mesh_or_none_takes_the_single_device_path_below_two_positions(mesh_shape, n, size):
    mesh = engines._mesh_or_none(mesh_shape, n, CPU)
    assert (mesh.size if mesh is not None else None) == size
    want = "ring_sort" if size else "sort"
    assert engines.resolve_primary_estimator(n, mesh_shape, "auto", CPU) == want


@pytest.mark.parametrize("cards,n,want", [(1, 4, [0, 0, 0, 0]), (2, 4, [0, 1, 0, 1]), (2, None, [0, 1]),
                                          (4, 3, [0, 1, 2])])
def test_make_mesh_deals_positions_over_the_cards(monkeypatch, cards, n, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: True)
    mesh = make_mesh(n, "cuda")
    assert [d.index for d in mesh.devices] == want and all(d.type == "cuda" for d in mesh.devices)


def test_make_mesh_refuses_cards_without_peer_access(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    with pytest.raises(RuntimeError, match="cannot access"):
        make_mesh(2, "cuda")
    assert make_mesh(None, CPU).size == 1 and make_mesh(5, "cpu").devices == (CPU,) * 5


@pytest.mark.parametrize("cards,no_peer,want", [
    (2, {(0, 1), (1, 0)}, [0]),  # no two cards reach each other: one position
    (4, {(3, 0)}, [0, 1, 2]),  # cuda:3 -> cuda:0 missing: the ring 0 -> 1 -> 2 -> 0
    (4, {(1, 2)}, [0, 1]),
    (4, set(), [0, 1, 2, 3]),
])
def test_default_mesh_spans_the_cards_with_peer_access(monkeypatch, cards, no_peer, want):
    """mesh_shape None never raises for missing peer access: it deals one
    position over each card of the widest peer-access ring from cuda:0 up,
    and the default run then takes the single-device path on one position."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: (a, b) not in no_peer)
    assert [d.index for d in make_mesh(None, "cuda").devices] == want
    cuda = torch.device("cuda")
    assert engines.resolve_primary_estimator(100, None, "auto", cuda) == ("ring_sort" if len(want) > 1 else "sort")
    if no_peer:
        with pytest.raises(RuntimeError, match="cannot access"):
            engines.resolve_primary_estimator(100, cards, "auto", cuda)
