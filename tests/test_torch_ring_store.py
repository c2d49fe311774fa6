"""The dense ring's block store (drep_tpu_torch/parallel/allpairs.py)
against the JAX package's step-wise ring on its virtual CPU devices.

A store written by either package resumes in the other with no block
recomputed, and the matrices come out bit for bit the writer's; a block
deleted from the store, or torn, is recomputed by the port's
TileExecutor bit-identically; a failed step falls back to per-block
recovery with the same matrices; the store's names and meta are the JAX
package's. The streaming primary's stripe shards, epoch-stamped as a
degraded pod leaves them, resume across the packages too. Mash distances
agree with the single-device matrix bit for bit in the port (both take
numpy's float32 log); the JAX ring's come from its own log and agree to
the repo's atol=1e-7, so a store carries its writer's values.
"""

import glob
import os

import numpy as np
import pytest
import torch

from drep_tpu.ops.containment import pack_scaled_sketches as jax_pack_scaled_sketches
from drep_tpu.ops.minhash import pack_sketches as jax_pack_sketches
from drep_tpu.parallel import allpairs as jring
from drep_tpu.parallel import streaming as jax_streaming
from drep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from drep_tpu_torch.ops import ring
from drep_tpu_torch.ops.containment import pack_scaled_sketches
from drep_tpu_torch.ops.mash import all_vs_all_mash
from drep_tpu_torch.ops.minhash import pack_sketches
from drep_tpu_torch.parallel import allpairs, streaming
from drep_tpu_torch.parallel.mesh import make_mesh
from drep_tpu_torch.utils import faults
from drep_tpu_torch.utils.profiling import counters

CPU = torch.device("cpu")
K = 21
D = 4


@pytest.fixture(autouse=True)
def _hermetic():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jring.configure_ring()
    allpairs.configure_ring()
    faults.configure(None)
    counters.reset()
    yield
    torch.set_num_threads(n)
    jring.configure_ring()
    allpairs.configure_ring()
    faults.configure(None)
    counters.reset()


def _packs(kind: str, n: int = 26, seed: int = 5):
    """(port pack, JAX pack) of the same seeded sketches."""
    rng = np.random.default_rng(seed)
    s = 48 if kind == "mash" else 100
    base = np.unique(rng.integers(0, 2**62, size=6 * s * n, dtype=np.uint64))
    rng.shuffle(base)
    shared = base[:s]
    sk = []
    for i in range(n):
        mix = int(s * rng.random() * 0.8)
        own = base[s * (i + 1) : s * (i + 2)]
        sk.append(np.sort(np.unique(np.concatenate([shared[:mix], own[: s - mix]])))[: s - (i % 4)])
    names = [f"g{i}" for i in range(n)]
    if kind == "mash":
        return pack_sketches(sk, names, s), jax_pack_sketches(sk, names, s)
    return pack_scaled_sketches(sk, names), jax_pack_scaled_sketches(sk, names)


def _launches(monkeypatch) -> list[int]:
    calls = [0]
    for name in ("ring_step_plain", "ring_step_matmul_plain"):
        fn = getattr(ring, name)

        def counted(*a, _fn=fn, **k):
            calls[0] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ring, name, counted)
    return calls


def _port(kind, pack, store):
    mesh = make_mesh(D, CPU)
    if kind == "mash":
        return (allpairs.sharded_mash_allpairs(pack, k=K, mesh=mesh, checkpoint_dir=store),)
    return allpairs.sharded_containment_allpairs(pack, k=K, mesh=mesh, checkpoint_dir=store)


def _jax(kind, pack, store):
    mesh = jax_make_mesh(D)
    if kind == "mash":
        return (jring.sharded_mash_allpairs(pack, k=K, mesh=mesh, checkpoint_dir=store, ring_comm="ppermute"),)
    return jring.sharded_containment_allpairs(pack, k=K, mesh=mesh, checkpoint_dir=store, ring_comm="ppermute")


def _blocks(store) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(store, "blk_*.npz"))):
        with np.load(p) as z:
            out[os.path.basename(p)] = z["o0"].copy()
    return out


def _same(a, b) -> bool:
    return all(x.tobytes() == y.tobytes() for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("kind", ["mash", "containment"])
def test_jax_store_resumes_in_port(tmp_path, monkeypatch, kind):
    ours, theirs = _packs(kind)
    store = str(tmp_path / "store")
    want = _jax(kind, theirs, store)
    names = sorted(os.listdir(store))
    calls = _launches(monkeypatch)
    got = _port(kind, ours, store)
    assert calls[0] == 0  # no block recomputed
    assert _same(got, want)
    assert sorted(os.listdir(store)) == names
    if kind == "mash":
        single = all_vs_all_mash(ours, k=K, device=CPU)[0]
        np.testing.assert_allclose(got[0], single, rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["mash", "containment"])
def test_port_store_resumes_in_jax(tmp_path, monkeypatch, kind):
    ours, theirs = _packs(kind)
    store = str(tmp_path / "store")
    got = _port(kind, ours, store)
    blocks = _blocks(store)
    assert sorted(blocks) == sorted(f"blk_{a:03d}_{b:03d}.npz" for a, b in allpairs.ring_schedule(D, True))

    def refuse(*a, **k):
        raise AssertionError("the JAX ring recomputed a block of a full store")

    monkeypatch.setattr(jring, "_block_tile_fn", lambda kind, k: (refuse, 1))
    monkeypatch.setattr(jring, "_ring_step_fn", refuse)
    want = _jax(kind, theirs, store)
    assert _same(want, got)
    if kind == "mash":
        single = all_vs_all_mash(ours, k=K, device=CPU)[0]
        assert got[0].tobytes() == single.tobytes()


@pytest.mark.parametrize("how", ["deleted", "torn"])
def test_missing_block_recomputed_bit_identically(tmp_path, monkeypatch, how):
    ours, _ = _packs("mash")
    store = str(tmp_path / "store")
    first = _port("mash", ours, store)
    before = _blocks(store)
    victim = os.path.join(store, "blk_002_001.npz")
    if how == "deleted":
        os.remove(victim)
    else:
        with open(victim, "r+b") as f:
            f.truncate(40)
    calls = _launches(monkeypatch)
    again = _port("mash", ours, store)
    assert calls[0] == 1  # the one block, by the TileExecutor
    assert counters.faults.get("ring_blocks_recovered") == 1
    assert _same(again, first)
    assert {k: v.tobytes() for k, v in _blocks(store).items()} == {k: v.tobytes() for k, v in before.items()}


def test_failed_step_recovers_per_block(tmp_path, monkeypatch):
    """A step whose wait fails (ring_dispatch:raise, once) ends the step
    loop; every block still missing is recomputed per block, the same
    matrices out."""
    ours, _ = _packs("containment")
    want = _port("containment", ours, None)
    faults.configure("ring_dispatch:raise:max=1")
    calls = _launches(monkeypatch)
    got = _port("containment", ours, str(tmp_path / "store"))
    assert _same(got, want)
    assert counters.faults.get("ring_step_failures") == 1
    recovered = counters.faults.get("ring_blocks_recovered")
    assert recovered == len(allpairs.ring_schedule(D, True))
    # every step's launches were issued up front, then one a block
    assert calls[0] == 2 * recovered


def test_store_names_and_meta_are_jax(tmp_path):
    ours, theirs = _packs("mash")
    allpairs.configure_ring(checkpoint_base=str(tmp_path / "p"))
    jring.configure_ring(checkpoint_base=str(tmp_path / "j"))
    _port("mash", ours, None)
    _jax("mash", theirs, None)
    (pd,), (jd,) = os.listdir(tmp_path / "p"), os.listdir(tmp_path / "j")
    assert pd == jd and pd.startswith(f"ring_mash_k{K}_d{D}_")
    assert allpairs._read_ring_meta(str(tmp_path / "p" / pd)) == jring._read_ring_meta(str(tmp_path / "j" / jd))
    for a, b, e in ((0, 0, 0), (3, 1, 2), (12, 7, 11)):
        assert allpairs._block_name(a, b, e) == jring._block_name(a, b, e)


def _stripe_store(root: str, pkg: str, packed):
    if pkg == "torch":
        return streaming.streaming_mash_edges(packed, k=K, cutoff=0.5, block=128, checkpoint_dir=root,
                                              device="cpu")
    return jax_streaming.streaming_mash_edges(packed, k=K, cutoff=0.5, block=128, checkpoint_dir=root)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_degraded_pod_stripe_shards_resume_across_packages(tmp_path, writer, reader):
    """A store as a degraded pod leaves it — a stripe under an epoch-stamped
    name, the provenance stamped into its meta — resumes in the other
    package with no pair computed and the same edges."""
    ours, theirs = _packs("mash", n=150, seed=9)
    root = str(tmp_path / "s")
    ii, jj, dd, _ = _stripe_store(root, writer, ours if writer == "torch" else theirs)
    os.rename(os.path.join(root, "row_00001.npz"), os.path.join(root, "row_00001.e01.npz"))
    from drep_tpu_torch.utils.ckptmeta import stamp_checkpoint_meta

    stamp_checkpoint_meta(root, {"pod_epochs": 2, "dead_processes": [1]})
    ii2, jj2, dd2, pairs = _stripe_store(root, reader, ours if reader == "torch" else theirs)
    assert pairs == 0
    for x, y in ((ii, ii2), (jj, jj2), (dd, dd2)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
