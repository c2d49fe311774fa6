"""The port's Mash shared counts (drep_tpu_torch/ops/mash.py, plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode and its jnp sort estimator.

Tolerances: the Pallas path and the port both turn shared counts into
(distance, jaccard) with the same numpy transform, so equal counts give
bit-identical outputs — asserted exactly. Against the jnp estimator, which
takes the float32 log on the device, distances agree to the repo's own
atol=1e-7 (tests/test_pallas_mash.py).
"""

import numpy as np
import pytest
import torch

from drep_tpu.ops.minhash import all_vs_all_mash as jax_all_vs_all_mash
from drep_tpu.ops.minhash import mash_distance_tile as jax_mash_distance_tile
from drep_tpu.ops.minhash import pack_sketches as jax_pack_sketches
from drep_tpu.ops.pallas_mash import all_vs_all_mash_pallas, mash_distance_tile_pallas
from drep_tpu_torch.ops import mash
from drep_tpu_torch.ops.minhash import PAD_ID, pack_sketches

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sketch_set(rng, n, s, overlap=0.6):
    base = np.unique(rng.integers(0, 2**62, size=8 * s * n, dtype=np.uint64))
    rng.shuffle(base)
    shared = base[:s]
    out = []
    for i in range(n):
        own = base[s * (i + 1) : s * (i + 2)]
        mix = int(s * overlap * rng.random())
        out.append(np.sort(np.unique(np.concatenate([shared[:mix], own[: s - mix]]))[:s]))
    return out


def _ragged(sketches, rng):
    """Cut a third of the rows short so s_use = min(|A|, |B|, s) varies."""
    out = list(sketches)
    for i in range(0, len(out), 3):
        out[i] = out[i][: int(rng.integers(1, len(out[i]) + 1))]
    return out


@pytest.mark.parametrize("width", [64, 100, 1000])
def test_all_vs_all_equals_pallas_exactly(width):
    rng = np.random.default_rng(width)
    n = 20
    sketches = _ragged(_sketch_set(rng, n, width), rng)
    names = [f"g{i}" for i in range(n)]
    packed = pack_sketches(sketches, names, width)
    jpacked = jax_pack_sketches(sketches, names, width)
    np.testing.assert_array_equal(packed.ids, jpacked.ids)
    assert packed.counts.min() < width  # genuinely ragged
    want_d, want_j = all_vs_all_mash_pallas(jpacked, k=21)
    got_d, got_j = mash.all_vs_all_mash(packed, k=21, device=CPU)
    assert got_d.dtype == want_d.dtype == np.float32
    np.testing.assert_array_equal(got_j, want_j)
    np.testing.assert_array_equal(got_d, want_d)
    # the counts themselves: jaccard = shared / s_use, exact for these sizes
    s_use = np.minimum(np.minimum.outer(packed.counts, packed.counts), width)
    want_shared = np.rint(want_j.astype(np.float64) * s_use).astype(np.int32)
    got_shared = mash.shared_all_vs_all(packed, CPU)
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(got_shared[off], want_shared[off])


@pytest.mark.parametrize("width", [64, 1000])
def test_rect_tile_equals_pallas_exactly(width):
    rng = np.random.default_rng(100 + width)
    sketches = _ragged(_sketch_set(rng, 13, width), rng)
    packed = pack_sketches(sketches, [f"g{i}" for i in range(13)], width)
    a_ids, a_n = packed.ids[:5], packed.counts[:5]
    b_ids, b_n = packed.ids[5:], packed.counts[5:]
    want_d, want_j = mash_distance_tile_pallas(a_ids, a_n, b_ids, b_n, k=21)
    got_d, got_j = mash.mash_distance_tile(a_ids, a_n, b_ids, b_n, k=21, device=CPU)
    np.testing.assert_array_equal(got_j, want_j)
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("width", [64, 100])
def test_all_vs_all_matches_jnp_sort_estimator(width):
    rng = np.random.default_rng(200 + width)
    n = 12
    sketches = _ragged(_sketch_set(rng, n, width), rng)
    packed = pack_sketches(sketches, [f"g{i}" for i in range(n)], width)
    want_d, want_j = jax_all_vs_all_mash(packed, k=21, tile=8)
    got_d, got_j = mash.all_vs_all_mash(packed, k=21, device=CPU)
    np.testing.assert_allclose(got_j, want_j, atol=1e-7)
    np.testing.assert_allclose(got_d, want_d, atol=1e-7)


def test_width_above_2048_matches_jnp_tile():
    """Widths past the TPU kernel's 2048 limit are ordinary here."""
    rng = np.random.default_rng(3)
    width, n = 3000, 6
    sketches = _ragged(_sketch_set(rng, n, width), rng)
    packed = pack_sketches(sketches, [f"g{i}" for i in range(n)], width)
    want_d, want_j = jax_mash_distance_tile(
        packed.ids, packed.counts, packed.ids, packed.counts, k=21
    )
    got_d, got_j = mash.mash_distance_tile(
        packed.ids, packed.counts, packed.ids, packed.counts, k=21, device=CPU
    )
    np.testing.assert_allclose(got_j, np.asarray(want_j), atol=1e-7)
    np.testing.assert_allclose(got_d, np.asarray(want_d), atol=1e-7)


def _pair_shared_loop(a, b, na, nb, s):
    """One pair, straight from the estimator's definition."""
    x = np.sort(np.concatenate([a, b]))
    shared, rank, prev = 0, 0, None
    s_use = min(na, nb, s)
    for v in x:
        if v == PAD_ID:
            break
        if v == prev:
            shared += rank <= s_use
        else:
            rank += 1
            prev = v
    return shared


def test_plain_equals_definition_with_in_row_duplicates():
    """The plain version follows the estimator's definition even off the
    packer's contract (repeated ids inside a row)."""
    rng = np.random.default_rng(9)
    rows, width = 6, 40
    ids = np.sort(rng.integers(0, 50, size=(rows, width)).astype(np.int32), axis=1)
    counts = rng.integers(0, width + 1, size=rows).astype(np.int32)
    for r in range(rows):
        ids[r, counts[r]:] = PAD_ID
    t = torch.from_numpy(ids)
    c = torch.from_numpy(counts)
    got = mash.mash_shared_plain(t, c, t, c, s_orig=width).numpy()
    for i in range(rows):
        for j in range(rows):
            assert got[i, j] == _pair_shared_loop(ids[i], ids[j], counts[i], counts[j], width)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(4)
    sketches = _ragged(_sketch_set(rng, 200, 64), rng)
    packed = pack_sketches(sketches, [f"g{i}" for i in range(200)], 64)
    ids, counts = mash._pad_rows(packed.ids, packed.counts, 64)
    t, c = torch.from_numpy(ids), torch.from_numpy(counts)
    before = mash.LAUNCHES["mash_shared"]
    full = mash.mash_shared(t, c, t, c, s_orig=64)
    wrapped = mash.mash_shared(t, c, t, c, s_orig=64, symmetric=True)
    assert mash.LAUNCHES["mash_shared"] == before
    assert wrapped.shape == (256, (2 // 2 + 1) * mash.TILE)
    np.testing.assert_array_equal(mash.unwrap_symmetric(wrapped.numpy()), full.numpy())
    np.testing.assert_array_equal(full.numpy(), full.numpy().T)
    with pytest.raises(ValueError, match="multiples"):
        mash.mash_shared(t[:100], c[:100], t, c, s_orig=64)
