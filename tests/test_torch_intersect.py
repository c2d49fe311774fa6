"""The port's merge-intersect counts (plain versions on the CPU) against the
JAX package's Pallas merge kernels in interpret mode: kernel 3 at widths up
to PALLAS_MAX_WIDTH, kernel 4 (stacked id-range buckets) past it, on the
int32 and the uint16 bucket plans, with ragged rows, empty rows and in-row
repeats. Counts are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from drep_tpu.ops import pallas_merge as jm
from drep_tpu.ops.containment import pack_scaled_sketches as jax_pack_scaled_sketches
from drep_tpu_torch.ops import intersect as ti
from drep_tpu_torch.ops.containment import pack_scaled_sketches
from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, widen_ids
from drep_tpu_torch.ops.rangepart import stacked_range_buckets

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, n, max_len, vocab, repeats=False):
    """Sorted PAD-padded int32 rows: row 0 full length (fixes the width),
    row 1 empty, the rest ragged; `repeats` draws with replacement, so rows
    hold runs of equal ids."""
    lens = rng.integers(0, max_len + 1, size=n)
    lens[0], lens[1] = max_len, 0
    rows = []
    for m in lens:
        if repeats:
            rows.append(np.sort(rng.integers(0, vocab, size=m)).astype(np.int32))
        else:
            rows.append(np.sort(rng.choice(vocab, size=m, replace=False)).astype(np.int32))
    ids = np.full((n, max_len), PAD_ID, np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    return ids


@pytest.mark.parametrize("repeats", [False, True], ids=["distinct", "repeats"])
def test_kernel3_widths_equal_pallas(rng, repeats):
    a = _rows(rng, 9, 300, 400, repeats)
    b = _rows(rng, 5, 300, 400, repeats)
    np.testing.assert_array_equal(ti.intersect_counts(a, b, CPU), jm.intersect_counts_pallas(a, b))
    np.testing.assert_array_equal(ti.intersect_counts_self(a, CPU), jm.intersect_counts_pallas_self(a))


@pytest.mark.parametrize(
    "vocab,plan,repeats",
    [(3 * ti.PALLAS_MAX_WIDTH, np.uint16, False), (1 << 24, np.int32, False),
     (3 * ti.PALLAS_MAX_WIDTH, np.uint16, True)],
    ids=["uint16", "int32", "uint16-repeats"],
)
def test_kernel4_range_path_equals_pallas(rng, vocab, plan, repeats):
    width = ti.PALLAS_MAX_WIDTH + 600
    a = _rows(rng, 9, width, vocab, repeats)
    b = _rows(rng, 5, width, vocab, repeats)
    s2 = 1 << (width - 1).bit_length()
    pad = np.full((a.shape[0], s2), PAD_ID, np.int32)
    pad[:, :width] = a
    assert stacked_range_buckets([pad], ti.PALLAS_MAX_WIDTH)[0].dtype == plan
    got = ti.intersect_counts(a, b, CPU)
    np.testing.assert_array_equal(got, jm.intersect_counts_pallas(a, b, force="range"))
    got_self = ti.intersect_counts_self(a, CPU)
    np.testing.assert_array_equal(got_self, jm.intersect_counts_pallas_self(a, force="range"))
    np.testing.assert_array_equal(got_self, got_self.T)


@pytest.mark.parametrize("width,ndim", [(300, 2), (ti.PALLAS_MAX_WIDTH + 600, 3)], ids=["rows", "buckets"])
def test_self_operand_is_what_the_route_counts(rng, width, ndim):
    """self_operand is the input intersect_counts_self sends to its kernel
    ([rows, s2] or [R, rows, W], rows padded to TILE_A), and the route
    records the seconds of each of its parts."""
    a = _rows(rng, 9, width, 1 << 20)
    op = ti.self_operand(a)
    assert op.ndim == ndim and op.shape[-2] == ti.TILE_A
    d = widen_ids(torch.from_numpy(op if ndim == 3 else op[None].copy()))
    full = ti.intersect_stacked_plain(d, d)
    got = ti.intersect_counts_self(a, CPU)
    np.testing.assert_array_equal(got, full.numpy()[:9, :9])
    assert set(ti.STAGE_SECONDS) == {"operand", "h2d", "kernel", "kernel_d2h", "unwrap"}
    assert all(v >= 0 for v in ti.STAGE_SECONDS.values())


def test_all_vs_all_containment_merge_equals_pallas(rng):
    pool = np.unique(rng.integers(0, 2**63, size=900, dtype=np.uint64))
    sketches = [
        np.unique(np.concatenate([pool[rng.random(len(pool)) < 0.7],
                                  rng.integers(0, 2**63, size=50, dtype=np.uint64)]))
        for _ in range(11)
    ]
    packed = pack_scaled_sketches(sketches, [f"g{i}" for i in range(11)])
    jpacked = jax_pack_scaled_sketches(sketches, packed.names)
    want_ani, want_cov = jm.all_vs_all_containment_pallas(jpacked, k=21)
    got_ani, got_cov = ti.all_vs_all_containment_merge(packed, k=21, device=CPU)
    assert got_ani.tobytes() == want_ani.tobytes()
    assert got_cov.tobytes() == want_cov.tobytes()


def test_plain_counts_runs_as_p_plus_q_minus_1():
    """A run of p equal ids in A and q in B counts p + q - 1 (the JAX
    definition: adjacent equal non-PAD elements of the sorted merge)."""
    p = int(PAD_ID)
    a = torch.tensor([[1, 1, 4, 9, p, p]], dtype=torch.int32)
    b = torch.tensor([[1, 4, 4, 4, 7, p]], dtype=torch.int32)
    # 1: 2+1-1 = 2; 4: 1+3-1 = 3; 9, 7: 0
    assert ti.intersect_plain(a, b).tolist() == [[5]]
    assert ti.intersect_plain(b, b).tolist() == [[7]]  # 1: 1+1-1; 4: 3+3-1; 7: 1+1-1
    # an empty row counts the other row's own runs: 1 and 4 in A, 4 in B
    empty = torch.full((1, 6), p, dtype=torch.int32)
    assert ti.intersect_plain(torch.cat([a, empty]), torch.cat([b, empty])).tolist() == [[5, 1], [2, 0]]


def test_wrappers_on_cpu_run_plain_and_count_no_launch(rng):
    ids = _rows(rng, 256, 40, 100)
    ids16 = np.where(ids == PAD_ID, U16_PAD, ids).astype(np.uint16)
    d, d16 = torch.from_numpy(ids), torch.from_numpy(ids16)
    before = dict(ti.LAUNCHES)
    full = ti.intersect(d, d)
    assert full.shape == (256, 256) and torch.equal(full, ti.intersect_plain(d, d))
    assert torch.equal(ti.intersect(d16, d16), full)  # uint16 widened first
    sym = ti.intersect(d, d, symmetric=True)
    assert sym.shape == (256, 2 * 128)
    np.testing.assert_array_equal(ti.unwrap_symmetric(sym.numpy()), full.numpy())
    stacked = torch.stack([d, d])
    assert torch.equal(ti.intersect_stacked(stacked, stacked, symmetric=True), 2 * sym)
    assert ti.LAUNCHES == before
    with pytest.raises(ValueError, match="multiples of 128"):
        ti.intersect(d[:100], d[:100])
    with pytest.raises(ValueError, match="itself"):
        ti.intersect(d, d[:128], symmetric=True)
    with pytest.raises(TypeError, match="int32"):
        ti.intersect_counts(ids.astype(np.int64), ids, CPU)
