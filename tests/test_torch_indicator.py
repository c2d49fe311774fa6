"""The port's indicator rows and one-shot containment (plain versions on
the CPU) against the JAX package: the XLA scatter, the Pallas indicator
kernel in interpret mode, and the one-shot indicator matmul.

Everything here is integer or the same float32 host formula on both
sides, so every comparison is exact (ani/cov byte-identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drep_tpu.ops import containment as jc
from drep_tpu.ops.minhash import widen_ids_device
from drep_tpu.ops.pallas_indicator import _indicator_pallas_jit
from drep_tpu_torch.ops import containment as tc
from drep_tpu_torch.ops import indicator as ti
from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, ids_to_device

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sorted_rows(rng, m, width, v_hi, v_pad):
    """Sorted unique id rows with PAD tails; some ids land at or past v_pad
    (ignored by the indicator) and one row is all padding."""
    ids = np.full((m, width), PAD_ID, np.int32)
    for r in range(1, m):
        n = int(rng.integers(1, width + 1))
        ids[r, :n] = np.sort(rng.choice(v_hi, size=n, replace=False))
    assert (ids[ids != PAD_ID] >= v_pad).any()
    return ids


@pytest.mark.parametrize("dtype", ["int32", "uint16"])
def test_indicator_equals_xla_scatter_and_pallas(dtype):
    rng = np.random.default_rng(1 if dtype == "int32" else 2)
    m, width, v_pad = 8, 48, 8192
    ids = _sorted_rows(rng, m, width, v_hi=9000, v_pad=v_pad)
    if dtype == "uint16":
        ids = np.where(ids == PAD_ID, U16_PAD, ids).astype(np.uint16)
    jids = widen_ids_device(jnp.asarray(ids))
    want_xla = np.asarray(jc._indicator(jids, v_pad, jnp.int8, use_pallas=False))
    want_pallas = np.asarray(_indicator_pallas_jit(jids, v_pad=v_pad, interpret=True))
    got = ti.indicator(ids_to_device(ids, CPU), v_pad)
    assert got.dtype == torch.int8 and got.shape == (m, v_pad)
    np.testing.assert_array_equal(want_xla, want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_xla)


def test_indicator_wrapper_counts_no_launch_on_cpu():
    ids = torch.tensor([[0, 5, int(PAD_ID)], [5, 9, 20]], dtype=torch.int32)
    before = ti.LAUNCHES["indicator_mm"]
    out = ti.indicator_intersections(ids, 16)
    assert ti.LAUNCHES["indicator_mm"] == before
    assert out.tolist() == [[2, 1], [1, 2]]
    assert ti.indicator(ids, 16)[0].nonzero().flatten().tolist() == [0, 5]
    for fn in (ti.indicator, ti.indicator_intersections):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(ids, 100)


def _scaled_set(rng, n, base_len=300):
    pool = np.unique(rng.integers(0, 2**63, size=base_len * 3, dtype=np.uint64))
    out = []
    for _ in range(n):
        keep = pool[rng.random(len(pool)) < rng.uniform(0.3, 0.9)]
        own = rng.integers(0, 2**63, size=int(rng.integers(1, 40)), dtype=np.uint64)
        out.append(np.unique(np.concatenate([keep, own])))
    return out


def test_one_shot_counts_and_ani_cov_equal_jax_shared_pack():
    rng = np.random.default_rng(5)
    sketches = _scaled_set(rng, 70)
    names = [f"g{i}" for i in range(70)]
    packed = tc.pack_scaled_sketches(sketches, names)
    jpacked = jc.pack_scaled_sketches(sketches, names)
    np.testing.assert_array_equal(packed.ids, jpacked.ids)
    v_pad = tc.matmul_vocab_pad(packed)
    assert v_pad == jc.matmul_vocab_pad(jpacked)
    m_pad = tc.matmul_rows_pad(packed.n)
    assert m_pad == 128 and ti.tri_row_block(m_pad) < m_pad  # several row blocks
    ids_pad, _ = tc.pad_packed_rows(packed.ids, packed.counts, m_pad)
    want_inter = np.asarray(jc._intersect_matmul(jnp.asarray(ids_pad), v_pad=v_pad))[:70, :70]
    got_inter = tc.intersections_one_shot(packed, v_pad, CPU)
    np.testing.assert_array_equal(got_inter, want_inter)
    want_ani, want_cov = jc.all_vs_all_containment_matmul(jpacked, k=21)
    got_ani, got_cov = tc.all_vs_all_containment_matmul(packed, k=21, device=CPU)
    assert got_ani.tobytes() == want_ani.tobytes()
    assert got_cov.tobytes() == want_cov.tobytes()


def test_one_shot_ani_cov_equal_jax_clusterlocal_pack():
    rng = np.random.default_rng(6)
    groups = [_scaled_set(rng, int(rng.integers(2, 9)), base_len=200) for _ in range(9)]
    names = [f"g{i}" for i in range(sum(len(g) for g in groups))]
    packed, v_extent = tc.pack_scaled_sketches_clusterlocal(groups, names)
    jpacked, jv_extent = jc.pack_scaled_sketches_clusterlocal(groups, names)
    assert packed.ids.dtype == np.uint16  # the link-compressed layout
    np.testing.assert_array_equal(packed.ids, jpacked.ids)
    assert v_extent == jv_extent
    v_pad = tc.matmul_vocab_pad_extent(v_extent)
    want_ani, want_cov = jc.all_vs_all_containment_matmul(jpacked, k=21, v_pad=v_pad)
    got_ani, got_cov = tc.all_vs_all_containment_matmul(packed, k=21, device=CPU, v_pad=v_pad)
    assert got_ani.tobytes() == want_ani.tobytes()
    assert got_cov.tobytes() == want_cov.tobytes()


def test_past_one_shot_budget_raises(monkeypatch):
    """The one-shot product refuses a pack past its budget (routing is
    containment_matrices' job); containment_matrices routes the same pack
    past the budget and gives the one-shot answer."""
    from drep_tpu_torch.cluster import engines

    rng = np.random.default_rng(8)
    packed = tc.pack_scaled_sketches(_scaled_set(rng, 12), [f"g{i}" for i in range(12)])
    want = tc.all_vs_all_containment_matmul(packed, k=21, device=CPU)
    with pytest.raises(ValueError, match="containment_matrices"):
        tc.intersections_one_shot(packed, tc.MATMUL_BUDGET_ELEMS, CPU)
    monkeypatch.setattr(tc, "MATMUL_BUDGET_ELEMS", 1 << 12)
    before = dict(engines.SECONDARY_PATH_COUNTS)
    got = engines.containment_matrices(packed, 21, CPU)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    routed = {p for p, c in engines.SECONDARY_PATH_COUNTS.items() if c != before.get(p, 0)}
    assert routed == {"matmul_chunked"}
