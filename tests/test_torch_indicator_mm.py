"""The port's fused indicator product (``csrc/indicator_mm.cu``, which runs
only on the card) and its plain version, against the JAX package.

A numpy emulation of the kernel's grid (the upper 128 x 128 tiles times
the vocabulary splits), of its dense producer walk (ROW_LANES lanes a
row and ROWS_A_LANE rows a lane at once, ROW_PIECES 16-byte pieces a
lane a row from the piece holding the row's cursor, the cursors kept by
lane, the lines cleared a chunk, the bytes scattered into the
128-byte-swizzled K-major stage, one staged side on a diagonal tile) and
of its mirrored epilogue is held against the plain version; the sparse
walk is the ring kernel's block body, emulated in
tests/test_torch_ring_matmul.py, run here on the triangle's tiles. The
rectangular entry's grid (every output tile of [na, nb] times the
splits), its producers on two packs with their own row counts, and its
epilogue (bounded by each side, no mirror) are emulated the same way. The
constants are read from the sources; a change to the kernel's schedule or
layout must be made here too. The plain version is held bit for bit
against the JAX package's triangular indicator matmul and host mirror.
Every count is an integer and compared exactly.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ring_matmul import (
    ATOM,
    CONSUMERS,
    KC,
    SIDE,
    STAGE_SIZE,
    STAGES,
    TM,
    _mm_define,
    emulate_mm_block,
    fragment_map,
    gmma_desc,
    gmma_read,
    mm_swizzled,
)

from drep_tpu.ops import containment as jc
from drep_tpu_torch.ops import containment as tc
from drep_tpu_torch.ops import indicator as ti
from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD

CPU = torch.device("cpu")
PAD = int(PAD_ID)
with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "drep_tpu_torch", "csrc", "indicator_mm.cu")) as _f:
    _src = _f.read()
ROW_LANES, ROWS_A_LANE, ROW_PIECES, MIN_CHUNKS = (int(re.search(rf"#define {name} (\d+)", _src).group(1))
                                                 for name in ("ROW_LANES", "ROWS_A_LANE", "ROW_PIECES", "MIN_CHUNKS"))
ROWS_AT_ONCE = 32 // ROW_LANES * ROWS_A_LANE  # rows a warp walks at once
PRODUCER_WARPS = 4 * _mm_define("PRODUCERS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def upper_tile(u: int, tiles: int) -> tuple[int, int]:
    """indicator_mm_kernel's (bi, bj), bi <= bj, of upper tile u."""
    bi = 0
    while u >= tiles - bi:
        u -= tiles - bi
        bi += 1
    return bi, bi + u


def indicator_mm_grid(n: int, v_pad: int, sms: int = 132) -> tuple[int, int, int]:
    """indicator_mm_launch's (tiles, splits, chunks a split) on a card of
    `sms` SMs: mm_splits of one wave of blocks over the upper tiles."""
    tiles = -(-n // TM)
    n_chunks = -(-v_pad // KC)
    splits = max(1, min(sms // (tiles * (tiles + 1) // 2), max(1, n_chunks // MIN_CHUNKS)))
    per_split = -(-n_chunks // splits)
    return tiles, -(-n_chunks // per_split), per_split


def indicator_mm_rect_grid(na: int, nb: int, v_pad: int, sms: int = 132) -> tuple[int, int, int, int]:
    """indicator_mm_rect_launch's (B tiles, output tiles, splits, chunks a
    split): mm_splits of one wave of blocks over every output tile."""
    tiles_b = -(-nb // TM)
    tiles = -(-na // TM) * tiles_b
    n_chunks = -(-v_pad // KC)
    splits = max(1, min(sms // tiles, max(1, n_chunks // MIN_CHUNKS)))
    per_split = -(-n_chunks // splits)
    return tiles_b, tiles, -(-n_chunks // per_split), per_split


def row_line(t: int) -> int:
    return (t >> 3) * 1024 + (t & 7) * 128


def emulate_dense_block(a: np.ndarray, b: np.ndarray, v_pad: int, bi: int, bj: int, z: int, per_split: int,
                        out: np.ndarray, stats: dict, symmetric: bool) -> None:
    """One block of indicator_mm_kernel<true> (`symmetric`: `a` is `b`, a
    diagonal tile stages one side, an off-diagonal one is mirrored) or of
    indicator_mm_rect_kernel<true>: its sums added into out [len(a),
    len(b)]. Each side's rows past its own count read as empty."""
    width = a.shape[1]
    assert width % 4 == 0 and b.shape[1] == width
    diag = symmetric and bi == bj
    n_rows = TM if diag else 2 * TM  # staged rows: A's, then B's
    per_warp = n_rows // PRODUCER_WARPS
    lo_id = z * per_split * KC
    hi_id = min(lo_id + per_split * KC, v_pad)

    def side(r):
        return a if r < TM else b

    def pack_row(r):
        return (bi if r < TM else bj) * TM + r % TM

    def held(r):
        return pack_row(r) < side(r).shape[0]

    def row_of(r):
        return side(r)[pack_row(r) if held(r) else 0]

    cursor = [int(np.searchsorted(row_of(r), lo_id)) if held(r) else width for r in range(n_rows)]
    smem = np.zeros(STAGES * STAGE_SIZE, np.uint8)
    acc = np.zeros((CONSUMERS, 64, 128), np.int64)
    stage, base = 0, lo_id
    while True:
        live = base < hi_id
        end = min(base + KC, hi_id)
        st = stage * STAGE_SIZE
        for r in range(n_rows):  # each warp clears its rows' lines
            line = st + (r // TM) * SIDE + row_line(r % TM)
            for h in range(KC // 128):
                smem[line + h * ATOM : line + h * ATOM + 128] = 0
        for w in range(PRODUCER_WARPS if live else 0):
            for q in range(-(-per_warp // ROWS_AT_ONCE)):
                rows = [w * per_warp + j for j in range(ROWS_AT_ONCE * q, min(ROWS_AT_ONCE * (q + 1), per_warp))]
                cur = [cursor[r] for r in rows]
                on = [end - base] * len(rows)  # a row's span while its run goes on, then 0
                while any(on):  # the warp walks while a row's run goes on
                    for i, r in enumerate(rows):
                        # each lane's ROW_PIECES 16-byte pieces, ROW_LANES pieces apart
                        pos = (cur[i] & ~3) + np.arange(4 * ROW_LANES * ROW_PIECES)
                        v = np.where(pos < width, row_of(r)[np.minimum(pos, width - 1)], PAD).astype(np.int64)
                        k = (v - base) & 0xFFFFFFFF  # unsigned, as the kernel compares
                        into = k < on[i]
                        line = st + (r // TM) * SIDE + row_line(r % TM)
                        kk = k[into]
                        smem[line + (kk >> 7) * ATOM + ((kk & 127) ^ ((r % TM & 7) << 4))] = 1
                        cur[i] += int(into.sum())
                        if v[-1] >= end:
                            on[i] = 0
                        stats["windows"] += 1
                for i, r in enumerate(rows):
                    cursor[r] = cur[i]
        if live:
            stats["chunks"] += 1
        span = end - base
        # the stage holds exactly this chunk's bytes of the staged rows
        want = np.zeros(STAGE_SIZE, np.uint8)
        for r in range(n_rows):
            if live and held(r):
                row = side(r)[pack_row(r)]
                ks = row[(row >= base) & (row < base + span)].astype(np.int64) - base
                want[(r // TM) * SIDE + mm_swizzled(r % TM, ks)] = 1
        np.testing.assert_array_equal(smem[st : st + STAGE_SIZE], want)
        b_off = 0 if diag else SIDE  # a diagonal tile's B operand is its staged A rows
        for g in range(CONSUMERS):
            for s in range(KC // 32):
                k_off = (s >> 2) * ATOM + (s & 3) * 32
                acc[g] += gmma_read(smem, gmma_desc(st + g * 8 * 1024 + k_off), 64) @ gmma_read(
                    smem, gmma_desc(st + b_off + k_off), 128).T
        if not live:
            break
        base += KC
        stage = (stage + 1) % STAGES
    v, lane, w = np.meshgrid(np.arange(64), np.arange(32), np.arange(4), indexing="ij")
    row, col = fragment_map(v, lane, w)
    for g in range(CONSUMERS):
        ri = bi * TM + 64 * g + row
        cj = bj * TM + col
        keep = (ri < out.shape[0]) & (cj < out.shape[1])  # the epilogue's rows, cols (ld = cols)
        np.add.at(out, (ri[keep], cj[keep]), acc[g][row[keep], col[keep]])
        if symmetric and not diag:
            np.add.at(out, (cj[keep], ri[keep]), acc[g][row[keep], col[keep]])


def emulate_indicator_mm(ids: np.ndarray, v_pad: int, dense: bool, out: np.ndarray, stats: dict) -> None:
    """indicator_mm_launch on int32 ids: every block's sums added into `out`."""
    n = ids.shape[0]
    tiles, splits, per_split = indicator_mm_grid(n, v_pad)
    for z in range(splits):
        for u in range(tiles * (tiles + 1) // 2):
            bi, bj = upper_tile(u, tiles)
            if dense:
                emulate_dense_block(ids, ids, v_pad, bi, bj, z, per_split, out, stats, symmetric=True)
            else:  # the ring's block body on A rows bi and B rows bj, mirrored off the diagonal
                tile = np.zeros_like(out)
                emulate_mm_block(ids, ids, v_pad, bi, bj, z, per_split, tile, stats)
                out += tile if bi == bj else tile + tile.T


def emulate_indicator_mm_rect(a: np.ndarray, b: np.ndarray, v_pad: int, dense: bool, out: np.ndarray,
                              stats: dict) -> None:
    """indicator_mm_rect_launch on int32 packs of one width: every block's
    sums added into out [len(a), len(b)]."""
    tiles_b, tiles, splits, per_split = indicator_mm_rect_grid(a.shape[0], b.shape[0], v_pad)
    for z in range(splits):
        for x in range(tiles):
            bi, bj = x // tiles_b, x % tiles_b
            if dense:
                emulate_dense_block(a, b, v_pad, bi, bj, z, per_split, out, stats, symmetric=False)
            else:
                emulate_mm_block(a, b, v_pad, bi, bj, z, per_split, out, stats)


def _rows(rng, n: int, width: int, vocab: int, lo: int) -> np.ndarray:
    """n ascending PAD-padded rows of lo..width distinct ids below `vocab`;
    every fifth row all PAD."""
    ids = np.full((n, width), PAD, np.int32)
    for r in range(n):
        if r % 5 != 4:
            m = int(rng.integers(lo, width + 1))
            ids[r, :m] = np.sort(rng.choice(vocab, size=m, replace=False))
    return ids


def _plain(ids: np.ndarray, v_pad: int) -> np.ndarray:
    return ti.indicator_intersections_plain(torch.from_numpy(ids), v_pad).numpy()


# (n, width, v_pad, vocab, fewest ids a row): dense (>= 64 ids a row a
# chunk on the mean), sparse, 64 rows (< TM), ids past v_pad
SHAPES = {
    "dense": (150, 512, 1024, 1024, 300),
    "sparse": (150, 24, 2048, 2048, 1),
    "rows_64": (64, 256, 1024, 1024, 200),
    "ids_past_v_pad": (130, 160, 768, 1200, 100),
}


@pytest.mark.parametrize("dense", [True, False], ids=["dense_walk", "sparse_walk"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_kernel_equals_plain(shape, dense):
    """Either walk, on every block of the triangle's grid (rows past n
    masked, all-PAD rows, ids at or past v_pad never counted), gives the
    plain version's full symmetric counts."""
    n, width, v_pad, vocab, lo = SHAPES[shape]
    ids = _rows(np.random.default_rng(n + width), n, width, vocab, lo)
    if shape == "dense":
        assert (ids != PAD).sum(axis=1).max() * KC / v_pad >= 64
    stats = {"chunks": 0, "jumps": 0, "line_clears": 0, "windows": 0}
    out = np.zeros((n, n), np.int64)
    emulate_indicator_mm(ids, v_pad, dense, out, stats)
    np.testing.assert_array_equal(out, _plain(ids, v_pad))
    assert stats["chunks"] > 0


# (na, nb, width, v_pad, vocab, fewest ids a row): both sides below a
# tile, A past one tile and B past two, ids past v_pad
RECT_SHAPES = {
    "dense": (150, 300, 512, 1024, 1024, 300),
    "sparse": (200, 70, 24, 2048, 2048, 1),
    "rows_64_by_130": (64, 130, 256, 1024, 1024, 200),
    "ids_past_v_pad": (130, 20, 160, 768, 1200, 100),
}


@pytest.mark.parametrize("dense", [True, False], ids=["dense_walk", "sparse_walk"])
@pytest.mark.parametrize("shape", list(RECT_SHAPES))
def test_emulated_rect_kernel_equals_plain(shape, dense):
    """The rectangular entry, either walk, on every block of its grid (each
    side's rows past its own count masked, no mirror, no diagonal tile),
    gives the plain version's [na, nb] counts."""
    na, nb, width, v_pad, vocab, lo = RECT_SHAPES[shape]
    rng = np.random.default_rng(na + 3 * nb)
    a, b = _rows(rng, na, width, vocab, lo), _rows(rng, nb, width, vocab, lo)
    stats = {"chunks": 0, "jumps": 0, "line_clears": 0, "windows": 0}
    out = np.zeros((na, nb), np.int64)
    emulate_indicator_mm_rect(a, b, v_pad, dense, out, stats)
    want = ti.indicator_rect_intersections_plain(torch.from_numpy(a), torch.from_numpy(b), v_pad).numpy()
    np.testing.assert_array_equal(out, want)
    assert stats["chunks"] > 0


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("na,nb,v_pad", [(128, 512, 1 << 18), (256, 128, 1 << 15), (129, 1000, 8192), (1, 1, 256)])
def test_rect_grid_covers_each_tile_vocabulary_once(na, nb, v_pad, sms):
    """The rectangular grid visits every output tile once (row-major over
    B's tiles), its splits tile [0, v_pad) in whole chunks, every split
    non-empty, in one wave where the tiles are fewer than the SMs."""
    tiles_b, tiles, splits, per = indicator_mm_rect_grid(na, nb, v_pad, sms)
    seen = sorted((x // tiles_b, x % tiles_b) for x in range(tiles))
    assert seen == [(i, j) for i in range(-(-na // TM)) for j in range(-(-nb // TM))]
    n_chunks = -(-v_pad // KC)
    assert (splits - 1) * per < n_chunks <= splits * per
    if tiles <= sms:
        assert tiles * splits <= sms


def test_emulated_kernel_adds_chunks_into_one_accumulator():
    """Two vocabulary chunks of one pack (the chunked route's uint16
    chunks, rebased), launched in turn into one output, give the counts
    over the whole vocabulary."""
    rng = np.random.default_rng(4)
    ids = _rows(rng, 70, 200, 2048, 50)
    chunks = []
    for c in range(2):
        part = np.where((ids >= 1024 * c) & (ids < 1024 * (c + 1)), ids - 1024 * c, PAD)
        chunks.append(np.sort(part, axis=1).astype(np.int32))
    for dense in (True, False):
        out = np.zeros((70, 70), np.int64)
        for part in chunks:
            emulate_indicator_mm(part, 1024, dense, out, {"chunks": 0, "jumps": 0, "line_clears": 0, "windows": 0})
        np.testing.assert_array_equal(out, _plain(ids, 2048))


@pytest.mark.parametrize("sms", [132, 1, 200])
@pytest.mark.parametrize("n,v_pad", [(512, 1 << 16), (512, 1 << 15), (1024, 1 << 15), (1024, 1 << 18),
                                     (64, 8192), (129, 256 * 3), (65536, 8192)])
def test_grid_covers_each_upper_tile_vocabulary_once(n, v_pad, sms):
    """The tile map visits each upper tile (bi <= bj) once, the splits
    tile [0, v_pad) in whole chunks, every split non-empty, and the grid
    is one wave where the upper tiles are fewer than the SMs."""
    tiles, splits, per = indicator_mm_grid(n, v_pad, sms)
    upper = [upper_tile(u, tiles) for u in range(tiles * (tiles + 1) // 2)]
    assert sorted(upper) == [(i, j) for i in range(tiles) for j in range(i, tiles)]
    n_chunks = -(-v_pad // KC)
    assert (splits - 1) * per < n_chunks <= splits * per
    if len(upper) <= sms:
        assert len(upper) * splits <= sms


def _scaled_set(rng, n, base_len):
    pool = np.unique(rng.integers(0, 2**63, size=base_len * 3, dtype=np.uint64))
    out = []
    for _ in range(n):
        keep = pool[rng.random(len(pool)) < rng.uniform(0.3, 0.9)]
        own = rng.integers(0, 2**63, size=int(rng.integers(1, 40)), dtype=np.uint64)
        out.append(np.unique(np.concatenate([keep, own])))
    return out


def _jax_tri_mirrored(ids: np.ndarray, v_pad: int) -> np.ndarray:
    tri = np.array(jc._intersect_matmul_tri(jnp.asarray(ids), v_pad=v_pad))
    return jc.mirror_lower_blocks(tri, jc.tri_row_block(ids.shape[0]))


def test_plain_equals_jax_triangle_and_mirror_shared_pack():
    rng = np.random.default_rng(5)
    sketches = _scaled_set(rng, 70, 300)
    packed = tc.pack_scaled_sketches(sketches, [f"g{i}" for i in range(70)])
    m_pad = tc.matmul_rows_pad(packed.n)
    assert ti.tri_row_block(m_pad) == jc.tri_row_block(m_pad) < m_pad  # several row blocks
    ids, _ = tc.pad_packed_rows(packed.ids, packed.counts, m_pad)
    v_pad = tc.matmul_vocab_pad(packed)
    got = ti.indicator_intersections_plain(torch.from_numpy(ids), v_pad).numpy()
    np.testing.assert_array_equal(got, _jax_tri_mirrored(ids, v_pad))


def test_plain_equals_jax_triangle_and_mirror_clusterlocal_uint16_pack():
    rng = np.random.default_rng(6)
    groups = [_scaled_set(rng, int(rng.integers(2, 9)), 200) for _ in range(9)]
    names = [f"g{i}" for i in range(sum(len(g) for g in groups))]
    packed, v_extent = tc.pack_scaled_sketches_clusterlocal(groups, names)
    assert packed.ids.dtype == np.uint16
    m_pad = tc.matmul_rows_pad(packed.n)
    ids = np.full((m_pad, packed.ids.shape[1]), U16_PAD, np.uint16)
    ids[: packed.n] = packed.ids
    v_pad = tc.matmul_vocab_pad_extent(v_extent)
    got = ti.indicator_intersections_plain(torch.from_numpy(ids), v_pad).numpy()
    np.testing.assert_array_equal(got, _jax_tri_mirrored(ids, v_pad))
    np.testing.assert_array_equal(ti.indicator_intersections(torch.from_numpy(ids), v_pad).numpy(), got)


def test_chunked_route_equals_jax_chunked(monkeypatch):
    """Past a budget cut so that the vocabulary takes two uint16 chunks, the
    port's chunked route gives the JAX package's (ani, cov) byte for byte."""
    rng = np.random.default_rng(7)
    sketches = _scaled_set(rng, 40, 4000)
    names = [f"g{i}" for i in range(40)]
    packed = tc.pack_scaled_sketches(sketches, names)
    jpacked = jc.pack_scaled_sketches(sketches, names)
    monkeypatch.setattr(tc, "MATMUL_BUDGET_ELEMS", 64 * 8200)
    monkeypatch.setattr(jc, "MATMUL_BUDGET_ELEMS", 64 * 8200)
    assert tc.matmul_vocab_chunk(tc.matmul_rows_pad(40)) == 8192 < tc.vocab_extent(packed.ids)
    want = jc.all_vs_all_containment_matmul_chunked(jpacked, k=21)
    got = tc.all_vs_all_containment_matmul_chunked(packed, k=21, device=CPU)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()


def test_wrapper_on_cpu_adds_into_out_and_counts_no_launch():
    ids = torch.tensor([[0, 5, 9, PAD], [5, 9, 40, PAD], [PAD, PAD, PAD, PAD]], dtype=torch.int32)
    before = ti.LAUNCHES["indicator_mm"]
    out = torch.ones((3, 3), dtype=torch.int32)
    assert ti.indicator_intersections(ids, 32, out=out) is out
    assert out.tolist() == [[4, 3, 1], [3, 3, 1], [1, 1, 1]]  # id 40 >= v_pad counts nothing
    assert ti.LAUNCHES["indicator_mm"] == before
    with pytest.raises(ValueError, match="out must be"):
        ti.indicator_intersections(ids, 32, out=torch.zeros((3, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="want ids"):
        ti.indicator_intersections(ids[0], 32)


def test_rect_wrapper_on_cpu_adds_into_out_and_counts_no_launch():
    """On CPU tensors the rectangular wrapper runs the plain version (a
    uint16 pack widened), adds into `out` and launches nothing; it takes
    packs of one width only."""
    a = torch.tensor([[0, 5, 9, PAD], [5, 9, 40, PAD]], dtype=torch.int32)
    b = torch.tensor([[5, 0xFFFF, 0xFFFF, 0xFFFF], [0, 9, 0xFFFF, 0xFFFF], [0xFFFF] * 4],
                     dtype=torch.int32).to(torch.uint16)
    before = dict(ti.LAUNCHES)
    out = torch.ones((2, 3), dtype=torch.int32)
    assert ti.indicator_rect_intersections(a, b, 32, out=out) is out
    assert out.tolist() == [[2, 3, 1], [2, 2, 1]]  # id 40 >= v_pad counts nothing
    assert ti.LAUNCHES == before
    with pytest.raises(ValueError, match="out must be"):
        ti.indicator_rect_intersections(a, b, 32, out=torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="v_pad"):
        ti.indicator_rect_intersections(a, b, 20)
    with pytest.raises(ValueError, match="one width"):
        ti.indicator_rect_intersections(a, b[:, :2], 32)


@pytest.mark.parametrize("width,v_pad,want", [(32768, 65536, True), (16384, 16384, True), (1024, 32768, True),
                                              (2048, 1 << 22, False), (128, 1 << 20, False)])
def test_walk_follows_ids_a_row_a_chunk(width, v_pad, want):
    """The dense walk where a full row holds DENSE_MIN_IDS_PER_CHUNK ids a
    chunk or more: the one-shot secondary's packs (phase 3's and 5's
    shapes), a chunk of the chunked route (C's); the sparse walk on the
    ring's sparse shapes."""
    assert ti.dense_walk(width, v_pad) == want
    assert want == (width * KC / v_pad >= ti.DENSE_MIN_IDS_PER_CHUNK)
