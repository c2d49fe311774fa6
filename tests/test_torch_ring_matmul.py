"""The port's indicator-matmul ring step (plain version on the CPU) and the
ring's choice of step, against the JAX package.

The JAX fused matmul body runs only under Pallas, whose interpret path
does not build on the installed JAX, so the step is held against the JAX
package's own indicator-matmul intersection
(``ops/containment.py::intersect_counts_matmul_rect``, which counts set
membership as the TPU body does), against ``containment_inter_tile`` and
the port's merge step on unique ranks, and the ring against the JAX
ppermute ring. Every count is an integer and compared exactly.
"""

import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from drep_tpu.controller import main as jax_main
from drep_tpu.ingest import GenomeSketches as JaxGenomeSketches
from drep_tpu.ingest import _save as jax_save
from drep_tpu.ingest import sketch_args_snapshot as jax_sketch_args_snapshot
from drep_tpu.ops import pallas_ring as jpr
from drep_tpu.ops.containment import containment_inter_tile, intersect_counts_matmul_rect
from drep_tpu.ops.containment import pack_scaled_sketches as jax_pack_scaled_sketches
from drep_tpu.parallel import allpairs as jring
from drep_tpu.parallel.mesh import make_mesh as jax_make_mesh
from drep_tpu_torch.cluster.engines import SECONDARY_PATH_COUNTS
from drep_tpu_torch.controller import main as torch_main
from drep_tpu_torch.ingest import save_sketch_cache
from drep_tpu_torch.ops import ring
from drep_tpu_torch.ops.containment import pack_scaled_sketches
from drep_tpu_torch.ops.minhash import PAD_ID
from drep_tpu_torch.parallel import allpairs
from drep_tpu_torch.parallel.mesh import make_mesh
from drep_tpu_torch.utils.synth import planted_sketches
from drep_tpu_torch.workdir import WorkDirectory

CPU = torch.device("cpu")
K = 21
PAD = int(PAD_ID)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    """The JAX package's variant knob unset, and its ring's run-wide flags
    at their defaults."""
    monkeypatch.delenv("DREP_TPU_RING_VARIANT", raising=False)
    jring.configure_ring()
    yield
    jring.configure_ring()


def _rows(rng, n: int, width: int, vocab: int, repeats: bool) -> np.ndarray:
    """n ascending PAD-padded rows of up to `width` ids below `vocab`;
    every fourth row empty; with `repeats`, even rows hold every id twice
    (in-row repeats)."""
    ids = np.full((n, width), PAD, np.int32)
    for r in range(n):
        m = 0 if r % 4 == 3 else int(rng.integers(1, width + 1))
        if repeats and r % 2 == 0:
            once = rng.choice(vocab, size=min((m + 1) // 2, vocab), replace=False)
            row = np.concatenate([once, once])[:m]
        else:
            row = rng.choice(vocab, size=min(m, vocab), replace=False)
        ids[r, : len(row)] = np.sort(row)
    return ids


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _counts(ids: np.ndarray) -> np.ndarray:
    return (ids != PAD).sum(axis=1).astype(np.int32)


def _plain_mm(a: np.ndarray, b: np.ndarray, v_pad: int) -> np.ndarray:
    return ring.ring_step_matmul_plain(_t(a), _t(_counts(a)), _t(b), _t(_counts(b)), v_pad).numpy()


# (n_local, W, vocab) of the JAX package's matmul-tile test: one vocabulary
# chunk and several
CASES = [(5, 32, 200), (8, 64, 9000), (1, 16, 100)]


@pytest.mark.parametrize("chunk_elems", [None, 1024], ids=["one_chunk", "many_chunks"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matmul_step_equals_jax_indicator_matmul(monkeypatch, case, chunk_elems):
    """With in-row repeats and empty rows: the plain step's tile equals the
    JAX indicator matmul byte for byte (a repeated id counts once). The
    plain step's own chunk budget cut down forces many vocabulary chunks
    (128 ids each at these row counts)."""
    if chunk_elems is not None:
        monkeypatch.setattr(ring, "_PLAIN_INDICATOR_ELEMS", chunk_elems)
    n_local, width, vocab = case
    rng = np.random.default_rng(n_local * 1000 + width)
    a = _rows(rng, n_local, width, vocab, repeats=True)
    b = _rows(rng, n_local, width, vocab, repeats=True)
    v_pad = ring.matmul_ring_vocab_pad(np.concatenate([a, b]))
    got = _plain_mm(a, b, v_pad)
    want = intersect_counts_matmul_rect(a, b)
    assert got.dtype == np.int32 and got.tobytes() == want.tobytes()


def test_plain_matmul_step_on_all_pad_rows_is_zero():
    a = np.full((4, 16), PAD, np.int32)
    b = _rows(np.random.default_rng(1), 4, 16, 50, repeats=False)
    for x, y in ((a, a), (a, b), (b, a)):
        v_pad = ring.matmul_ring_vocab_pad(np.concatenate([x, y]))
        got = _plain_mm(x, y, v_pad)
        assert got.tobytes() == intersect_counts_matmul_rect(x, y).tobytes()
        assert not got.any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matmul_step_equals_merge_tiles_on_unique_ranks(case):
    """Unique ranks (a scaled pack's rows): the matmul tile equals the JAX
    containment_inter_tile and the port's merge step; with repeats the
    merge step counts each copy and the two differ."""
    n_local, width, vocab = case
    rng = np.random.default_rng(7 + n_local)
    a = _rows(rng, n_local, width, vocab, repeats=False)
    b = _rows(rng, n_local, width, vocab, repeats=False)
    v_pad = ring.matmul_ring_vocab_pad(np.concatenate([a, b]))
    got = _plain_mm(a, b, v_pad)
    assert got.tobytes() == np.asarray(containment_inter_tile(a, b)).tobytes()
    merge = ring.ring_step_plain("containment", _t(a), _t(_counts(a)), _t(b), _t(_counts(b))).numpy()
    assert got.tobytes() == merge.tobytes()
    rep = np.array([[3, 3, 5, PAD]], np.int32)
    one = np.array([[3, 5, PAD, PAD]], np.int32)
    cnt = _t(_counts(rep))
    assert _plain_mm(rep, one, 128)[0, 0] == 2
    assert ring.ring_step_plain("containment", _t(rep), cnt, _t(one), cnt).numpy()[0, 0] == 3


def test_matmul_step_wrapper_copies_and_checks_operands():
    """The wrapper on CPU tensors: the plain tile, B copied into the receive
    buffers, no launch counted; the ring step's operand checks apply."""
    rng = np.random.default_rng(3)
    a, b = (_rows(rng, 6, 24, 300, repeats=False) for _ in range(2))
    ta, tb, na, nb = _t(a), _t(b), _t(_counts(a)), _t(_counts(b))
    dst = (torch.full_like(tb, -7), torch.full_like(nb, -7))
    got = ring.ring_step_matmul(ta, na, tb, nb, 512, *dst)
    assert torch.equal(got, ring.ring_step_matmul_plain(ta, na, tb, nb, 512))
    assert torch.equal(dst[0], tb) and torch.equal(dst[1], nb)
    assert torch.equal(ring.ring_step_matmul(ta, na, tb, nb, 512), got)
    assert ring.LAUNCHES["ring_step_mm"] == 0  # the CPU runs the plain version
    with pytest.raises(ValueError, match="overlaps"):
        ring.ring_step_matmul(ta, na, tb, nb, 512, tb, torch.empty_like(nb))
    with pytest.raises(ValueError, match="both receive buffers"):
        ring.ring_step_matmul(ta, na, tb, nb, 512, dst[0], None)
    with pytest.raises(TypeError, match="int32"):
        ring.ring_step_matmul(ta.long(), na, tb, nb, 512)
    with pytest.raises(ValueError, match="v_pad"):
        ring.ring_step_matmul(ta, na, tb, nb, 500)
    with pytest.raises(ValueError, match="unsupported device"):
        ring.ring_step_matmul(ta.to("meta"), na.to("meta"), tb.to("meta"), nb.to("meta"), 512)


@pytest.mark.parametrize("extent", [0, 1, 127, 128, 129, 9000, 1 << 20])
def test_matmul_ring_vocab_pad_equals_jax(extent):
    """Including the all-PAD matrix (extent 0)."""
    rng = np.random.default_rng(extent)
    ids = np.full((5, 8), PAD, np.int32)
    if extent:
        ids[:, :3] = np.sort(rng.integers(0, extent, size=(5, 3)), axis=1)
        ids[2, 0] = extent - 1
        ids[2].sort()
    assert ring.matmul_ring_vocab_pad(ids) == jpr.matmul_ring_vocab_pad(ids)


@pytest.mark.parametrize("kind,variant,v_pad", [
    ("mash", "matmul", 256), ("containment", "matmul", 0), ("containment", "matmul", -128),
    ("containment", "matmul", 200), ("containment", "bogus", 256), ("mash", "bogus", 0),
])
def test_variant_validation_raises_where_jax_raises(kind, variant, v_pad):
    with pytest.raises(ValueError):
        jpr.fused_ring_step_fn(kind, K, jax_make_mesh(2), interpret=True, variant=variant, v_pad=v_pad)
    with pytest.raises(ValueError):
        ring.check_variant(kind, variant, v_pad)


@pytest.mark.parametrize("kind,variant,v_pad", [
    ("containment", "matmul", 128), ("containment", "matmul", 1 << 26), ("mash", "merge", 0),
    ("containment", "merge", 0),
])
def test_variant_validation_accepts_what_jax_accepts(kind, variant, v_pad):
    jpr.fused_ring_step_fn(kind, K, jax_make_mesh(2), interpret=True, variant=variant, v_pad=v_pad)
    ring.check_variant(kind, variant, v_pad)


# (kind, v_pad, W, the step picked): the chip's four measured block
# shapes (cluster A, B, C, width 65 536), each side of the crossover, and
# each side of the kernel's v_pad limit
M = ring.MATMUL_MAX_VPAD_PER_WIDTH
PICKS = [
    ("containment", M << 15, 1 << 15, "matmul"),  # at the crossover
    ("containment", M << 11, 1 << 11, "matmul"),
    ("containment", (M >> 3) << 15, 1 << 15, "matmul"),  # below it
    ("containment", (M >> 4) << 16, 1 << 16, "matmul"),
    ("containment", (2 * M) << 11, 1 << 11, "merge"),  # past it
    ("containment", (2 * M) << 15, 1 << 15, "merge"),
    ("containment", M * ring.LANES, ring.LANES, "matmul"),
    ("containment", 2 * M * ring.LANES, ring.LANES, "merge"),
    ("containment", ring.MAX_V_PAD, ring.MAX_V_PAD // M, "matmul"),  # the kernel's largest v_pad
    ("containment", 2 * ring.MAX_V_PAD, 2 * ring.MAX_V_PAD // M, "merge"),  # past it
    ("mash", 128, 1 << 11, "merge"),
    ("mash", 1 << 20, 1 << 15, "merge"),
]


@pytest.mark.parametrize("kind,v_pad,width,want", PICKS, ids=lambda x: str(x))
def test_pick_variant_follows_v_pad_per_width(kind, v_pad, width, want):
    """matmul where v_pad <= MATMUL_MAX_VPAD_PER_WIDTH * W on a containment
    ring, merge otherwise and on every Mash ring; what it picks is what
    the JAX package's step builder accepts."""
    got = ring.pick_variant(kind, v_pad, width)
    assert got == want
    ring.check_variant(kind, got, v_pad)
    jpr.fused_ring_step_fn(kind, K, jax_make_mesh(2), interpret=True, variant=got, v_pad=v_pad)


def _count_calls(monkeypatch, name: str) -> list[int]:
    calls = [0]
    fn = getattr(ring, name)

    def counted(*a, **k):
        calls[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(ring, name, counted)
    return calls


_PACKS: dict = {}
_JAX_RINGS: dict = {}


def _packs():
    """(port pack, JAX pack) of 22 scaled sketches; the id matrices agree."""
    if not _PACKS:
        rng = np.random.default_rng(5)
        base = np.unique(rng.integers(0, 2**62, size=6000, dtype=np.uint64))
        rng.shuffle(base)
        sk = []
        for i in range(22):
            mix = int(100 * rng.random() * 0.8)
            own = base[100 * (i + 1) : 100 * (i + 2)]
            sk.append(np.sort(np.unique(np.concatenate([base[:mix], own[: 100 - mix]])))[: 100 - (i % 5) * 7])
        names = [f"g{i}" for i in range(22)]
        _PACKS["p"] = (pack_scaled_sketches(sk, names), jax_pack_scaled_sketches(sk, names))
        np.testing.assert_array_equal(_PACKS["p"][0].ids, _PACKS["p"][1].ids)
    return _PACKS["p"]


@pytest.mark.parametrize("full_grid", [False, True], ids=["half", "full"])
@pytest.mark.parametrize("d", [2, 3, 5, 8])
def test_matmul_ring_equals_jax_ring_and_merge_ring(monkeypatch, d, full_grid):
    """N = 22 genomes over D CPU positions (padded blocks at D = 3, 5, 8):
    the matmul-variant ring's (ani, cov) byte-equal to the JAX ppermute
    ring's and to the port's merge ring; every step ran the matmul step,
    the final copy-free one too."""
    ours, theirs = _packs()
    mesh = make_mesh(d, CPU)
    key = (d, full_grid)
    if key not in _JAX_RINGS:
        _JAX_RINGS[key] = jring.sharded_containment_allpairs(
            theirs, k=K, mesh=jax_make_mesh(d), full_grid=full_grid, ring_comm="ppermute")
    want = _JAX_RINGS[key]
    mm = _count_calls(monkeypatch, "ring_step_matmul_plain")
    merge = _count_calls(monkeypatch, "ring_step_plain")
    got = allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh, full_grid=full_grid, variant="matmul")
    n_steps = d if full_grid else allpairs.half_ring_steps(d)
    last_kept = sum(1 for a, b in allpairs.ring_schedule(d, not full_grid) if allpairs.ring_step_of(a, b, d) == n_steps - 1)
    assert mm[0] == d * (n_steps - 1) + last_kept
    assert merge[0] == 0
    by_merge = allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh, full_grid=full_grid, variant="merge")
    for x, y, z in zip(got, want, by_merge, strict=True):
        assert x.tobytes() == y.tobytes() == z.tobytes()


def test_ring_picks_the_step_from_v_pad_and_width(monkeypatch):
    """variant=None picks the step from the ring's v_pad and width: matmul
    on this containment ring, merge with the crossover at 0 and on a Mash
    ring (the JAX package's rule). An explicit matmul Mash ring and an
    unknown variant raise."""
    ours, _ = _packs()
    mesh = make_mesh(3, CPU)
    assert ring.pick_variant("containment", ring.matmul_ring_vocab_pad(ours.ids), ours.ids.shape[1]) == "matmul"
    mm = _count_calls(monkeypatch, "ring_step_matmul_plain")
    want = allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh)
    assert mm[0] == 3 + 3  # D = 3: both steps of the half ring on every position
    allpairs.ring_allpairs(ours, "mash", K, mesh)
    assert mm[0] == 3 + 3
    monkeypatch.setattr(ring, "MATMUL_MAX_VPAD_PER_WIDTH", 0)
    merge = _count_calls(monkeypatch, "ring_step_plain")
    got = allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh)
    assert mm[0] == 3 + 3 and merge[0] == 3 + 3
    for x, y in zip(got, want, strict=True):
        assert x.tobytes() == y.tobytes()
    with pytest.raises(ValueError, match="matmul ring variant supports"):
        allpairs.ring_allpairs(ours, "mash", K, mesh, variant="matmul")
    with pytest.raises(ValueError, match="expected merge"):
        allpairs.sharded_containment_allpairs(ours, k=K, mesh=mesh, variant="bogus")


def _table(wd: str, name: str) -> bytes:
    with open(f"{wd}/data_tables/{name}.csv", "rb") as f:
        return f.read()


@pytest.mark.parametrize("crossover", [None, 0], ids=["picked", "merge"])
def test_dereplicate_cli_on_mesh_with_matmul_variant_equals_jax_bytes(tmp_path, monkeypatch, crossover):
    """`dereplicate --mesh_shape 4 --device cpu` over one 80-genome
    cluster past the one-shot budget (cut to 2^12 in both packages): the
    cluster takes `mesh_ring`, whose steps run the matmul step (its v_pad
    is small beside its width; with the crossover at 0, the merge step),
    and Cdb, Ndb and Wdb are byte-identical to the JAX package's on the
    same argv."""
    gs, _ = planted_sketches(80, seed=9, s_bottom=200, s_scaled=300, cluster_size=80)
    (tmp_path / "genomes").mkdir()
    files = [str(tmp_path / "genomes" / g) for g in gs.names]
    for f in files:
        open(f, "wb").close()
    q = tmp_path / "q.csv"
    pd.DataFrame({"genome": gs.names, "completeness": 90 + np.arange(80) % 10,
                  "contamination": np.arange(80) % 5}).to_csv(q, index=False)
    wd, jwd = str(tmp_path / "torch"), str(tmp_path / "jax")
    save_sketch_cache(WorkDirectory(wd), gs)
    j = WorkDirectory(jwd)
    jax_save(j, JaxGenomeSketches(names=gs.names, gdb=gs.gdb, bottom=gs.bottom, scaled=gs.scaled,
                                  k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale))
    j.store_arguments("sketch", jax_sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, "splitmix64"))
    argv = ["-g", *files, "--genomeInfo", str(q), "--skip_plots", "-p", "1",
            "-ms", str(gs.sketch_size), "--mesh_shape", "4", "-l", "0"]
    monkeypatch.setattr("drep_tpu.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    monkeypatch.setattr("drep_tpu_torch.ops.containment.MATMUL_BUDGET_ELEMS", 1 << 12)
    if crossover is not None:
        monkeypatch.setattr(ring, "MATMUL_MAX_VPAD_PER_WIDTH", crossover)
    mm = _count_calls(monkeypatch, "ring_step_matmul_plain")
    before = dict(SECONDARY_PATH_COUNTS)
    torch_main(["dereplicate", wd, *argv, "--device", "cpu"])
    assert {p: c - before.get(p, 0) for p, c in SECONDARY_PATH_COUNTS.items() if c != before.get(p, 0)} == {
        "mesh_ring": 1}
    # D = 4, half ring: steps 0 and 1 on every position, the middle step on two
    assert mm[0] == (4 + 4 + 2 if crossover is None else 0)
    jax_main(["dereplicate", jwd, *argv])
    for table in ("Cdb", "Ndb", "Wdb"):
        assert _table(wd, table) == _table(jwd, table), table


# --- a numpy emulation of csrc/ring_step_mm.cu's stages (the block body of
# csrc/mm_block.cuh, which runs only on the card): the sparse producer's
# chunk walk, its clear and its scatter into the 128-byte-swizzled K-major
# layout, the consumers' wgmma descriptors read as the hardware reads
# them, and the accumulator fragments' map to the tile. The tuning
# constants are read from the header; a change to the block body's
# schedule or layout must be made here too.

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "drep_tpu_torch", "csrc")


def _mm_define(name: str) -> int:
    """A #define of the block body (mm_block.cuh) or of ring_step_mm.cu."""
    for src in ("mm_block.cuh", "ring_step_mm.cu"):
        with open(os.path.join(_CSRC, src)) as f:
            found = re.search(rf"#define {name} (\d+)", f.read())
        if found:
            return int(found.group(1))
    raise KeyError(name)


TM, KC, STAGES, CONSUMERS, LOG_IDS = (_mm_define(n) for n in ("TM", "KC", "STAGES", "CONSUMERS", "LOG_IDS"))
ATOM = TM * 128
SIDE = TM * KC
STAGE_SIZE = 2 * SIDE


def mm_swizzled(row, k):
    """mm_block.cuh::swizzled: the byte of (row, k) in one side of a stage."""
    return (k >> 7) * ATOM + (row >> 3) * 1024 + (row & 7) * 128 + ((((k >> 4) & 7) ^ (row & 7)) << 4) + (k & 15)


def gmma_desc(addr: int) -> int:
    """mm_block.cuh::gmma_desc."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)


def gmma_read(smem: np.ndarray, desc: int, rows: int) -> np.ndarray:
    """The [rows, 32] int8 operand wgmma reads through a K-major descriptor
    (CUTLASS's canonical form ((8, m), (T, 2)) : ((8T, SBO), (1, T)) in
    16-byte units under Swizzle<3,4,3>): row m at start + (m / 8) SBO +
    (m % 8) 128 bytes, then bits [4, 7) of the address XOR bits [7, 10)."""
    assert desc >> 62 == 1, "layout type B128"
    start = (desc & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    m = np.arange(rows)[:, None]
    lin = start + (m >> 3) * sbo + (m & 7) * 128 + np.arange(32)[None, :]
    return smem[lin ^ (((lin >> 7) & 7) << 4)].astype(np.int64)


def fragment_map(v: np.ndarray, lane: np.ndarray, w: np.ndarray):
    """(row, column) in a consumer's 64 x 128 sums of value v of a thread."""
    return 16 * w + (lane >> 2) + 8 * ((v >> 1) & 1), 8 * (v >> 2) + 2 * (lane & 3) + (v & 1)


def emulate_mm_block(a: np.ndarray, b: np.ndarray, v_pad: int, by: int, bx: int, z: int, per_split: int,
                     tile: np.ndarray, stats: dict) -> None:
    """One block of mm_block.cuh's sparse walk, consumers and epilogue on A
    rows `by` of `a` and B rows `bx` of `b` (ring_step_mm_kernel's, and the
    sparse indicator_mm kernels'): its partial sums added into `tile`
    [len(a), len(b)]. Each side's rows past its own count read as empty."""
    lo_id = z * per_split * KC
    hi_id = min(lo_id + per_split * KC, v_pad)
    rows = [[], []]
    for side, (m, blk) in enumerate(((a, by), (b, bx))):
        for t in range(TM):
            r = blk * TM + t
            rows[side].append([int(x) for x in m[r]] if r < m.shape[0] else [])
    cur = [[int(np.searchsorted(np.asarray(rw, np.int64), lo_id)) for rw in rows[side]] for side in (0, 1)]

    def id_at(side, t):
        c = cur[side][t]
        return rows[side][t][c] if c < len(rows[side][t]) else (1 << 31) - 1

    smem = np.zeros(STAGES * STAGE_SIZE, np.uint8)
    log = np.zeros((STAGES, 2, TM, LOG_IDS), np.int64)
    n_set = np.zeros((STAGES, 2, TM), np.int64)  # LOG_IDS + 1: more than the log holds
    acc = np.zeros((CONSUMERS, 64, 128), np.int64)
    stage, base = 0, lo_id
    while True:
        # produce<stage>: the chunk the walk stands at if both sides touch it, else a jump
        live = False
        while base < hi_id:
            end = min(base + KC, hi_id)
            if min(id_at(0, t) for t in range(TM)) < end and min(id_at(1, t) for t in range(TM)) < end:
                live = True
                break
            stats["jumps"] += 1
            lo = max(min(id_at(side, t) for t in range(TM)) for side in (0, 1))
            if lo >= hi_id:
                break
            base = lo - lo % KC
            for side in (0, 1):
                for t in range(TM):
                    while id_at(side, t) < base:
                        cur[side][t] += 1
        st = stage * STAGE_SIZE
        for side in (0, 1):
            side_base = st + side * SIDE
            for t in range(TM):
                if n_set[stage, side, t] > LOG_IDS:  # the row's two 128-byte lines
                    stats["line_clears"] += 1
                    for h in range(KC // 128):
                        line = side_base + h * ATOM + (t >> 3) * 1024 + (t & 7) * 128
                        smem[line : line + 128] = 0
                else:
                    for k in log[stage, side, t, : n_set[stage, side, t]]:
                        smem[side_base + mm_swizzled(t, k)] = 0
                n = 0
                while live and id_at(side, t) < end:
                    k = id_at(side, t) - base
                    smem[side_base + mm_swizzled(t, k)] = 1
                    if n < LOG_IDS:
                        log[stage, side, t, n] = k
                    n += 1
                    cur[side][t] += 1
                n_set[stage, side, t] = min(n, LOG_IDS + 1)
        # the stage holds exactly this chunk's bytes (none, when no chunk is
        # left): the clear left nothing behind
        held = np.zeros(STAGE_SIZE, np.uint8)
        for side in (0, 1):
            for t in range(TM):
                ks = [x - base for x in rows[side][t] if live and base <= x < end]
                held[side * SIDE + mm_swizzled(t, np.asarray(ks, np.int64))] = 1
        np.testing.assert_array_equal(smem[st : st + STAGE_SIZE], held)
        # the consumers multiply every stage handed to them, the last (all 0) too
        for g in range(CONSUMERS):
            for s in range(KC // 32):
                k_off = (s >> 2) * ATOM + (s & 3) * 32
                acc[g] += gmma_read(smem, gmma_desc(st + g * 8 * 1024 + k_off), 64) @ gmma_read(
                    smem, gmma_desc(st + SIDE + k_off), 128).T
        if not live:
            break
        base += KC
        stats["chunks"] += 1
        stage = (stage + 1) % STAGES
    v, lane, w = np.meshgrid(np.arange(64), np.arange(32), np.arange(4), indexing="ij")
    row, col = fragment_map(v, lane, w)
    for g in range(CONSUMERS):
        ri = by * TM + 64 * g + row
        cj = bx * TM + col
        keep = (ri < tile.shape[0]) & (cj < tile.shape[1])  # the epilogue's rows, cols (ld = cols)
        np.add.at(tile, (ri[keep], cj[keep]), acc[g][row[keep], col[keep]])


def mm_splits(n_local: int, v_pad: int, target: int) -> tuple[int, int]:
    """ring_step_mm_launch's vocabulary splits (mm_block.cuh::mm_splits,
    TARGET_BLOCKS over its tiles x tiles grid): (splits, chunks a split)."""
    tiles = -(-n_local // TM)
    n_chunks = -(-v_pad // KC)
    splits = min(-(-target // (tiles * tiles)), max(1, n_chunks // _mm_define("MIN_CHUNKS")))
    per_split = -(-n_chunks // splits)
    return -(-n_chunks // per_split), per_split


def emulate_ring_step_mm(a: np.ndarray, b: np.ndarray, v_pad: int, per_split: int, stats: dict) -> np.ndarray:
    n_local = a.shape[0]
    tiles = -(-n_local // TM)
    splits = -(-(-(-v_pad // KC)) // per_split)
    tile = np.zeros((n_local, n_local), np.int64)
    for z in range(splits):
        for by in range(tiles):
            for bx in range(tiles):
                emulate_mm_block(a, b, v_pad, by, bx, z, per_split, tile, stats)
    return tile.astype(np.int32)


def test_mm_fragment_map_is_cutlass_accumulator_layout():
    """The epilogue's (row, column) of each of a warpgroup's 128 x 64 int32
    sums is CUTLASS's CLayout_64xN for N = 128 (thread (4, 8, 4) : (128, 1,
    16), value (2, 2, 16) : (64, 8, 512) into a column-major 64 x 128 tile),
    and covers the tile once."""
    v, lane, w = np.meshgrid(np.arange(64), np.arange(32), np.arange(4), indexing="ij")
    row, col = fragment_map(v, lane, w)
    idx = 128 * (lane & 3) + (lane >> 2) + 16 * w + 64 * (v & 1) + 8 * ((v >> 1) & 1) + 512 * (v >> 2)
    np.testing.assert_array_equal(row, idx % 64)
    np.testing.assert_array_equal(col, idx // 64)
    assert len(np.unique(row * 128 + col)) == 64 * 128


def test_mm_swizzle_and_descriptors_read_back_the_staged_rows():
    """Bytes scattered at mm_swizzled(row, k) come back, through every
    k-step's descriptor of both operands, as the logical [rows, 32] slices;
    the layout is a bijection onto one side of a stage."""
    rows, k = np.meshgrid(np.arange(TM), np.arange(KC), indexing="ij")
    addr = mm_swizzled(rows, k)
    assert sorted(addr.ravel().tolist()) == list(range(SIDE))
    rng = np.random.default_rng(3)
    logical = rng.integers(-128, 128, size=(2, TM, KC)).astype(np.int8)
    for stage in range(STAGES):
        st = stage * STAGE_SIZE
        smem = np.zeros(STAGES * STAGE_SIZE, np.uint8)
        for side in (0, 1):
            smem[st + side * SIDE + addr] = logical[side].view(np.uint8)
        for s in range(KC // 32):
            k_off = (s >> 2) * ATOM + (s & 3) * 32
            for g in range(CONSUMERS):
                got = gmma_read(smem, gmma_desc(st + g * 8 * 1024 + k_off), 64).astype(np.uint8).view(np.int8)
                np.testing.assert_array_equal(got, logical[0, 64 * g : 64 * g + 64, 32 * s : 32 * s + 32])
            got = gmma_read(smem, gmma_desc(st + SIDE + k_off), 128).astype(np.uint8).view(np.int8)
            np.testing.assert_array_equal(got, logical[1, :, 32 * s : 32 * s + 32])


@pytest.mark.parametrize("n_local,width,v_pad,per_split", [
    (150, 24, 1152, 1), (150, 24, 1152, 2), (150, 24, 1152, 5), (129, 24, 2048, 8), (40, 24, 640, 3),
    (130, 160, 1152, 5),
])
def test_mm_schedule_equals_plain(n_local, width, v_pad, per_split):
    """The emulated kernel over every block (rows past n_local masked, in-
    row repeats counted once, empty rows, chunks skipped where one side of
    a tile has no id, a stage reused after its clear: of the logged bytes,
    or of whole row lines where a row set more than LOG_IDS) equals
    ring_step_matmul_plain."""
    rng = np.random.default_rng(n_local + per_split)
    a = _rows(rng, n_local, width, v_pad, repeats=True)
    b = _rows(rng, n_local, width, v_pad, repeats=False)
    # a chunk of the vocabulary that only A touches, so a walk over it jumps
    b = np.where((b >= KC) & (b < 2 * KC), PAD, b)
    b = np.sort(b, axis=1).astype(np.int32)
    stats = {"chunks": 0, "jumps": 0, "line_clears": 0}
    got = emulate_ring_step_mm(a, b, v_pad, per_split, stats)
    np.testing.assert_array_equal(got, _plain_mm(a, b, v_pad))
    assert stats["chunks"] > 0
    assert stats["jumps"] > 0
    if width > 100:  # rows that set more than LOG_IDS bytes of a chunk
        assert stats["line_clears"] > 0


@pytest.mark.parametrize("n_local,v_pad", [(500, 1 << 26), (325, 1 << 22), (256, 1 << 20), (128, 1 << 20),
                                           (1, 128), (129, 128 * 3)])
def test_mm_splits_cover_the_vocabulary_once(n_local, v_pad):
    """The launcher's splits tile [0, v_pad) in whole chunks, every split
    non-empty."""
    splits, per = mm_splits(n_local, v_pad, _mm_define("TARGET_BLOCKS"))
    n_chunks = -(-v_pad // KC)
    assert (splits - 1) * per < n_chunks <= splits * per
