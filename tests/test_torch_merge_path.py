"""A numpy rehearsal of the lane schedules of the port's merge-path kernels
(drep_tpu_torch/csrc/merge_path.cuh, pair_block.cuh, mash_shared.cu,
intersect.cu, ring_step.cu), which run only on the card.

The emulation below is written here, not in the package: it follows the
device code step by step — each lane's binary search on its diagonal of
the merge path, its share merged with the same tie rule, the boundary
compare with the previous lane's last element (the shuffle), the rows'
real lengths by binary search, the warp scan of distinct counts, the Mash
rounds and their early exit, the per-warp windows of wide rows, and the
blocks' cut of the output tiles — and every read goes through a bounds
check, so an index the kernel must not touch fails here.
The ring step's containment walk (warp_contained, its rounds over
per-warp windows, the warp search that cuts B after A's last id) and the
ring's block cut of n_local rows (rows past it masked) are emulated too.
It is held against ops/mash.py::mash_shared_plain,
ops/intersect.py::intersect_stacked_plain and
ops/ring.py::contained_counts_plain, and through them against the JAX
references drep_tpu/ops/minhash.py::_pair_shared,
drep_tpu/ops/pallas_merge.py::_intersect_tile_jnp and
drep_tpu/ops/containment.py::_pair_intersection. Counts are integers:
every comparison is exact.

Only the tuning constants (MASH_E and the staging plan's) are read from
the CUDA sources. A change to the schedule in merge_path.cuh,
pair_block.cuh, mash_shared.cu, intersect.cu or ring_step.cu (the tie
rule, the share and window sizes, the round carry, the block cut) must be
made in this emulation too: no test here can see the device code drift
from it, only chip_smoke.py's edge cases on the card can.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drep_tpu.ops.containment import _pair_intersection as jax_pair_intersection
from drep_tpu.ops.minhash import _pair_shared as jax_pair_shared
from drep_tpu.ops.pallas_merge import _intersect_tile_jnp
from drep_tpu_torch.ops import intersect as ti
from drep_tpu_torch.ops import mash, ring
from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, widen_ids

PAD = int(PAD_ID)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "drep_tpu_torch", "csrc")


def _kernel_define(name: str, source: str) -> int:
    with open(os.path.join(CSRC, source)) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


KERNEL_E = _kernel_define("MASH_E", "pair_block.cuh")  # merged ids a lane a round


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Row:
    """A row as a kernel reads it: `data` from `off`, every read checked
    against the buffer's bounds (negative indices do not wrap)."""

    def __init__(self, data: list, off: int = 0):
        self.data, self.off = data, off

    def __getitem__(self, k: int) -> int:
        x = self.off + k
        assert 0 <= x < len(self.data), f"read {x} outside [0, {len(self.data)})"
        return self.data[x]


def staged(row: np.ndarray) -> list:
    """A row staged in shared memory: pitch (width + 4) & ~3, PAD after."""
    width = len(row)
    return [int(v) for v in row] + [PAD] * (((width + 4) & ~3) - width)


def real_len(row: Row, width: int) -> int:
    lo, hi = 0, width
    while lo < hi:
        mid = (lo + hi) >> 1
        if row[mid] == PAD:
            hi = mid
        else:
            lo = mid + 1
    return lo


def split(a: Row, b: Row, d: int, lo: int, hi: int) -> int:
    """merge_path_split: the A ids among the first d merged (A first on ties)."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def lane_merge(a: Row, b: Row, i: int, j: int, n: int):
    """n merge_steps from the split (i, j), A first on ties: (values, i, j)."""
    va, vb = a[i], b[j]
    out = []
    for _ in range(n):
        ta = va <= vb
        out.append(va if ta else vb)
        i, j = i + ta, j + (not ta)
        nx = a[i] if ta else b[j]
        va, vb = (nx, vb) if ta else (va, nx)
    return out, i, j


def shfl_up(vals: list, k: int = 1) -> list:
    """__shfl_up_sync: lane l gets lane l - k's value, lanes < k their own."""
    return [vals[lane - k] if lane >= k else vals[lane] for lane in range(32)]


def emulate_warp_merge_dups(a: Row, la: int, b: Row, lb: int) -> int:
    total = la + lb
    share = (total + 31) >> 5
    firsts, lasts, ns, dups = [], [], [], []
    for lane in range(32):
        d = min(lane * share, total)
        n = min(share, total - d)
        i = split(a, b, d, max(0, d - lb), min(d, la))
        vals, _, _ = lane_merge(a, b, i, d - i, n)
        firsts.append(vals[0] if n else 0)
        lasts.append(vals[-1] if n else 0)
        ns.append(n)
        dups.append(sum(vals[k] == vals[k - 1] for k in range(1, n)))
    before = shfl_up(lasts)
    return sum(dups[lane] + (lane > 0 and ns[lane] > 0 and firsts[lane] == before[lane]) for lane in range(32))


def emulate_warp_mash_shared(la: int, lb: int, s_use: int, window, e: int, trace=None) -> int:
    """warp_mash_shared<E>: rounds of 32 e merged ids. `window(i0, j0, ra,
    rb)` returns the round's two rows; `trace` collects (round start, rank
    after the round)."""
    r = 32 * e
    total = la + lb
    round0 = i0 = rank = carry = 0
    shared = [0] * 32
    while round0 < total and rank <= s_use:
        j0 = round0 - i0
        ra, rb = la - i0, lb - j0
        a, b = window(i0, j0, ra, rb)
        rlen = min(r, ra + rb)
        firsts, lasts, ns, ends, dupm = [], [], [], [], []
        for lane in range(32):
            d = min(lane * e, rlen)
            n = min(e, rlen - d)
            i = split(a, b, d, max(0, d - rb), min(d, ra))
            vals, i_end, _ = lane_merge(a, b, i, d - i, n)
            dup = 0
            for k in range(1, n):
                dup |= (vals[k] == vals[k - 1]) << k
            firsts.append(vals[0] if n else 0)
            lasts.append(vals[-1] if n else 0)
            ns.append(n)
            ends.append(i_end)
            dupm.append(dup)
        before = shfl_up(lasts)
        before[0] = carry
        dist, cnt = [], []
        for lane in range(32):
            if ns[lane] > 0 and (lane > 0 or round0 > 0) and firsts[lane] == before[lane]:
                dupm[lane] |= 1
            live = (1 << ns[lane]) - 1
            dist.append(live & ~dupm[lane])
            cnt.append(bin(dist[-1]).count("1"))
        incl = list(np.cumsum(cnt))
        for lane in range(32):
            base = rank + int(incl[lane]) - cnt[lane]
            if base + cnt[lane] <= s_use:
                shared[lane] += bin(dupm[lane]).count("1")
            elif base <= s_use:
                cum = base
                for k in range(e):
                    cum += (dist[lane] >> k) & 1
                    shared[lane] += ((dupm[lane] >> k) & 1) and cum <= s_use
        rank += int(incl[31])
        carry = lasts[31]
        i0 += ends[31]
        round0 += r
        if trace is not None:
            trace.append((round0 - r, rank))
    return sum(shared)


def staged_window(a_st: list, b_st: list):
    return lambda i0, j0, ra, rb: (Row(a_st, i0), Row(b_st, j0))


def copied_window(a_row: np.ndarray, b_row: np.ndarray, e: int):
    """The wide-row path: per round, a fresh window of 32 e + 1 ids of each
    row (PAD past its real ids), read from the global row with bounds checked."""
    win = 32 * e + 1
    ga, gb = Row([int(v) for v in a_row]), Row([int(v) for v in b_row])

    def window(i0, j0, ra, rb):
        wa = [ga[i0 + q] if q < ra else PAD for q in range(win)]
        wb = [gb[j0 + q] if q < rb else PAD for q in range(win)]
        return Row(wa), Row(wb)

    return window


def emulate_mash(a: np.ndarray, na: np.ndarray, b: np.ndarray, nb: np.ndarray, s_orig: int, e: int,
                 windowed: bool) -> np.ndarray:
    width = a.shape[1]
    out = np.zeros((a.shape[0], b.shape[0]), np.int32)
    for r in range(a.shape[0]):
        a_st = staged(a[r])
        la = real_len(Row(a_st), width)
        for c in range(b.shape[0]):
            b_st = staged(b[c])
            lb = real_len(Row(b_st), width)
            s_use = min(int(na[r]), int(nb[c]), s_orig)
            if s_use <= 0:
                continue
            window = copied_window(a[r], b[c], e) if windowed else staged_window(a_st, b_st)
            out[r, c] = emulate_warp_mash_shared(la, lb, s_use, window, e)
    return out


def emulate_intersect_stacked(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[R, rows, W] int32 buckets -> summed counts, one warp a pair a bucket."""
    width = a.shape[2]
    out = np.zeros((a.shape[1], b.shape[1]), np.int32)
    for r in range(a.shape[0]):
        for i in range(a.shape[1]):
            a_st = staged(a[r, i])
            la = real_len(Row(a_st), width)
            for j in range(b.shape[1]):
                b_st = staged(b[r, j])
                out[i, j] += emulate_warp_merge_dups(Row(a_st), la, Row(b_st), real_len(Row(b_st), width))
    return out


def plain_mash(a, na, b, nb, s_orig):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (a, na, b, nb)]
    return mash.mash_shared_plain(*t, s_orig=s_orig).numpy()


def plain_intersect(a, b):
    return ti.intersect_stacked_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()


_jax_pairs = jax.jit(jax.vmap(jax.vmap(lambda x, y, nx, ny: jax_pair_shared(x, y, nx, ny)[0],
                                       in_axes=(None, 0, None, 0)), in_axes=(0, None, 0, None)))


_jax_intersect = jax.jit(_intersect_tile_jnp)
JAX_ROWS = 8  # every case's rows, padded to one shape: one compile a width


def _pad_rows(x: np.ndarray, fill) -> np.ndarray:
    """x with PAD rows (or `fill` counts) after it, to JAX_ROWS rows."""
    pad = np.full((JAX_ROWS - x.shape[0], *x.shape[1:]), fill, x.dtype)
    return np.concatenate([x, pad])


def jax_mash(a, na, b, nb):
    """_pair_shared over every pair (its s_orig is the row width)."""
    got = _jax_pairs(*(jnp.asarray(_pad_rows(x, f)) for x, f in ((a, PAD), (b, PAD), (na, 0), (nb, 0))))
    return np.asarray(got)[: a.shape[0], : b.shape[0]]


def jax_intersect(a, b):
    """_intersect_tile_jnp over one bucket's [rows, W] tiles."""
    return np.asarray(_jax_intersect(jnp.asarray(_pad_rows(a, PAD)), jnp.asarray(_pad_rows(b, PAD))))[
        : a.shape[0], : b.shape[0]]


def rows_of(lists, width: int) -> np.ndarray:
    out = np.full((len(lists), width), PAD, np.int32)
    for r, x in enumerate(lists):
        out[r, : len(x)] = np.sort(np.asarray(x, np.int64)).astype(np.int32)
    return out


def mash_case(name: str, rng: np.random.Generator):
    """(A, counts A, B, counts B) of one named case, width 64."""
    w = 64
    if name == "distinct":
        rows = [rng.choice(120, size=int(rng.integers(20, w + 1)), replace=False) for _ in range(6)]
    elif name == "a_equals_b":  # every id tied across the two rows
        rows = [np.arange(0, 2 * w, 2)[: int(rng.integers(30, w + 1))] for _ in range(4)]
    elif name == "repeats":  # runs of p copies in A and q in B
        rows = [np.repeat(rng.choice(40, size=12, replace=False), rng.integers(1, 6, size=12))[:w]
                for _ in range(6)]
    elif name == "empty_one_allpad":
        rows = [[], [5], [7], list(range(0, 64, 1)), list(range(3, 40, 3)), []]
    elif name == "ties_across_splits":  # long runs of one id straddle every lane's share
        rows = [np.repeat([1, 2, 3, 9], [17, 1, 33, 13])[:w], np.repeat([1, 3, 4], [20, 30, 14]),
                np.repeat([2, 3], [31, 33])]
    else:
        raise ValueError(name)
    ids = rows_of(rows, w)
    counts = (ids != PAD).sum(axis=1).astype(np.int32)
    if name == "empty_one_allpad":
        ids[5] = PAD  # an all-PAD row with a count
        counts[5] = 9
    return ids, counts, ids[::-1].copy(), counts[::-1].copy()


MASH_CASES = ["distinct", "a_equals_b", "repeats", "empty_one_allpad", "ties_across_splits"]


@pytest.mark.parametrize("e", sorted({KERNEL_E, 3, 2}))
@pytest.mark.parametrize("windowed", [False, True], ids=["staged", "windowed"])
@pytest.mark.parametrize("case", MASH_CASES)
def test_mash_schedule_equals_plain_and_jax(case, windowed, e):
    rng = np.random.default_rng(MASH_CASES.index(case))
    a, na, b, nb = mash_case(case, rng)
    w = a.shape[1]
    got = emulate_mash(a, na, b, nb, w, e, windowed)
    np.testing.assert_array_equal(got, plain_mash(a, na, b, nb, w))
    np.testing.assert_array_equal(got, jax_mash(a, na, b, nb))


@pytest.mark.parametrize("e", sorted({KERNEL_E, 3, 2}))
def test_mash_s_use_at_every_lane_and_round_boundary(e):
    """s_orig swept over every rank of the pair's walk, so s_use lands on,
    just before and just after each lane's share and each round's end;
    distinct rows, rows with ties across A and B, and in-row repeats."""
    rng = np.random.default_rng(40 + e)
    a_ids = np.sort(rng.choice(300, size=100, replace=False))
    b_ids = np.sort(np.concatenate([a_ids[::3], rng.choice(np.arange(300, 400), size=40, replace=False)]))
    rep = np.repeat(a_ids[:40], rng.integers(1, 4, size=40))[:100]
    ids = rows_of([a_ids, b_ids, rep], 104)
    counts = (ids != PAD).sum(axis=1).astype(np.int32)
    total = int(counts[0] + counts[1])
    pairs = [(0, 1), (1, 0), (2, 2), (0, 2)]
    for s_orig in range(1, total + 2):
        want = plain_mash(ids, counts, ids, counts, s_orig)
        for r, c in pairs:
            got = emulate_mash(ids[r : r + 1], counts[r : r + 1], ids[c : c + 1], counts[c : c + 1], s_orig, e,
                               windowed=False)
            assert got[0, 0] == want[r, c], f"pair {(r, c)}, s_orig {s_orig}"
    # the rounds stop after the first round whose end passes s_use
    trace = []
    a_st, b_st = staged(ids[0]), staged(ids[1])
    emulate_warp_mash_shared(int(counts[0]), int(counts[1]), 70, staged_window(a_st, b_st), e, trace)
    assert trace[-1][1] > 70 or trace[-1][0] + 32 * e >= total
    assert all(rank <= 70 for _, rank in trace[:-1])


def test_mash_counts_below_real_length():
    """Counts below a row's real ids (the packer's sketch_size cut) set
    s_use; the walk still merges the whole rows."""
    rng = np.random.default_rng(7)
    ids = rows_of([rng.choice(200, size=int(rng.integers(30, 64)), replace=False) for _ in range(6)], 64)
    real = (ids != PAD).sum(axis=1)
    counts = (real - rng.integers(1, 25, size=6)).astype(np.int32)
    counts[0] = 0
    for windowed in (False, True):
        got = emulate_mash(ids, counts, ids, counts, 64, KERNEL_E, windowed)
        np.testing.assert_array_equal(got, plain_mash(ids, counts, ids, counts, 64))
        np.testing.assert_array_equal(got, jax_mash(ids, counts, ids, counts))


def intersect_case(name: str, rng: np.random.Generator) -> np.ndarray:
    """[R, rows, 64] int32 buckets of one named case."""
    w = 64
    if name == "distinct":
        rows = [rng.choice(150, size=int(rng.integers(0, w + 1)), replace=False) for _ in range(7)]
    elif name == "a_equals_b":
        rows = [np.arange(0, 3 * w, 3)[: int(rng.integers(1, w + 1))] for _ in range(4)]
    elif name == "repeats":
        rows = [np.repeat(rng.choice(30, size=16, replace=False), rng.integers(1, 5, size=16))[:w]
                for _ in range(6)]
    elif name == "empty_one_allpad":
        rows = [[], [5], [5], list(range(64)), []]
    elif name == "ties_across_splits":
        rows = [np.repeat([4, 8], [31, 33]), np.repeat([4, 8, 9], [1, 32, 31]), np.repeat([8], [64])]
    else:
        raise ValueError(name)
    return rows_of(rows, w)[None]


@pytest.mark.parametrize("case", MASH_CASES)
def test_intersect_schedule_equals_plain_and_jax(case):
    rng = np.random.default_rng(60 + MASH_CASES.index(case))
    a = intersect_case(case, rng)
    b = a[:, ::-1].copy()
    got = emulate_intersect_stacked(a, b)
    np.testing.assert_array_equal(got, plain_intersect(a, b))
    np.testing.assert_array_equal(got, jax_intersect(a[0], b[0]))


def test_intersect_every_share_length():
    """Merged lengths 1..2 x 64 + 1, so every share size and every lane
    boundary position occurs, with ties across A and B."""
    a_full = np.arange(0, 128, 2)
    b_full = np.arange(0, 128, 3)
    for la in range(0, 65, 3):
        for lb in range(0, 43, 2):
            a = rows_of([a_full[:la]], 64)[None]
            b = rows_of([b_full[:lb]], 64)[None]
            np.testing.assert_array_equal(emulate_intersect_stacked(a, b), plain_intersect(a, b))


def test_intersect_uint16_buckets_summed():
    """Three stacked uint16 buckets (0xFFFF padding), widened as the wrapper
    does before the kernel; the counts add over the buckets."""
    rng = np.random.default_rng(9)
    buckets = []
    for r in range(3):
        rows = [rng.choice(1000, size=int(rng.integers(0, 40)), replace=False) + 1000 * r for _ in range(5)]
        buckets.append(rows_of(rows, 64))
    st = np.stack(buckets)
    st16 = np.where(st == PAD, U16_PAD, st).astype(np.uint16)
    wide = widen_ids(torch.from_numpy(st16)).numpy()
    np.testing.assert_array_equal(wide, st)
    got = emulate_intersect_stacked(wide, wide)
    np.testing.assert_array_equal(got, plain_intersect(st, st))
    want = sum(jax_intersect(st[r], st[r]) for r in range(3))
    np.testing.assert_array_equal(got, want)


def block_writes(rows_a: int, rows_b: int, symmetric: bool, sub: int):
    """The kernels' cut of the output into blocks of sub x sub pairs: (out
    rows, out cols, A rows, B rows), one entry per pair over every block id."""
    tile = 128
    ta, tb = rows_a // tile, rows_b // tile
    per_tile = tile // sub
    grid_x = (ta // 2 + 1 if symmetric else tb) * per_tile
    bid = np.arange(grid_x * ta * per_tile)
    bx, by = bid % grid_x, bid // grid_x
    i_tile, jj = by // per_tile, bx // per_tile
    b_tile = (i_tile + jj) % ta if symmetric else jj
    a0 = i_tile * tile + (by % per_tile) * sub
    b0 = b_tile * tile + (bx % per_tile) * sub
    col0 = jj * tile + (bx % per_tile) * sub
    r, c = np.meshgrid(np.arange(sub), np.arange(sub), indexing="ij")
    return tuple((x[:, None, None] + y[None]).ravel() for x, y in ((a0, r), (col0, c), (a0, r), (b0, c)))


@pytest.mark.parametrize("sub", [1, 4, 8, 16])
@pytest.mark.parametrize("tiles", [(1, 1), (2, 2), (3, 3), (2, 3)])
def test_block_grid_writes_each_layout(sub, tiles):
    ta, tb = tiles
    n_a, n_b = 128 * ta, 128 * tb
    pair_id = np.arange(n_a * n_b, dtype=np.int64).reshape(n_a, n_b)
    layouts = [(False, pair_id)]
    if ta == tb:
        layouts.append((True, mash._wrap_symmetric_plain(torch.from_numpy(pair_id)).numpy()))
    for symmetric, want in layouts:
        rows, cols, i, j = block_writes(n_a, n_b, symmetric, sub)
        assert rows.size == want.size  # with every output right below: each written once
        got = np.full_like(want, -1)
        got[rows, cols] = i * n_b + j
        np.testing.assert_array_equal(got, want)


def emulate_warp_lower_bound(row: Row, n: int, x: int) -> int:
    """warp_lower_bound: 32 evenly spaced probes a pass; the lanes below x
    must be a prefix (the ballot's count)."""
    lo, hi = 0, n
    while lo < hi:
        step = (hi - lo + 31) >> 5
        below = [row[min(lo + (lane + 1) * step - 1, hi - 1)] < x for lane in range(32)]
        c = sum(below)
        assert below == [True] * c + [False] * (32 - c)
        new_lo = lo if c == 0 else min(lo + c * step, hi)
        hi = hi if c == 32 else min(lo + (c + 1) * step - 1, hi - 1)
        lo = new_lo
    return lo


def contained_steps(a: Row, b: Row, i: int, j: int, n: int) -> tuple[int, int]:
    """n contained steps from (i, j), A first on ties: (hits, A position)."""
    va, vb = a[i], b[j]
    hits = 0
    for _ in range(n):
        hits += va == vb
        ta = va <= vb
        i, j = i + ta, j + (not ta)
        nx = a[i] if ta else b[j]
        va, vb = (nx, vb) if ta else (va, nx)
    return hits, i


def emulate_warp_contained(a: Row, la: int, b: Row, lb: int) -> int:
    total = la + lb
    share = (total + 31) >> 5
    hits = 0
    for lane in range(32):
        d = min(lane * share, total)
        n = min(share, total - d)
        i = split(a, b, d, max(0, d - lb), min(d, la))
        hits += contained_steps(a, b, i, d - i, n)[0]
    return hits


def emulate_warp_contained_rounds(la: int, lb: int, window, e: int) -> int:
    r = 32 * e
    total = la + lb
    round0 = i0 = hits = 0
    while round0 < total:
        j0 = round0 - i0
        ra, rb = la - i0, lb - j0
        a, b = window(i0, j0)
        rlen = min(r, ra + rb)
        ends = []
        for lane in range(32):
            d = min(lane * e, rlen)
            n = min(e, rlen - d)
            i = split(a, b, d, max(0, d - rb), min(d, ra))
            h, i_end = contained_steps(a, b, i, d - i, n)
            hits += h
            ends.append(i_end)
        i0 += ends[31]
        round0 += r
    return hits


def contained_window(a_row: np.ndarray, la: int, b_row: np.ndarray, lb: int, e: int):
    """The wide rows' windows: A's ids PAD past la; B's real ids past the
    walk's cut (the heads it reads), PAD past lb."""
    win = 32 * e + 1
    ga, gb = Row([int(v) for v in a_row]), Row([int(v) for v in b_row])

    def window(i0, j0):
        wa = [ga[i0 + q] if q < la - i0 else PAD for q in range(win)]
        wb = [gb[j0 + q] if q < lb - j0 else PAD for q in range(win)]
        return Row(wa), Row(wb)

    return window


def emulate_contained(a: np.ndarray, b: np.ndarray, e: int, windowed: bool) -> np.ndarray:
    """pair_block's KIND_CONTAINED over every pair: real lengths, the cut
    of B at its first id >= A's last, then the walk."""
    width = a.shape[1]
    out = np.zeros((a.shape[0], b.shape[0]), np.int32)
    for r in range(a.shape[0]):
        a_st = staged(a[r])
        la = real_len(Row(a_st), width)
        for c in range(b.shape[0]):
            b_st = staged(b[c])
            lb = real_len(Row(b_st), width)
            if la == 0 or lb == 0:
                continue
            brow = Row([int(v) for v in b[c]]) if windowed else Row(b_st)
            cut = emulate_warp_lower_bound(brow, lb, a_st[la - 1])
            if windowed:
                out[r, c] = emulate_warp_contained_rounds(la, cut, contained_window(a[r], la, b[c], lb, e), e)
            else:
                out[r, c] = emulate_warp_contained(Row(a_st), la, Row(b_st), cut)
    return out


_jax_contained = jax.jit(jax.vmap(jax.vmap(jax_pair_intersection, in_axes=(None, 0)), in_axes=(0, None)))


def jax_contained(a, b):
    return np.asarray(_jax_contained(jnp.asarray(_pad_rows(a, PAD)), jnp.asarray(_pad_rows(b, PAD))))[
        : a.shape[0], : b.shape[0]]


def contained_case(name: str, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(A, B) of one named case, width 64: ids may repeat in either row."""
    w = 64
    if name == "distinct":
        rows = [rng.choice(120, size=int(rng.integers(1, w + 1)), replace=False) for _ in range(7)]
    elif name == "repeats_in_a":
        rows = [np.repeat(rng.choice(40, size=16, replace=False), rng.integers(1, 5, size=16))[:w]
                for _ in range(5)]
        return rows_of(rows, w), rows_of([rng.choice(40, size=25, replace=False) for _ in range(5)], w)
    elif name == "repeats_in_b":
        rows = [np.repeat(rng.choice(40, size=16, replace=False), rng.integers(1, 5, size=16))[:w]
                for _ in range(5)]
        return rows_of([rng.choice(40, size=25, replace=False) for _ in range(5)], w), rows_of(rows, w)
    elif name == "repeats_both":
        rows = [np.repeat(rng.choice(30, size=16, replace=False), rng.integers(1, 5, size=16))[:w]
                for _ in range(6)]
    elif name == "empty_one_allpad":
        rows = [[], [5], [5], list(range(64)), [], list(range(3, 40, 3))]
    elif name == "ties_across_splits":
        rows = [np.repeat([4, 8], [31, 33]), np.repeat([4, 8, 9], [1, 32, 31]), np.repeat([8], [64]),
                np.repeat([1, 8, 90], [2, 2, 60])]
    elif name == "b_past_a":  # B's tail past A's last id, and A past B's last
        rows = [np.arange(0, 20), np.arange(10, 74), np.arange(60, 64), np.arange(0, 128, 2)]
    else:
        raise ValueError(name)
    ids = rows_of(rows, w)
    return ids, ids[::-1].copy()


CONTAINED_CASES = ["distinct", "repeats_in_a", "repeats_in_b", "repeats_both", "empty_one_allpad",
                   "ties_across_splits", "b_past_a"]


@pytest.mark.parametrize("e", sorted({KERNEL_E, 3, 2}))
@pytest.mark.parametrize("windowed", [False, True], ids=["staged", "windowed"])
@pytest.mark.parametrize("case", CONTAINED_CASES)
def test_contained_schedule_equals_plain_and_jax(case, windowed, e):
    """The ring step's containment walk, each copy of an A id found in B
    counted, against contained_counts_plain and the JAX _pair_intersection."""
    rng = np.random.default_rng(80 + CONTAINED_CASES.index(case))
    a, b = contained_case(case, rng)
    got = emulate_contained(a, b, e, windowed)
    np.testing.assert_array_equal(got, ring.contained_counts_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(got, jax_contained(a, b))


def test_contained_every_share_length():
    """Merged lengths over every share size and lane boundary, with ties
    across A and B and B running past A's last id."""
    a_full = np.arange(0, 128, 2)
    b_full = np.arange(0, 192, 3)
    for la in range(1, 65, 3):
        for lb in range(1, 65, 4):
            a, b = rows_of([a_full[:la]], 64), rows_of([b_full[:lb]], 64)
            want = ring.contained_counts_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            np.testing.assert_array_equal(emulate_contained(a, b, KERNEL_E, windowed=False), want)


def test_warp_lower_bound_every_position():
    """The warp search against searchsorted at every x over rows of every
    length up to 3 passes, with repeated ids."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 31, 32, 33, 100, 1023, 1024, 1025, 2000):
        row = np.sort(rng.integers(0, 3 * n, size=n))
        for x in range(-1, 3 * n + 2, max(1, n // 50)):
            assert emulate_warp_lower_bound(Row([int(v) for v in row]), n, x) == np.searchsorted(row, x)


def _header_define(name: str) -> int:
    return _kernel_define(name, "pair_block.cuh")


def pair_block_plan(width: int) -> tuple[int, bool]:
    """pair_block.cuh::pair_block_plan: (rows a block takes, staged whole)."""
    stage, head = 96 * 1024, _header_define("HEAD_INTS")
    with open(os.path.join(CSRC, "pair_block.cuh")) as f:
        assert re.search(r"#define STAGE_BYTES \(96 \* 1024\)", f.read())
    stride = (width + 4) & ~3
    s = _header_define("MAX_SUB")
    while s >= _header_define("MIN_SUB") and 2 * s * stride * 4 + head * 4 > stage:
        s >>= 1
    staged_whole = s >= _header_define("MIN_SUB")
    return (s if staged_whole else _header_define("WINDOW_SUB")), staged_whole


@pytest.mark.parametrize("width,sub,staged_whole", [
    (1000, 8, True), (2048, 4, True), (3000, 4, True), (4096, 8, False), (32768, 8, False), (65536, 8, False),
])
def test_ring_widths_take_windows_past_shared_memory(width, sub, staged_whole):
    """The plan stages phase 7's Mash and cluster B rows whole and takes
    per-warp windows at cluster A's and the wide cluster's widths."""
    assert pair_block_plan(width) == (sub, staged_whole)


def ring_block_writes(n_local: int, sub: int) -> np.ndarray:
    """ring_step.cu's cut of the [n_local, n_local] tile into blocks of sub
    x sub pairs with rows past n_local masked: the (row, col) of every
    write over every block id."""
    grid_x = (n_local + sub - 1) // sub
    bid = np.arange(grid_x * grid_x)
    a0, b0 = (bid // grid_x) * sub, (bid % grid_x) * sub
    valid_a, valid_b = np.minimum(sub, n_local - a0), np.minimum(sub, n_local - b0)
    out = []
    for x0, y0, va, vb in zip(a0, b0, valid_a, valid_b):
        r, c = np.meshgrid(np.arange(sub), np.arange(sub), indexing="ij")
        keep = (r < va) & (c < vb)
        out.append(np.stack([x0 + r[keep], y0 + c[keep]], axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("n_local", [1, 7, 8, 128, 325, 500])
@pytest.mark.parametrize("sub", [4, 8, 16])
def test_ring_block_cut_writes_each_pair_once(n_local, sub):
    writes = ring_block_writes(n_local, sub)
    assert writes.min() >= 0 and writes.max() < n_local
    assert len(writes) == n_local * n_local
    assert len(np.unique(writes[:, 0] * n_local + writes[:, 1])) == n_local * n_local


def test_ring_block_rows_past_n_local_read_as_pad():
    """A block at the end of a 13-row block (sub 8): its staged rows past
    n_local are PAD with count 0, so both kinds give the plain counts on
    the rows that exist."""
    rng = np.random.default_rng(12)
    rows = [np.repeat(rng.choice(50, size=10, replace=False), rng.integers(1, 3, size=10)) for _ in range(13)]
    ids = rows_of(rows, 64)
    counts = (ids != PAD).sum(axis=1).astype(np.int32)
    sub = 8
    padded = np.concatenate([ids, np.full((16 - 13, 64), PAD, np.int32)])
    got = emulate_contained(padded[8:], padded[8:], KERNEL_E, windowed=False)[:5, :5]
    want = ring.contained_counts_plain(torch.from_numpy(ids), torch.from_numpy(ids)).numpy()[8:, 8:]
    np.testing.assert_array_equal(got, want)
    cpad = np.concatenate([counts, np.zeros(3, np.int32)])
    got = emulate_mash(padded[sub:], cpad[sub:], padded[sub:], cpad[sub:], 64, KERNEL_E, windowed=False)[:5, :5]
    np.testing.assert_array_equal(got, plain_mash(ids, counts, ids, counts, 64)[8:, 8:])
