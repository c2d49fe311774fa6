#!/usr/bin/env python3
"""Time the port's merge-path, ring-step and fused indicator kernels
against other builds of the same C interfaces, in turns, on one NVIDIA
GPU.

    python3 kernel_ab.py --base DIR [DIR ...] [--indicator]

Each DIR holds another version of ``mash_shared.cu``, ``intersect.cu``,
``ring_step.cu`` and ``ring_step_mm.cu`` with the headers they include,
and ``indicator_mm.cu`` or the unfused ``indicator.cu``, for example the
parent commit's:

    mkdir -p ab_base && git archive HEAD~1 drep_tpu_torch/csrc | tar -x -C ab_base --strip-components=2

On chip_smoke.py's data at the main paths' shapes — phase 5's [10 112,
1000] Mash rows, phase 3's 2048-row Mash rows and [2048, 2048]
merge-intersect rows, phase 6's clusters A ([16, 2048, 2048] buckets) and
B ([1408, 2048]); the merge ring step at phase 7a's blocks (Mash [2500,
1000], cluster A's containment [500, 32 768], cluster B's padded [434,
2048], the wide cluster's [128, 65 536] in both kinds, and clusters B's
and C's blocks of phase 7d); the matmul ring step at phase 7d's (clusters
A [500, 32 768], B [325, 2048], C [256, 32 768] and the wide [128,
65 536]); the fused indicator product at phase 3's [512, 32 768] rows
(v_pad 65 536), the largest of phase 5's one-shot batches (its planted
clusters batched as the controller batches them) and cluster C's first
vocabulary chunk, against the base's ``indicator_mm.cu`` or, where the
base has ``indicator.cu`` instead, its two passes (the indicator kernel,
then ``torch._int_mm`` over the upper block triangle and the mirror) —
each base build's counts must equal this tree's kernel's, and this tree's
must equal the plain version (except where the plain version takes many
seconds: phase 5's Mash rows and cluster A's buckets). Then every build
is timed (CUDA events, mean of `reps` launches after one warm-up) in
turns, forward then back: base, this tree, this tree, base. The ring steps are timed with
their fused copy, as the ring runs them. Last, this tree's fused kernel
with each producer walk forced, in turns, on 512 rows of 0.5 to 128 ids a
row a 256-id chunk (v_pad 65 536): where the dense walk overtakes the
sparse one. Prints nvcc's ptxas report of every build, one JSON line per
shape and a last JSON line of everything. Exits nonzero without a result
when no CUDA device is present. With --indicator only the fused
indicator kernel runs, on random rows (phase 3's shape, a phase-5-like
batch, C-like rows), and a DIR may hold only its sources: a tuning try
edits a copy of csrc/ and is timed as a base.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

KERNELS = ("mash_shared", "intersect", "ring_step", "ring_step_mm")
# the fused indicator product, and the unfused kernel it replaced
INDICATOR_KERNELS = ("indicator_mm", "indicator")


def start_build(src_dir: str, name: str, out_dir: str, tag: str):
    from drep_tpu_torch.ops import _build

    so = os.path.join(out_dir, f"lib{name}_{tag}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, os.path.join(src_dir, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


@contextlib.contextmanager
def using(libs: dict):
    """Route the wrappers' launches to `libs` ({kernel: CDLL}) for a while."""
    from drep_tpu_torch.ops import _build

    saved = {k: _build._libs.get(k) for k in libs}
    _build._libs.update(libs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                _build._libs.pop(k, None)
            else:
                _build._libs[k] = v


def largest_batch(gs, planted) -> tuple:
    """(host ids, v_pad) of the largest (rows x v_pad) one-shot secondary
    batch of phase 5's planted clusters, batched and packed as the
    controller and the batched engine do."""
    from drep_tpu_torch.cluster.controller import BATCH_ROWS_MAX, SMALL_CLUSTER_MAX
    from drep_tpu_torch.ops.containment import (
        matmul_rows_pad,
        matmul_vocab_pad_extent,
        pack_scaled_sketches_clusterlocal,
    )
    from drep_tpu_torch.ops.minhash import pad_packed_rows

    clusters = [list(np.flatnonzero(planted == c)) for c in np.unique(planted)]
    batches, rows = [], BATCH_ROWS_MAX + 1
    for cl in clusters:
        if not 1 < len(cl) <= SMALL_CLUSTER_MAX:
            continue
        if rows + len(cl) > BATCH_ROWS_MAX:
            batches.append([])
            rows = 0
        batches[-1].append(cl)
        rows += len(cl)

    def extent(batch):
        return max(len(np.unique(np.concatenate([gs.scaled[i] for i in cl]))) for cl in batch)

    sized = [(matmul_rows_pad(sum(map(len, b))) * matmul_vocab_pad_extent(extent(b)), b) for b in batches]
    batch = max(sized, key=lambda x: x[0])[1]
    packed, v_extent = pack_scaled_sketches_clusterlocal([[gs.scaled[i] for i in cl] for cl in batch],
                                                         [gs.names[i] for cl in batch for i in cl])
    ids, _ = pad_packed_rows(packed.ids, packed.counts, matmul_rows_pad(packed.n))
    return ids, matmul_vocab_pad_extent(v_extent)


def dense_rows(m: int, width: int, v_pad: int, seed: int) -> np.ndarray:
    """[m, width] int32 rows of width / 2 .. width distinct ids below v_pad,
    PAD_ID after (phase 3's rows of chip_smoke.phase_indicator at its
    width)."""
    from drep_tpu_torch.ops.minhash import PAD_ID

    rng = np.random.default_rng(seed)
    ids = np.full((m, width), PAD_ID, np.int32)
    for r in range(m):
        n = int(rng.integers(width // 2, width + 1))
        ids[r, :n] = np.sort(rng.choice(v_pad - 1, size=n, replace=False))
    return ids


indicator_shapes: dict = {}


def shapes(dev) -> dict:
    """{shape: (kernel, call, plain or None, reps, shape)} on chip_smoke.py's
    data; fills indicator_shapes {shape: (host ids, v_pad)} on the way."""
    import torch

    from drep_tpu_torch.ops import intersect as ti
    from drep_tpu_torch.ops import mash, ring
    from drep_tpu_torch.ops.minhash import ids_to_device, pack_sketches, pad_packed_rows
    from drep_tpu_torch.utils.synth import planted_sketches

    out = {}
    indicator_shapes["phase3_dense"] = (dense_rows(512, 32768, 65536, 7), 65536)

    def mash_shape(label, packed, reps, plain):
        ids, cnt = mash._pad_rows(packed.ids, packed.counts, packed.ids.shape[1])
        a, n = torch.from_numpy(ids).to(dev), torch.from_numpy(cnt).to(dev)
        w = ids.shape[1]
        call = lambda: mash.mash_shared(a, n, a, n, s_orig=w, symmetric=True)  # noqa: E731
        want = (lambda: mash._wrap_symmetric_plain(mash.mash_shared_plain(a, n, a, n, s_orig=w))) if plain else None
        out[label] = ("mash_shared", call, want, reps, list(ids.shape))

    def isect_shape(label, op, reps, plain):
        d = ids_to_device(op, dev)
        fn, pl = (ti.intersect_stacked, ti.intersect_stacked_plain) if op.ndim == 3 else (ti.intersect, ti.intersect_plain)
        call = lambda: fn(d, d, symmetric=True)  # noqa: E731
        want = (lambda: mash._wrap_symmetric_plain(pl(d, d))) if plain else None
        out[label] = ("intersect", call, want, reps, list(op.shape))

    t0 = time.perf_counter()
    gs, _ = planted_sketches(2048, seed=11, s_bottom=1000, s_scaled=64)
    mash_shape("mash_2048_sym", pack_sketches(gs.bottom, gs.names, gs.sketch_size), 5, True)
    gs, planted = planted_sketches(cs.REAL_GENOMES, seed=2, s_bottom=1000, s_scaled=cs.REAL_SCALED_DEPTH)
    main = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    indicator_shapes["batch_largest"] = largest_batch(gs, planted)
    mash_shape("mash_main_path", main, 2, False)
    isect_shape("intersect_2048_sym", cs.intersect_rows_2048(np.random.default_rng(31)), 5, True)
    gs_b, planted_b = cs.plant_beyond()
    isect_shape("intersect_cluster_A", ti.self_operand(cs.beyond_pack(gs_b, planted_b, "A").ids), 2, False)
    isect_shape("intersect_cluster_B", ti.self_operand(cs.beyond_pack(gs_b, planted_b, "B").ids), 5, True)

    def ring_shape(label, kernel, kind, ids, counts, n_local, first, reps, v_pad=0):
        """A ring step on blocks `first` and `first + 1` (mod the blocks) of
        the padded pack, with its copy into receive buffers."""
        blocks = ids.shape[0] // n_local
        a, na, b, nb = (torch.from_numpy(np.ascontiguousarray(x[blk * n_local : (blk + 1) * n_local])).to(dev)
                        for blk in (first, (first + 1) % blocks) for x in (ids, counts))
        dst = (torch.empty_like(b), torch.empty_like(nb))
        if kernel == "ring_step":
            call = lambda: ring.ring_step(kind, a, na, b, nb, *dst)  # noqa: E731
            want = lambda: ring.ring_step_plain(kind, a, na, b, nb)  # noqa: E731
        else:
            call = lambda: ring.ring_step_matmul(a, na, b, nb, v_pad, *dst)  # noqa: E731
            want = lambda: ring.ring_step_matmul_plain(a, na, b, nb, v_pad)  # noqa: E731
        out[label] = (kernel, call, want, reps, [n_local, ids.shape[1]])

    D = cs.RING_POSITIONS
    ids, cnt = pad_packed_rows(main.ids, main.counts, D)
    ring_shape("ring_step_mash", "ring_step", "mash", ids, cnt, ids.shape[0] // D, 0, 3)
    packs = {key: cs.beyond_pack(gs_b, planted_b, key) for key in cs.BEYOND}
    packs["wide"] = cs.wide_pack()[1]
    ids, cnt = pad_packed_rows(packs["A"].ids, packs["A"].counts, D)
    ring_shape("ring_step_containment", "ring_step", "containment", ids, cnt, ids.shape[0] // D, 0, 3)
    ids, cnt = pad_packed_rows(packs["B"].ids, packs["B"].counts, 3)
    ring_shape("ring_step_padded", "ring_step", "containment", ids, cnt, ids.shape[0] // 3, 2, 5)
    ids, cnt = pad_packed_rows(packs["wide"].ids, packs["wide"].counts, D)
    ring_shape("ring_step_wide", "ring_step", "containment", ids, cnt, ids.shape[0] // D, 0, 3)
    ring_shape("ring_step_wide_mash", "ring_step", "mash", ids, cnt, ids.shape[0] // D, 1, 3)
    for key in ("B", "C"):  # the merge step at the matmul step's other shapes (the crossover)
        ids, cnt = pad_packed_rows(packs[key].ids, packs[key].counts, D)
        ring_shape(f"ring_step_{key}", "ring_step", "containment", ids, cnt, ids.shape[0] // D, 0, 3)
    for key, pk in packs.items():
        ids, cnt = pad_packed_rows(pk.ids, pk.counts, D)
        ring_shape(f"ring_step_mm_{key}", "ring_step_mm", "containment", ids, cnt, ids.shape[0] // D, 0, 3,
                   v_pad=ring.matmul_ring_vocab_pad(pk.ids))
    chunks, v_chunk = cs.c_chunks(gs_b, planted_b)
    indicator_shapes["cluster_C_chunk"] = (chunks[0], v_chunk)
    cs.log(f"inputs made in {time.perf_counter() - t0:.1f} s: "
           f"{ {k: v[4] for k, v in out.items()} }; indicator: "
           f"{ {k: [*v[0].shape, v[1]] for k, v in indicator_shapes.items()} }")
    return out


def two_passes(lib, ids, v_pad: int):
    """The unfused kernel's route on int32 ids: indicator.cu's [m, v_pad]
    int8 rows, then torch._int_mm over the upper block triangle and the
    mirror."""
    import torch

    from drep_tpu_torch.ops import _build
    from drep_tpu_torch.ops.indicator import triangle_counts

    m, width = ids.shape
    ind = torch.empty((m, v_pad), dtype=torch.int8, device=ids.device)
    fn = lib.indicator_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(ids.data_ptr(), ind.data_ptr(), m, width, v_pad, _build.stream_handle(ids.device)), "indicator")
    return triangle_counts(ind)


def indicator_ab(libs: dict, host_ids: np.ndarray, v_pad: int, dev) -> dict:
    """The fused kernel of every build (a base's two passes where it has
    the unfused kernel) on one operand, as the secondary hands it over:
    each equal to the plain version, then timed in turns."""
    import torch

    from drep_tpu_torch.ops import indicator as ti
    from drep_tpu_torch.ops.minhash import ids_to_device, widen_ids

    ids = ids_to_device(host_ids, dev)
    calls = {b: (lambda: ti.indicator_intersections(ids, v_pad)) if "indicator_mm" in lib
             else (lambda lib=lib: two_passes(lib["indicator"], widen_ids(ids), v_pad)) for b, lib in libs.items()}
    want = ti.indicator_intersections_plain(ids, v_pad)
    for b in libs:
        with using(libs[b]):
            cs.require(torch.equal(calls[b](), want), f"indicator {list(host_ids.shape)}: build {b} != plain")
    ms = {b: [] for b in libs}
    for b in list(libs) + list(libs)[::-1]:
        with using(libs[b]):
            ms[b].append(cs.cuda_ms(calls[b], reps=10))
    return {"kernel": "indicator_mm", "shape": [*host_ids.shape, v_pad], "dtype": str(host_ids.dtype),
            "ids_per_row_chunk": cs.ids_per_row_chunk(ids, v_pad),
            "unfused": [b for b, lib in libs.items() if "indicator_mm" not in lib], "ms": ms}


def indicator_rows() -> dict:
    """indicator_shapes on random rows only (no other kernel's shapes):
    phase 3's [512, 32 768] at v_pad 65 536, a phase-5-like batch
    [512, 16 384] at v_pad 32 768, and C-like [1024, 1024] at v_pad
    32 768 (~96, ~96 and ~6 ids a row a chunk)."""
    indicator_shapes["phase3_dense"] = (dense_rows(512, 32768, 65536, 7), 65536)
    indicator_shapes["batch_like"] = (dense_rows(512, 16384, 32768, 8), 32768)
    indicator_shapes["c_like"] = (dense_rows(1024, 1024, 32768, 3), 32768)
    return {}


def walk_sweep(libs: dict, dev) -> list:
    """This tree's fused kernel with each producer walk forced on [512, W]
    rows at v_pad 65 536, W from 128 to 32 768 (0.5 to 128 ids a row a
    chunk), in turns dense, sparse, sparse, dense."""
    from drep_tpu_torch.ops import indicator as ti
    from drep_tpu_torch.ops.minhash import ids_to_device

    out = []
    with using(libs):
        for width in (128, 512, 1024, 2048, 4096, 16384, 32768):
            ids = ids_to_device(dense_rows(512, width, 65536, width), dev)
            want = ti.indicator_intersections_plain(ids, 65536)
            ms = cs.time_walks(ids, 65536, want, f"[512, {width}]")
            out.append({"shape": [512, width, 65536], "ids_per_row_chunk": cs.ids_per_row_chunk(ids, 65536), "ms": ms,
                        "picked": "dense" if ti.dense_walk(width, 65536) else "sparse"})
            cs.log(f"walks: {json.dumps(out[-1])}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, nargs="+",
                    help="directories of other builds' sources and headers (each timed in turns with this tree's)")
    ap.add_argument("--indicator", action="store_true",
                    help="only the fused indicator kernel, on random rows of the main path's densities")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from drep_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = cs.gpu_line()
    cs.log(card)
    out_dir = os.path.join(cs.HERE, "drep_tpu_torch", "_build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    builds = {os.path.basename(os.path.normpath(d)): os.path.abspath(d) for d in args.base}
    builds["new"] = _build.CSRC
    t0 = time.perf_counter()
    jobs = {(b, k): start_build(src, k, out_dir, b) for b, src in builds.items() for k in KERNELS
            if not args.indicator and os.path.exists(os.path.join(src, f"{k}.cu"))}
    for b, src in builds.items():  # the fused kernel, or a base's unfused one
        k = next(k for k in INDICATOR_KERNELS if os.path.exists(os.path.join(src, f"{k}.cu")))
        jobs[(b, k)] = start_build(src, k, out_dir, b)
    libs, logs = {b: {} for b in builds}, {}
    for (b, k), (proc, so) in jobs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {b} {k}:\n{log_text[-4000:]}")
        libs[b][k] = ctypes.CDLL(so)
        logs[f"{b}/{k}"] = [ln.strip() for ln in log_text.splitlines() if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
        cs.log(f"build {b}/{k}: " + " | ".join(logs[f"{b}/{k}"]))
    cs.log(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")

    results = {}
    for label, (kernel, call, plain, reps, shape) in (indicator_rows() if args.indicator else shapes(dev)).items():
        with using(libs["new"]):
            ref = call()
        if plain is not None:
            cs.require(torch.equal(ref, plain()), f"{label}: this tree's {kernel} != plain")
        for b in builds:
            with using(libs[b]):
                cs.require(torch.equal(call(), ref), f"{label}: build {b} != this tree's {kernel}")
        del ref
        order = list(builds) + list(builds)[::-1]
        ms = {b: [] for b in builds}
        for b in order:
            with using(libs[b]):
                ms[b].append(cs.cuda_ms(call, reps=reps))
        results[label] = {"kernel": kernel, "shape": shape, "reps": reps, "plain_checked": plain is not None, "ms": ms}
        cs.log(f"ab {label}: " + json.dumps(results[label]))
    for label, (host_ids, v_pad) in indicator_shapes.items():
        results[f"indicator_{label}"] = indicator_ab(libs, host_ids, v_pad, dev)
        cs.log(f"ab indicator_{label}: " + json.dumps(results[f"indicator_{label}"]))
    walks = walk_sweep(libs["new"], dev)
    report = {"card": card, "builds": builds, "ptxas": logs, "shapes": results, "walks": walks}
    cs.log(card)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
