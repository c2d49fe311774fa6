#!/usr/bin/env python3
"""Time the port's merge-path and ring-step kernels against another build
of the same C interfaces, in turns, on one NVIDIA GPU.

    python3 kernel_ab.py --base DIR

DIR holds another version of ``mash_shared.cu``, ``intersect.cu``,
``ring_step.cu`` and ``ring_step_mm.cu`` with the headers they include,
for example the parent commit's:

    mkdir -p ab_base && git archive HEAD~1 drep_tpu_torch/csrc | tar -x -C ab_base --strip-components=2

On chip_smoke.py's data at the main paths' shapes — phase 5's [10 112,
1000] Mash rows, phase 3's 2048-row Mash rows and [2048, 2048]
merge-intersect rows, phase 6's clusters A ([16, 2048, 2048] buckets) and
B ([1408, 2048]); the merge ring step at phase 7a's blocks (Mash [2500,
1000], cluster A's containment [500, 32 768], cluster B's padded [434,
2048], the wide cluster's [128, 65 536] in both kinds, and clusters B's
and C's blocks of phase 7d); the matmul ring step at phase 7d's (clusters
A [500, 32 768], B [325, 2048], C [256, 32 768] and the wide [128,
65 536]) — the base build's counts must equal
this tree's kernel's, and this tree's must equal the plain version
(except where the plain version takes many seconds: phase 5's Mash rows
and cluster A's buckets). Then both builds are timed
(CUDA events, mean of `reps` launches after one warm-up) in turns: base,
this tree, this tree, base. The ring steps are timed with their fused
copy, as the ring runs them. Prints nvcc's ptxas report of both builds,
one JSON line per shape and a last JSON line of everything. Exits nonzero
without a result when no CUDA device is present.
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


def shapes(dev) -> dict:
    """{shape: (kernel, call, plain or None, reps, shape)} on chip_smoke.py's data."""
    import torch

    from drep_tpu_torch.ops import intersect as ti
    from drep_tpu_torch.ops import mash, ring
    from drep_tpu_torch.ops.minhash import ids_to_device, pack_sketches, pad_packed_rows
    from drep_tpu_torch.utils.synth import planted_sketches

    out = {}

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
    gs, _ = planted_sketches(cs.REAL_GENOMES, seed=2, s_bottom=1000, s_scaled=cs.REAL_SCALED_DEPTH)
    main = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
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
    cs.log(f"inputs made in {time.perf_counter() - t0:.1f} s: "
           f"{ {k: v[4] for k, v in out.items()} }")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="directory of the other kernels' sources and headers")
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
    builds = {"base": os.path.abspath(args.base), "new": _build.CSRC}
    t0 = time.perf_counter()
    jobs = {(b, k): start_build(src, k, out_dir, b) for b, src in builds.items() for k in KERNELS}
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
    for label, (kernel, call, plain, reps, shape) in shapes(dev).items():
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
    report = {"card": card, "builds": builds, "ptxas": logs, "shapes": results}
    cs.log(card)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
