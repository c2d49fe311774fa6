#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of dRep on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels (one nvcc per ``drep_tpu_torch/csrc/*.cu``, all
   at once) and the native ingest, with the seconds it took;
3. hold each kernel against its plain PyTorch version on the card, exact
   equality, at the main path's shapes — Mash shared counts (2048 planted
   rows at width 1000, symmetric and rectangular layouts, ragged rows,
   widths 3000 and 16384) and the indicator (m=512, width 32768, v_pad 65536,
   from int32 and from a widened uint16 pack) — and time kernel, plain
   version and (where one exists) the library call, beside the bound;
4. the CLI main path: ``dereplicate`` on tests/genomes/*.fasta with a
   quality CSV, which must pick 3 winners (A, C, D);
5. the real-size slice: 10 000 planted genomes (MASH_sketch 1000, scaled
   depth 20 000) through d_cluster_wrapper, d_choose_wrapper and
   d_evaluate_wrapper; checks that every planted cluster is one primary and
   one secondary cluster, that every secondary batch took the one-shot
   cluster-local route, and that a random 512x512 block of shared counts
   equals the plain version;
6. one ``{"kernels": [...]}`` JSON line (launch counts from phase 5);
7. the last line: ``{"ok": true, "device": {...}}``.

It exits nonzero without a result when no CUDA device is present, or when
the ``drep_tpu_torch`` package is not beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and
# the non-tensor-core rate used for the kernels' int32 compare-and-advance
# steps (the data sheet lists no separate int32 rate; 67 T/s is its
# CUDA-core float32 peak).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
INT8_TENSOR_OPS_PER_S = 1979e12

# the real-size slice: genomes and scaled-sketch depth (a 4 Mb genome at
# scale 200 keeps ~20 000 hashes); below the 30 000-genome streaming switch
REAL_GENOMES = 10_000
REAL_SCALED_DEPTH = 20_000


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mash_ops(shared: np.ndarray, na: np.ndarray, nb: np.ndarray, s_orig: int) -> int:
    """Merge steps the pair walks need on this data: each pair advances
    through s_use distinct ids plus its duplicates among them."""
    s_use = np.minimum(np.minimum(na[:, None], nb[None, :]), s_orig).astype(np.int64)
    return int(s_use.sum() + shared.astype(np.int64).sum())


def phase_mash(dev) -> dict:
    import torch

    from drep_tpu_torch.ops import mash
    from drep_tpu_torch.ops.minhash import PAD_ID, pack_sketches
    from drep_tpu_torch.utils.synth import planted_sketches

    gs, _ = planted_sketches(2048, seed=11, s_bottom=1000, s_scaled=64)
    packed = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    ids = torch.from_numpy(packed.ids).to(dev)
    cnt = torch.from_numpy(packed.counts).to(dev)
    width = packed.ids.shape[1]
    log(f"mash: {packed.n} rows, width {width}")

    sym = mash.mash_shared(ids, cnt, ids, cnt, s_orig=width, symmetric=True)
    full = mash.mash_shared_plain(ids, cnt, ids, cnt, s_orig=width)
    require(torch.equal(sym, mash._wrap_symmetric_plain(full)), "mash symmetric layout != plain")
    rect = mash.mash_shared(ids[:1024], cnt[:1024], ids, cnt, s_orig=width)
    require(torch.equal(rect, full[:1024]), "mash rectangular layout != plain")

    # ragged rows: cut some rows short (PAD tail, smaller count)
    rng = np.random.default_rng(5)
    rag = packed.ids[:512].copy()
    rag_n = packed.counts[:512].copy()
    for r in rng.choice(512, size=128, replace=False):
        keep = int(rng.integers(0, width))
        rag[r, keep:] = PAD_ID
        rag_n[r] = keep
    ra, rn = torch.from_numpy(rag).to(dev), torch.from_numpy(rag_n).to(dev)
    require(
        torch.equal(mash.mash_shared(ra, rn, ra, rn, s_orig=width),
                    mash.mash_shared_plain(ra, rn, ra, rn, s_orig=width)),
        "mash ragged rows != plain",
    )
    # a width past the TPU kernel's 2048 limit
    gw, _ = planted_sketches(256, seed=12, s_bottom=3000, s_scaled=64)
    pw = pack_sketches(gw.bottom, gw.names, gw.sketch_size)
    wi, wn = torch.from_numpy(pw.ids).to(dev), torch.from_numpy(pw.counts).to(dev)
    require(
        torch.equal(mash.mash_shared(wi, wn, wi, wn, s_orig=3000, symmetric=True),
                    mash._wrap_symmetric_plain(mash.mash_shared_plain(wi, wn, wi, wn, s_orig=3000))),
        "mash width 3000 != plain",
    )
    # a row past the 48 KB of shared memory a block gets without opting in
    gx, _ = planted_sketches(128, seed=14, s_bottom=16384, s_scaled=64)
    px = pack_sketches(gx.bottom, gx.names, gx.sketch_size)
    xi, xn = torch.from_numpy(px.ids).to(dev), torch.from_numpy(px.counts).to(dev)
    require(
        torch.equal(mash.mash_shared(xi, xn, xi, xn, s_orig=16384),
                    mash.mash_shared_plain(xi, xn, xi, xn, s_orig=16384)),
        "mash width 16384 != plain",
    )
    log("mash: symmetric, rectangular, ragged, width-3000 and width-16384 layouts equal the plain version")

    kernel_ms = cuda_ms(lambda: mash.mash_shared(ids, cnt, ids, cnt, s_orig=width, symmetric=True), reps=5)
    plain_ms = cuda_ms(lambda: mash.mash_shared_plain(ids, cnt, ids, cnt, s_orig=width), reps=1, warmup=0)
    # the bound counts the pairs the symmetric grid computes
    counts_np = packed.counts
    compact = sym.cpu().numpy()
    t = packed.n // mash.TILE
    ops = 0
    for i in range(t):
        for jj in range(t // 2 + 1):
            j = (i + jj) % t
            blk = compact[i * 128 : (i + 1) * 128, jj * 128 : (jj + 1) * 128]
            ops += mash_ops(blk, counts_np[i * 128 : (i + 1) * 128], counts_np[j * 128 : (j + 1) * 128], width)
    nbytes = ids.numel() * 4 + cnt.numel() * 4 + sym.numel() * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    log(f"mash: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
        f"{max(bound_bytes_ms, bound_ops_ms):.6f} (bytes {bound_bytes_ms:.6f}, ops {bound_ops_ms:.6f}; "
        f"{ops} merge steps)")
    return {
        "name": "mash_shared",
        "route": "cuda",
        "source": "drep_tpu_torch/csrc/mash_shared.cu",
        "replaces": "drep_tpu/ops/pallas_mash.py:96",
        "equal": True,
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None,
    }


def phase_indicator(dev) -> dict:
    import torch

    from drep_tpu_torch.ops import indicator as ind_mod
    from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, ids_to_device

    m, width, v_pad = 512, 32768, 65536
    rng = np.random.default_rng(7)
    ids = np.full((m, width), PAD_ID, np.int32)
    for r in range(m):
        n = int(rng.integers(width // 2, width + 1))
        ids[r, :n] = np.sort(rng.choice(v_pad - 1, size=n, replace=False))
    ids16 = np.where(ids == PAD_ID, U16_PAD, ids).astype(np.uint16)
    d32 = ids_to_device(ids, dev)
    d16 = ids_to_device(ids16, dev)
    got32 = ind_mod.indicator(d32, v_pad)
    got16 = ind_mod.indicator(d16, v_pad)
    want = ind_mod.indicator_plain(d32, v_pad)
    require(torch.equal(got32, want), "indicator (int32) != plain")
    require(torch.equal(got16, want), "indicator (widened uint16) != plain")
    # the int8 triangle product after it, mirrored, against a float64 product (exact here)
    from drep_tpu_torch.ops import containment

    tb = containment.tri_row_block(m)
    inter = containment.mirror_lower_blocks(containment.intersect_matmul_tri(got32, tb).cpu().numpy(), tb)
    exact = (want.double() @ want.double().T).round().to(torch.int32).cpu().numpy()
    require(np.array_equal(inter, exact), "int8 triangle product != exact intersection counts")
    log(f"indicator: m={m} width={width} v_pad={v_pad}, int32 and uint16 packs equal the plain "
        "version; the torch._int_mm triangle gives the exact intersection counts")

    # the per-cluster secondary route (a primary cluster past the batching
    # size) on the card against the same call on the CPU
    from drep_tpu_torch.cluster import engines
    from drep_tpu_torch.utils.synth import planted_sketches

    gs, _ = planted_sketches(40, seed=13, s_bottom=200, s_scaled=20_000, cluster_size=40)
    on_card = engines.secondary_jax_ani(gs, list(range(40)), device=dev)
    on_cpu = engines.secondary_jax_ani(gs, list(range(40)), device=torch.device("cpu"))
    require(all(np.array_equal(x, y) for x, y in zip(on_card, on_cpu)),
            "per-cluster secondary (ani, cov) on the card != on the CPU")
    log("indicator: a 40-genome cluster's per-cluster secondary (ani, cov) equals the CPU plain path")

    kernel_ms = cuda_ms(lambda: ind_mod.indicator(d32, v_pad), reps=20)
    plain_ms = cuda_ms(lambda: ind_mod.indicator_plain(d32, v_pad), reps=5)
    int_mm_ms = cuda_ms(lambda: torch._int_mm(got32, got32.T), reps=10)
    nbytes = d32.numel() * 4 + m * v_pad
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    gemm_bound_ms = max(2 * m * m * v_pad / INT8_TENSOR_OPS_PER_S, (2 * m * v_pad + 4 * m * m) / HBM_BYTES_PER_S) * 1e3
    log(f"indicator: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f}; "
        f"torch._int_mm [{m}x{v_pad}]x[{v_pad}x{m}] ms={int_mm_ms:.4f} (bound {gemm_bound_ms:.6f})")
    return {
        "name": "indicator",
        "route": "cuda",
        "source": "drep_tpu_torch/csrc/indicator.cu",
        "replaces": "drep_tpu/ops/pallas_indicator.py:50",
        "equal": True,
        "max_abs_err": 0,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "int_mm_ms": int_mm_ms,
        "int_mm_bound_ms": gemm_bound_ms,
    }


def reset_launches() -> None:
    from drep_tpu_torch.ops import indicator, mash

    mash.LAUNCHES["mash_shared"] = 0
    indicator.LAUNCHES["indicator"] = 0


def read_launches() -> dict:
    from drep_tpu_torch.ops import indicator, mash

    return {"mash_shared": mash.LAUNCHES["mash_shared"], "indicator": indicator.LAUNCHES["indicator"]}


def phase_cli(tmp: str, dev) -> dict:
    import glob

    from drep_tpu_torch.controller import main as cli_main

    genomes = sorted(glob.glob(os.path.join(HERE, "tests", "genomes", "*.fasta")))
    require(len(genomes) == 5, "fixture genomes missing")
    q = os.path.join(tmp, "q.csv")
    with open(q, "w") as f:
        f.write("genome,completeness,contamination\ngenome_A.fasta,99,0.5\ngenome_B.fasta,90,1\n"
                "genome_C.fasta,85,2\ngenome_D.fasta,95,0.1\ngenome_E.fasta,94,0.2\n")
    wd = os.path.join(tmp, "fixture_wd")
    reset_launches()
    t0 = time.perf_counter()
    cli_main(["dereplicate", wd, "-g", *genomes, "--genomeInfo", q, "--skip_plots", "-p", "1",
             "--device", dev.type])
    dt = time.perf_counter() - t0
    launches = read_launches()
    import pandas as pd

    wdb = pd.read_csv(os.path.join(wd, "data_tables", "Wdb.csv"))
    winners = sorted(wdb["genome"])
    require(winners == ["genome_A.fasta", "genome_C.fasta", "genome_D.fasta"], f"fixture winners {winners}")
    require(all(v > 0 for v in launches.values()), f"fixture run skipped a kernel: {launches}")
    log(f"cli dereplicate: winners {winners} in {dt:.2f} s, launches {launches}")
    return launches


def phase_real_size(tmp: str, dev) -> dict:
    import pandas as pd
    import torch

    from drep_tpu_torch.choose import d_choose_wrapper
    from drep_tpu_torch.cluster import controller, engines
    from drep_tpu_torch.evaluate import d_evaluate_wrapper
    from drep_tpu_torch.ingest import save_sketch_cache
    from drep_tpu_torch.ops import mash
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.utils.synth import planted_sketches
    from drep_tpu_torch.workdir import WorkDirectory

    n = REAL_GENOMES
    t0 = time.perf_counter()
    gs, planted = planted_sketches(n, seed=2, s_bottom=1000, s_scaled=REAL_SCALED_DEPTH)
    t_plant = time.perf_counter() - t0
    wd = WorkDirectory(os.path.join(tmp, "real_wd"))
    gdir = os.path.join(tmp, "real_genomes")
    os.makedirs(gdir)
    for g in gs.names:
        open(os.path.join(gdir, g), "wb").close()  # winners are copied; contents unused
    bdb = pd.DataFrame({"genome": gs.names, "location": [os.path.join(gdir, g) for g in gs.names]})
    wd.store_db(bdb, "Bdb")
    t_files = time.perf_counter() - t0 - t_plant
    save_sketch_cache(wd, gs)
    wd.store_db(gs.gdb[["genome", "length", "N50", "contigs"]], "genomeInformation")
    log(f"real size: planted {n} genomes (MASH_sketch 1000, scaled width up to "
        f"{max(len(s) for s in gs.scaled)}): planting {t_plant:.1f} s, placeholder files "
        f"{t_files:.1f} s, sketch cache {time.perf_counter() - t0 - t_plant - t_files:.1f} s")

    paths_before = dict(engines.SECONDARY_PATH_COUNTS)
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cdb = controller.d_cluster_wrapper(wd, bdb, device=dev)
    t_cluster = time.perf_counter() - t1
    wdb = d_choose_wrapper(wd, bdb)
    d_evaluate_wrapper(wd)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t1
    launches = read_launches()
    paths = {p: c - paths_before.get(p, 0) for p, c in engines.SECONDARY_PATH_COUNTS.items()
             if c - paths_before.get(p, 0)}
    stages = dict(controller.STAGE_SECONDS)
    pairs = n * (n - 1) // 2
    log(f"real size: d_cluster_wrapper {t_cluster:.2f} s, with choose+evaluate {t_total:.2f} s; "
        f"stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    log(f"real size: primary compare {pairs} pairs in {stages['primary_compare']:.3f} s = "
        f"{pairs / stages['primary_compare']:.1f} pairs/s ({pairs / stages['primary']:.1f} pairs/s "
        f"with linkage); launches {launches}; secondary paths {paths}")

    require(all(v > 0 for v in launches.values()), f"real-size run skipped a kernel: {launches}")
    require(set(paths) == {"one_shot_clusterlocal"}, f"secondary left the one-shot cluster-local route: {paths}")
    by_name = cdb.set_index("genome")
    prim = by_name.loc[gs.names, "primary_cluster"].to_numpy()
    sec = by_name.loc[gs.names, "secondary_cluster"].to_numpy()
    for c in np.unique(planted):
        members = planted == c
        require(len(set(prim[members])) == 1, f"planted cluster {c} split across primary clusters")
        require(len(set(sec[members])) == 1, f"planted cluster {c} split across secondary clusters")
    n_planted = len(np.unique(planted))
    require(cdb["secondary_cluster"].nunique() == n_planted, "secondary clusters != planted clusters")
    require(len(wdb) == n_planted, "one winner per planted cluster expected")

    # a random 512x512 block of the main path's shared counts vs the plain version
    t2 = time.perf_counter()
    packed = pack_sketches(gs.bottom, gs.names, gs.sketch_size)
    t_pack = time.perf_counter() - t2
    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(n, size=512, replace=False))
    cols = np.sort(rng.choice(n, size=512, replace=False))
    a = torch.from_numpy(packed.ids[rows]).to(dev)
    na = torch.from_numpy(packed.counts[rows]).to(dev)
    b = torch.from_numpy(packed.ids[cols]).to(dev)
    nb = torch.from_numpy(packed.counts[cols]).to(dev)
    width = packed.ids.shape[1]
    t2 = time.perf_counter()
    full = mash.shared_all_vs_all(packed, dev)
    t_shared = time.perf_counter() - t2
    mash.shared_counts_to_distance(full, packed.counts, packed.counts, width, gs.k)
    t_transform = time.perf_counter() - t2 - t_shared
    pad, pad_n = mash._pad_rows(packed.ids, packed.counts, width)
    pad_d, pad_nd = torch.from_numpy(pad).to(dev), torch.from_numpy(pad_n).to(dev)
    main_ms = cuda_ms(lambda: mash.mash_shared(pad_d, pad_nd, pad_d, pad_nd, s_orig=width, symmetric=True),
                      reps=1, warmup=0)
    log(f"real size: primary compare parts: pack {t_pack:.2f} s, shared counts {n}x{n} "
        f"(kernel + transfer + host unwrap) {t_shared:.2f} s, host distance transform "
        f"{t_transform:.2f} s; kernel alone on [{pad.shape[0]}, {width}] {main_ms:.2f} ms")
    require(np.array_equal(full[np.ix_(rows, cols)],
                           mash.mash_shared_plain(a, na, b, nb, s_orig=width).cpu().numpy()),
            "real-size 512x512 shared-count block != plain")
    log(f"real size: {n_planted} planted clusters recovered exactly; random 512x512 shared block "
        "equals the plain version")
    return {"launches": launches, "mash_ms": main_ms, "mash_rows": int(pad.shape[0])}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "drep_tpu_torch")):
        print("chip_smoke.py: the drep_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    dev = torch.device("cuda")
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    from drep_tpu_torch.native import get_library
    from drep_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    native_ok = get_library() is not None
    log(f"build: CUDA kernels {list(_build.SOURCES)} and native ingest (ok={native_ok}) "
        f"in {time.perf_counter() - t0:.2f} s")

    kernels = [phase_mash(dev), phase_indicator(dev)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_cli(tmp, dev)
        real = phase_real_size(tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        k["launches"] = real["launches"][k["name"]]
    kernels[0]["main_path_ms"] = real["mash_ms"]
    kernels[0]["main_path_rows"] = real["mash_rows"]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
