#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of dRep on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels (one nvcc per ``drep_tpu_torch/csrc/*.cu``, all
   at once) and the native ingest, with the seconds it took, and ptxas's
   registers, static shared memory and spills per kernel;
3. hold each kernel against its plain PyTorch version on the card, exact
   equality, at the main paths' shapes — Mash shared counts (2048 planted
   rows at width 1000, symmetric and rectangular layouts, ragged rows,
   widths 3000 and 16384; the merge-path edge rows — equal rows, runs
   across lane splits, empty, one-element and all-PAD rows, counts below
   the real ids — at widths 1000 and 4096, s_use at every value 1..1024,
   and width 58 112), the fused indicator product (``indicator_mm.cu``:
   m=512, width 32768, v_pad 65536 from int32 and from a uint16 pack, its
   first 64 rows, and cluster C's first vocabulary chunk; both producer
   walks forced and timed on both densities), the merge-intersect kernel
   (2048 rows at width 2048; ragged, empty, in-row-repeat and uint16 rows;
   the edge rows at width 2048, the widest it takes) and its
   stacked form (a 256-row block of cluster A's 16 int32 buckets, of
   cluster C's uint16 buckets, two buckets of edge rows), both layouts
   each — and time kernel, plain version and (where one exists) the
   library call, beside the bound;
4. the CLI main path: ``dereplicate`` on tests/genomes/*.fasta with a
   quality CSV, which must pick 3 winners (A, C, D);
5. the real-size slice: 10 000 planted genomes (MASH_sketch 1000, scaled
   depth 10 000) through d_cluster_wrapper, d_choose_wrapper and
   d_evaluate_wrapper; checks that every planted cluster is one primary and
   one secondary cluster, that every secondary batch took the one-shot
   cluster-local route with one ``indicator_mm`` launch each (each batch's
   m_pad, W, v_pad and ids a row a chunk logged; the kernel on the
   largest held against its plain version and timed), and that a random
   512x512 block of shared counts equals the plain version;
6. the beyond-budget slice: three planted primary clusters past the
   one-shot indicator budget (A: 2000 diverse genomes, ~19 000 private +
   ~1 300 core hashes each; B: 1300 diverse genomes at width 2048; C: 1024
   overlapping genomes at depth 20 000) through d_cluster_wrapper (choose
   and evaluate, ~55 s over its ~6.7 M-row CSVs, are cut for the time
   limit: phase 5 runs them); checks the routes (A and B
   `pallas_range`, C `matmul_chunked`), that A and B split into one
   secondary cluster per genome and C stays one, that all four kernels
   launched (``indicator_mm`` once per vocabulary chunk of C), that each
   cluster's intersection counts are equal on the other route (both
   routes timed on the same pack), and that the Ndb rows the run wrote
   equal the (ani, cov) of those counts; on A and B, the
   merge kernel is held against its plain version on the whole operand the
   route builds (A's [16, 2048, 2048] buckets, B's [1408, 2048] rows) and
   timed beside its bound, with the seconds of each part of the route
   (`ops/intersect.py::STAGE_SECONDS`, then host ani/cov and Ndb rows);
7. the dense ring over RING_POSITIONS positions of one card (as many as
   there are cards): the fused ring-step kernel against its plain version
   (`torch.equal` on the tile and on the copied ids and counts, the step
   without a copy, and every timed launch's tile) on phase 5's Mash [2500,
   1000] blocks, cluster A's containment [500, 32768] blocks, a ragged
   block, a block padded because N is not a multiple of D, a 333-row block
   (not a multiple of 128) of rows with repeated ids in both kinds, and a
   512-genome cluster at width 65 536 (wider than a block's shared memory;
   Mash and containment), timed beside its bound, its plain version and
   the unfused step (kernel, then ``copy_``), with that cluster's ring
   bit-identical to one device's route; the primary ring over phase 5's
   10 000 genomes, bit-identical to the single-device matrix (both timed);
   where there are two cards or more, the kernel check with the copy
   landing on the second card;
   7c: phase 6's cluster C again with ``mesh_shape=4`` (A and B cut for
   the time limit): it must take ``mesh_ring``, whose steps run the
   matmul step where the cluster's v_pad is at most
   MATMUL_MAX_VPAD_PER_WIDTH times its width (C), while the Mash primary
   ring runs the merge step, with Cdb/Ndb equal to phase 6's rows of
   those genomes (primary clusters renumbered) and Mdb within 1e-7
   (d_cluster_wrapper only: choose and evaluate read nothing else);
   7d: the matmul ring step (``csrc/ring_step_mm.cu``) against its plain
   version (tile, copied operand, no-copy step, every timed launch's
   tile) and the merge step on
   cluster A's [500, 32768], B's [325, 2048], C's [256, 32768] and the
   wide cluster's [128, 65536] blocks, timed beside its bound, its plain
   version, the library yardstick (the scatter_ of ``indicator_plain`` +
   ``torch._int_mm`` over vocabulary chunks) and the merge step; the matmul ring over clusters A,
   B and C byte-identical to the merge ring and to phase 6's one device;
8. the streaming primary (``parallel/streaming.py``): 8a: 30 000 planted
   genomes (MASH_sketch 1000, scaled depth 1 200, cut from phase 5's 10 000
   for the time limit) through d_cluster_wrapper with default arguments, so
   the JAX package's switch at --streaming_threshold decides (its choose
   and evaluate cut for the time limit); checks the
   ``streaming_sort`` route, one ``mash_shared`` launch a stripe, every
   planted cluster one primary and one secondary cluster, and logs the stage
   seconds and pairs/s; the kernel on stripe 0's whole column range timed
   beside its bound, with a random 512x512 block of it equal to the plain
   version; 8b: on phase 5's 10 000 genomes, ``streaming_mash_edges`` at
   the average-linkage retention bound bit-identical to ``all_vs_all_mash``
   thresholded there, and the LSH-pruned walk bit-identical to the dense
   walk (its skipped tiles logged); 8c: half the shards of 8b's store
   deleted and the walk rerun: the same edges, and pairs computed equal to
   the deleted stripes' pairs;
9. the options of ROADMAP queue 1 item 9a, each through d_cluster_wrapper
   with the launch counts zeroed just before it: 9a ``--primary_estimator
   matmul`` on phase 5's first 2 500 genomes (secondary skipped; cut from
   10 000 for the time limit): one ``indicator_mm`` launch a
   vocabulary chunk, the primary equal to phase 5's rows, the whole [N, N]
   counts equal to ``intersect.cu``'s, chunk 0 equal to the plain version
   and timed beside its bound, the Jaccard within 0.06 of the sort
   estimator's; 9b ``--multiround_primary_clustering`` on the same 2 500
   genomes in chunks of 500 (cut from 10 000 in chunks of 2 500):
   six ``mash_shared`` launches, the partition equal to phase 5's rows; 9c
   ``--greedy_secondary_clustering`` on phase 6's clusters B and C (A cut
   for the time limit; both on ``greedy_secondary_cluster``: the
   rectangular entry of ``indicator_mm.cu`` held against its plain version
   at each cluster's first block x rep tile with both walks and timed, B's
   Ndb and labels byte-identical to its CPU run) and on phase 5's first
   2 500 genomes (the batched route, Cdb equal to phase 5's rows); 9d
   ``--run_tertiary_clustering`` on the same 2 500 genomes: the merges,
   and Cdb equal to phase 5's rows where nothing merged;
10. the genome index (``drep_tpu_torch/index``, ROADMAP queue 1 item 10a)
   on phase 5's finished workdir: 10a ``build_from_workdir`` (generation 0,
   labels equal to phase 5's Cdb); 10b ``index_update`` of INDEX_NEW
   planted genomes (half near indexed genomes, so their primary clusters
   turn dirty, half novel) through ``presketched``: one ``mash_shared``
   launch a tail stripe and one ``indicator_mm`` launch a dirty
   multi-member cluster, counted; tail stripe 0 and the largest dirty
   cluster held against their plain versions on the card; the new edges
   equal to the plain version over the same rectangle on the card; the
   same update of a prefix index (phase 5's first INDEX_PREFIX genomes,
   cut for the host's plain Mash version) on the card (its CPU half is
   cut for the time limit); 10c ``classify_batch`` of INDEX_QUERIES planted
   queries from one ``load_resident_index``, joint and separate, with the
   index tree's digest unchanged, and the first INDEX_CPU_QUERIES
   queries' verdicts on the prefix index equal on the card and the CPU;
   10c takes the union rectangle in both modes, and keeps the separate
   run's edges for phase 11;
11. the serve daemon (``drep_tpu_torch/serve``, ROADMAP queue 1 item 11a):
   11a ``IndexServer`` in-process on 10b's store (the resident sketch
   matrix uploaded to the card once), 10c's INDEX_QUERIES queries from
   SERVE_CLIENTS concurrent ``ServeClient``s: verdicts equal to 10c's
   separate-mode ones, one upload, no fallback, fewer batches than
   requests, one ``mash_shared`` launch a batch, the tree unchanged, a
   clean drain; on the 64-query batch the resident edges equal to 10c's
   union-path edges bit for bit; the kernel at the resident shape held against its plain
   version, timed and bounded; the resident rectangle of the prefix index
   equal on the card and the CPU; 11b ``python -m drep_tpu_torch index
   serve`` as a subprocess on an index of the fixture genomes A-C: its
   verdict equal to ``index classify`` on the card, SIGTERM to exit 0;
12. the federated index and its maintenance verbs (``index/federation.py``,
   ``index/maintenance.py``, ROADMAP queue 1 item 10b), with phase 5's and
   10's planted sketches substituted for ``federation.sketch_batch``: 12a
   ``build_federated`` over phase 5's genomes in FED_PARTITIONS partitions
   (each partition's ``mash_shared`` stripes and ``indicator_mm``
   dirty-cluster launches counted, with the cross walk's and the union
   recluster's, to make up the run's; no failed partition; the cross join
   and walk timed; every planted cluster one primary and one secondary
   cluster); 12b phase 10's update of INDEX_NEW genomes (the same checks,
   every routed partition at generation 1; the union's partitions and
   winners equal to phase 10's plain store's); 12c one-shot classify of
   10c's queries from ``load_resident_index(streaming=False)``: verdicts
   equal to 10c's joint ones (labels up to renumbering, the union orders
   differ; ``nearest`` up to a tie), the tree unchanged, and the separate
   verdicts of every query (phase 13's oracle); then phase 13, then 12d
   ``compact_store`` on phase 10's plain store, then ``index split`` of
   the largest partition, ``index merge`` back and ``index compact`` of
   the federation through the CLI, each leaving the union's partitions
   and winners as they were, and the first FED_MAINT_QUERIES queries'
   verdicts after compact_store and the last compact; 12e a FED_PODS-pod update of a federation of phase 5's first
   INDEX_PREFIX genomes (``python -m drep_tpu_torch index update
   --params_file`` subprocesses, every rc 0), equal payload by payload to
   the in-process update of its twin;
13. serving the federated root (``index/federation.py::FederatedResident``,
   ``serve/router.py``, ROADMAP queue 1 item 11b) at 12c's generation:
   13a ``IndexServer`` in-process on the root (the streaming resident: the
   spine at start, each partition's sketches on first consult, one
   rectangle [n_p + K] a consulted partition, a ``mash_shared`` launch a
   row stripe), 10c's queries from SERVE_CLIENTS concurrent clients:
   verdicts equal to 12c's separate ones once the coverage stamps are
   stripped, every verdict with full coverage, every partition healthy and
   never suspect or quarantined (a failed launch would show as a PARTIAL
   verdict), the ``mash_shared`` launches equal to the row stripes the
   partitions and batches imply and the ``indicator_mm`` launches to the
   reclusters' secondaries, the tree unchanged; 13b two replicas behind a
   ``RouterServer`` (the router's sketch cache holding the planted
   sketches, its batches FED_ROUTER_BATCH queries), scoped to partitions
   FED_SERVE_SCOPES (every query scattered as ``classify_part`` legs,
   merged on the router), then
   unscoped (every query forwarded): verdicts equal to 13a's full dicts,
   no leg failed, hedged or rerouted, the legs counted, the Mash launches
   all on the replicas' side and the indicator launches split between
   the router's reclusters and the replicas';
14. resilience on the card (ROADMAP queue 1 item 5; faults injected
   through ``drep_tpu_torch/utils/faults.py``): 14a d_cluster_wrapper on
   phase 9's PREFIX_OPTION_GENOMES prefix of phase 5's genomes, first with
   ``secondary_batch:raise:max=1`` (one retry, Cdb equal to phase 5's
   rows, one ``indicator_mm`` launch a secondary call), then in a fresh
   workdir with ``secondary_batch:raise:skip=2`` and ``fault_retries=1``,
   which must raise FaultTolError with exactly the first two calls'
   clusters checkpointed, then a clean rerun there that resumes exactly
   those clusters, launches ``indicator_mm`` for the calls left, and
   writes Cdb and Ndb byte-identical to the first run's; 14b
   ``streaming_mash_edges`` on the same genomes with
   ``streaming_tile:raise:skip=1:max=1`` (launches = stripes + 1, one
   retry), then with ``streaming_tile:hang:secs=20:max=1`` under a 5 s
   watchdog (one trip, launches = stripes + 1), the edges both times
   bit-identical to 8b's inside the prefix; 14c phase 4's dereplicate
   again on its workdir with Cdb and Ndb removed: both multi-member
   clusters resumed from their checkpoints, no ``indicator_mm`` launch,
   the winners A, C, D. The fault counters must be empty through phases
   1-13 (read after phase 10, before phase 11 restarts them, after phase
   13, and after 12d-e, whose CLI verbs restart them): no real launch was
   retried or stopped by the watchdog;
15. the subprocess engines and the taxonomy (``cluster/external.py``,
   ``cluster/anim.py``, ``bonus.py``, ROADMAP queue 1 item 9b) with
   stand-ins for their binaries first on $PATH (``write_fake_tools``:
   small Python scripts that write each tool's format from the FASTA
   files, log their calls and fail on request): SUB_BASES x 4 genomes of
   SUB_LENGTH bases in SUB_BASES primary clusters, d_cluster_wrapper on
   the card with each of fastANI, ANImf, ANIn, gANI and goANI under the
   jax_mash primary and with ``--primary_algorithm mash --S_algorithm
   fastANI``, and a ``dereplicate --run_tax``, each with Cdb, Ndb and Mdb
   (Wdb, Tdb) byte-identical to its twin run with the CPU device; the
   ``mash_shared`` launches exactly the jax_mash primary's (0 under
   ``mash``), no ``indicator_mm`` launch under a subprocess secondary, the
   stand-ins' calls exactly those the engine implies (for ANImf m(m-1) a
   cluster); fastANI failing once on one cluster is retried (one retry),
   failing twice under ``fault_retries=1`` raises FaultTolError with the
   clusters before it checkpointed, and the rerun calls fastANI for the
   unfinished clusters alone, with the clean run's Cdb and Ndb;
16. event tracing and ``--profile`` (ROADMAP queue 1 item 13): 16a phase
   4's dereplicate again, in a new workdir, with ``--events on --profile``:
   the event log parses line by line through the port's reader
   (``utils/telemetry.py::read_events``), every span closes, the stage
   spans come in the JAX package's order (TRACE_STAGES) and
   ``run_finished`` ends it, and the Chrome trace of ``torch.profiler``
   under ``<wd>/log/torch_trace`` holds ``mash_shared_kernel`` and
   ``indicator_mm_kernel`` events exactly as many times as the run's launch
   counters say; 16b tracing on in runs made anyway: 14a's retried
   secondary (one ``fault`` instant for the retry, one for the injected
   raise), 11a's daemon (``serve_load``, ``serve_start``, one
   ``serve_batch`` span a batch, ``serve_drain``, ``serve_stop``) and
   13b's scatter router with its replicas (``route_start``, one
   ``partition_classify`` span a leg, no replica transition or fault),
   each log's event count and its run's seconds printed; 16c one
   recommend-only ``FleetAutoscaleController`` tick against 13b's live
   scatter router: one decision record a partition range, the JAX keys,
   nothing placed or drained;
17. one ``{"kernels": [...]}`` JSON line (launch counts from phase 5 for the
   Mash and fused indicator kernels, from phase 6 for the merge kernels, from
   7c for both ring steps, from 9c for the rectangular entry; the Mash and
   merge kernels also carry their time and bound on the main path's own
   operand, ``main_path_ms`` and ``main_path_bound_ms``, the Mash kernel its
   streaming launches and stripe-0 time and bound from phase 8a,
   ``streaming``, and its multiround launches, and the fused indicator
   kernel its matmul-estimator chunk from 9a; both carry phase 10's
   timings under ``index`` (the tail stripe, the largest dirty cluster)
   and its launches under ``index_launches``, and phase 11's under
   ``serve_launches``, phase 12's under ``federation_launches``; the Mash
   kernel its resident-shape time and bound under ``serve`` and phase
   12's times, cross-join pairs and launches under ``federation``; both
   phase 13's launches and times under ``federated_serve``; both phase
   14's launches under ``resilience_launches`` and phase 15's under
   ``subprocess_launches``; both phase 16a's launches and profiled kernel
   events under ``profiled``, the Mash kernel phase 16's seconds and event
   counts under ``trace``);
18. the last line: ``{"ok": true, "device": {...}}``.

Phase 5's and phase 8a's planted sketches are made in two spawned
processes started before phase 2 (the same seeds, so the same sketches),
beside the phases before them; each is joined, and stopped on any
failure, before the script ends.

It exits nonzero without a result when no CUDA device is present, or when
the ``drep_tpu_torch`` package is not beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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

# the real-size slice: genomes and scaled-sketch depth (a 2 Mb genome at
# scale 200 keeps ~10 000 hashes; a 4 Mb genome's 20 000 would double the
# host's planting and leave too little of the time limit for phase 7);
# below the 30 000-genome streaming switch
REAL_GENOMES = 10_000
REAL_SCALED_DEPTH = 10_000

# the kernels of the one-shot main path (phases 4 and 5)
PRIMARY_PATH_KERNELS = ("mash_shared", "indicator_mm")

# the streaming slice (phase 8a): the JAX package's default
# --streaming_threshold, and a scaled depth cut from phase 5's 10 000 (the
# secondary's and the planter's host work grow with it) for the time limit
STREAM_GENOMES = 30_000
STREAM_SCALED_DEPTH = 1_200

# positions of the dense ring in phase 7 (even: the middle step is split)
RING_POSITIONS = 4
# genomes of phase 7a's cluster at width 65 536 (blocks of 128 rows)
WIDE_GENOMES = 512

# the beyond-budget slice: (genomes, scaled depth, kept core or None for
# the overlapping planter, route). A's vocabulary (~38 M ids -> v_pad 2^26)
# and B's (~2.3 M -> 2^22) outgrow 47x their merge units (49.3 M, 2.3 M);
# C's (~0.85 M -> 2^20) does not. All three are past the one-shot budget.
BEYOND = {
    "A": (2000, 20_300, 1_300, "pallas_range"),
    "B": (1300, 1_950, 150, "pallas_range"),
    "C": (1024, 20_000, None, "matmul_chunked"),
}


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


def cuda_timed(fn):
    """(fn(), its milliseconds on the card by CUDA events), one call."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _plant_to_file(path: str, n: int | None, seed: int, s_scaled: int) -> None:
    """A planting process: (planted_sketches(n, seed, MASH_sketch 1000,
    s_scaled), its seconds) pickled to `path`; with `n` None, (sketches,
    planted cluster per genome) of plant_beyond()."""
    import pickle

    from drep_tpu_torch.utils.synth import planted_sketches

    t0 = time.perf_counter()
    out = plant_beyond() if n is None else planted_sketches(n, seed=seed, s_bottom=1000, s_scaled=s_scaled)
    with open(path + ".tmp", "wb") as f:
        pickle.dump((out, time.perf_counter() - t0), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


class Planting:
    """The planted sketches of a later phase, made in a spawned process
    while the phases before it run: the host's planting (the beyond-budget
    slice's 4 324 genomes, phase 5's 10 000 genomes at depth 10 000, 8a's
    30 000) would otherwise take ~100 s of the script's time limit. The
    same seed gives the same sketches; `n` None plants the beyond-budget
    slice."""

    def __init__(self, tmp: str, name: str, n: int | None, seed: int = 0, s_scaled: int = 0) -> None:
        import multiprocessing

        self.path = os.path.join(tmp, f"{name}.pkl")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_plant_to_file, args=(self.path, n, seed, s_scaled), name=f"plant-{name}")
        self.proc.start()

    def result(self):
        """((GenomeSketches, planted ids), seconds the planting took, seconds
        waited for it here)."""
        import pickle

        t0 = time.perf_counter()
        self.proc.join()
        require(self.proc.exitcode == 0, f"{self.proc.name} exited with {self.proc.exitcode}")
        with open(self.path, "rb") as f:  # written by this run's own process
            out, t_plant = pickle.load(f)
        os.remove(self.path)
        return out, t_plant, time.perf_counter() - t0

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


def mash_ops(shared: np.ndarray, na: np.ndarray, nb: np.ndarray, s_orig: int) -> int:
    """Merge steps the pair walks need on this data: each pair advances
    through s_use distinct ids plus its duplicates among them."""
    s_use = np.minimum(np.minimum(na[:, None], nb[None, :]), s_orig).astype(np.int64)
    return int(s_use.sum() + shared.astype(np.int64).sum())


def mash_grid_cost(shared: np.ndarray, counts: np.ndarray, width: int) -> tuple[int, int]:
    """(merge steps, bytes) of the symmetric Mash grid over [n, n] shared
    counts: the steps of every pair of the tiles the wrapped grid computes
    (rows padded to TILE multiples with count 0 need none); the ids and
    counts read once, the wrapped output written once."""
    from drep_tpu_torch.ops.mash import TILE

    n = shared.shape[0]
    t = -(-n // TILE)
    steps = 0
    for i in range(t):
        ri = slice(i * TILE, (i + 1) * TILE)
        for jj in range(t // 2 + 1):
            j = (i + jj) % t
            rj = slice(j * TILE, (j + 1) * TILE)
            steps += mash_ops(shared[ri, rj], counts[ri], counts[rj], width)
    rows = t * TILE
    return steps, rows * width * 4 + rows * 4 + rows * (t // 2 + 1) * TILE * 4


def mash_rect_cost(shared: np.ndarray, na: np.ndarray, nb: np.ndarray, width: int) -> tuple[int, int]:
    """(merge steps, bytes) of one rectangular Mash launch over [ra, rb]
    shared counts: the steps of every pair it computes; both sides' ids and
    counts read once, the int32 counts written once."""
    ra, rb = shared.shape
    return mash_ops(shared, na, nb, width), (ra + rb) * (width + 1) * 4 + ra * rb * 4


def edge_rows(rng, width: int, vocab: int) -> np.ndarray:
    """128 ascending PAD_ID-padded int32 rows of the merge kernels' edge
    cases: pairs of equal rows (every id tied across A and B), rows with
    runs of one id (in-row repeats, ties that straddle every lane's share),
    empty, one-element and full rows, and ragged rows of a small
    vocabulary (many ties between rows)."""
    from drep_tpu_torch.ops.minhash import PAD_ID

    out = np.full((128, width), PAD_ID, np.int32)
    base = np.sort(rng.choice(vocab, size=width, replace=False)).astype(np.int32)
    for r in range(128):
        kind = r % 8
        if kind in (0, 1):  # rows 8k and 8k+1 equal
            n = int(rng.integers(1, width + 1)) if kind == 0 else n
            row = base[:n] if kind == 0 else out[r - 1, :n]
        elif kind == 2:  # runs of p copies
            row = np.repeat(base[: width // 8], rng.integers(1, 9, size=width // 8))[:width]
        elif kind == 3:
            row = np.zeros(0, np.int32) if r % 16 == 3 else base[int(rng.integers(0, width)) : None][:1]
        elif kind == 4:
            row = base
        else:
            row = np.sort(rng.integers(0, max(2, width // 2), size=int(rng.integers(0, width + 1))))
        out[r, : len(row)] = row
    return out


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

    def both_layouts(a, n, s_orig, what):
        full = mash.mash_shared_plain(a, n, a, n, s_orig=s_orig)
        require(torch.equal(mash.mash_shared(a, n, a, n, s_orig=s_orig, symmetric=True),
                            mash._wrap_symmetric_plain(full)), f"mash {what}, symmetric != plain")
        require(torch.equal(mash.mash_shared(a[:128], n[:128], a, n, s_orig=s_orig), full[:128]),
                f"mash {what}, rectangular != plain")

    # the merge-path schedule's edge cases (the CPU rehearsal's, on the card):
    # equal rows, runs across lane splits, empty / one-element / full rows,
    # counts below the real ids and all-PAD rows with a count
    for w in (1000, 4096):  # rows staged whole; per-warp windows
        rows = np.concatenate([edge_rows(rng, w, 4 * w), edge_rows(rng, w, 4 * w)[::-1]])
        real = (rows != PAD_ID).sum(axis=1).astype(np.int32)
        counts = np.maximum(real - rng.integers(0, 3, size=len(real)) * (real // 4), 0).astype(np.int32)
        counts[(real == 0) & (np.arange(len(real)) % 32 == 3)] = 9
        both_layouts(torch.from_numpy(rows).to(dev), torch.from_numpy(counts).to(dev), w, f"edge rows, width {w}")
    # s_use on every lane and round boundary: two overlapping full rows,
    # each 512 times, with counts 1..1024 (every value of min(na, nb))
    w = 1024
    x = np.sort(rng.choice(3 * w, size=w, replace=False)).astype(np.int32)
    y = np.sort(np.concatenate([x[::2], rng.choice(np.arange(3 * w, 4 * w), size=w // 2, replace=False)]))
    rows = np.stack([x, y.astype(np.int32)] * 512)
    counts = rng.permutation(np.arange(1, w + 1)).astype(np.int32)
    both_layouts(torch.from_numpy(rows).to(dev), torch.from_numpy(counts).to(dev), w, "s_use at every boundary")
    # the widest rows the wrapper took before it had per-warp windows
    w = 58_112
    pool = rng.choice(1 << 24, size=2 * w, replace=False)
    wide = np.stack([np.sort(rng.choice(pool, size=w, replace=False)) for _ in range(128)]).astype(np.int32)
    wn = torch.full((128,), w, dtype=torch.int32, device=dev)
    both_layouts(torch.from_numpy(wide).to(dev), wn, w, f"width {w}")
    log("mash: edge rows (equal rows, runs, empty / one-element / all-PAD rows, counts below the real ids) at "
        "widths 1000 and 4096, s_use on every lane and round boundary, and width 58112 equal the plain version")

    kernel_ms = cuda_ms(lambda: mash.mash_shared(ids, cnt, ids, cnt, s_orig=width, symmetric=True), reps=5)
    plain_ms = cuda_ms(lambda: mash.mash_shared_plain(ids, cnt, ids, cnt, s_orig=width), reps=1, warmup=0)
    # the bound counts the pairs the symmetric grid computes
    ops, nbytes = mash_grid_cost(full.cpu().numpy(), packed.counts, width)
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


_C_CHUNKS: list = []


def c_chunks(gs, planted):
    """(stacked vocabulary chunks, chunk width) of cluster C's pack: the
    operand of the matmul_chunked route in phase 6, made once."""
    from drep_tpu_torch.ops.containment import vocab_chunks

    if not _C_CHUNKS:
        _C_CHUNKS.extend(vocab_chunks(beyond_pack(gs, planted, "C")))
    return tuple(_C_CHUNKS)


def mm_bounds(ids, v_pad: int) -> dict:
    """indicator_mm's two bounds on [n, W] ids: the function's (the ids
    read once, the [n, n] int32 counts written once, at the HBM rate) and
    its tensor-core formulation's (2 x 128^2 x v_pad int8 operations a
    computed upper tile, at the int8 peak)."""
    n = ids.shape[0]
    tiles = -(-n // 128)
    bytes_ms = (ids.numel() * ids.element_size() + 4 * n * n) / HBM_BYTES_PER_S * 1e3
    tc_ms = tiles * (tiles + 1) // 2 * 2 * 128 * 128 * v_pad / INT8_TENSOR_OPS_PER_S * 1e3
    return {"bound_ms": bytes_ms, "bound_by": "bytes", "tensor_core_bound_ms": tc_ms}


def ids_per_row_chunk(ids, v_pad: int) -> float:
    """Mean ids below v_pad a row holds per 256-id chunk."""
    from drep_tpu_torch.ops.minhash import widen_ids

    return float((widen_ids(ids) < v_pad).sum().item()) / ids.shape[0] / (v_pad / 256)


def time_walks(ids, v_pad: int, want, what: str) -> dict:
    """Both producer walks of indicator_mm forced on int32 ids: each equal
    to `want`, then each timed (ms), in turns dense, sparse, sparse, dense."""
    import torch

    from drep_tpu_torch.ops import indicator as ind_mod

    n = ids.shape[0]
    out = torch.zeros((n, n), dtype=torch.int32, device=ids.device)

    def run(dense):
        out.zero_()
        ind_mod._launch(ids, v_pad, out, dense)

    ms = {"dense": [], "sparse": []}
    for dense in (True, False):
        run(dense)
        require(torch.equal(out, want), f"indicator_mm {what}, {'dense' if dense else 'sparse'} walk != plain")
    for walk in ("dense", "sparse", "sparse", "dense"):
        ms[walk].append(cuda_ms(lambda: run(walk == "dense"), reps=5))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def phase_indicator(dev, gs_beyond, planted_beyond) -> dict:
    """The fused indicator product (csrc/indicator_mm.cu) against its plain
    version: phase 3's dense pack [512, 32768] at v_pad 65 536 as int32 and
    as a uint16 pack, its first 64 rows, and cluster C's first vocabulary
    chunk (the matmul_chunked route's uint16 operand); timed beside both
    bounds, the plain version and the library yardstick, with both
    producer walks timed on both densities."""
    import torch

    from drep_tpu_torch.ops import indicator as ind_mod
    from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, ids_to_device, widen_ids

    m, width, v_pad = 512, 32768, 65536
    rng = np.random.default_rng(7)
    ids = np.full((m, width), PAD_ID, np.int32)
    for r in range(m):
        n = int(rng.integers(width // 2, width + 1))
        ids[r, :n] = np.sort(rng.choice(v_pad - 1, size=n, replace=False))
    ids16 = np.where(ids == PAD_ID, U16_PAD, ids).astype(np.uint16)
    d32 = ids_to_device(ids, dev)
    d16 = ids_to_device(ids16, dev)
    want, plain_ms = cuda_timed(lambda: ind_mod.indicator_intersections_plain(d32, v_pad))
    require(torch.equal(ind_mod.indicator_intersections(d32, v_pad), want), "indicator_mm (int32) != plain")
    require(torch.equal(ind_mod.indicator_intersections(d16, v_pad), want), "indicator_mm (uint16 pack) != plain")
    ind = ind_mod.indicator_plain(d32, v_pad).double()
    require(torch.equal(want, (ind @ ind.T).round().to(torch.int32)), "plain counts != a float64 product of the indicator")
    del ind
    d64 = d32[:64].contiguous()
    require(torch.equal(ind_mod.indicator_intersections(d64, v_pad), want[:64, :64]), "indicator_mm (64 rows) != plain")
    chunks, v_chunk = c_chunks(gs_beyond, planted_beyond)
    c16 = ids_to_device(chunks[0], dev)
    c32 = widen_ids(c16)
    c_want, c_plain_ms = cuda_timed(lambda: ind_mod.indicator_intersections_plain(c16, v_chunk))
    require(torch.equal(ind_mod.indicator_intersections(c16, v_chunk), c_want),
            "indicator_mm (cluster C's uint16 chunk) != plain")
    dense_ids, c_ids = ids_per_row_chunk(d32, v_pad), ids_per_row_chunk(c16, v_chunk)
    log(f"indicator_mm: [{m}, {width}] v_pad {v_pad} ({dense_ids:.1f} ids a row a chunk) as int32, as a uint16 "
        f"pack and its first 64 rows, and cluster C's chunk {tuple(c16.shape)} {c16.dtype} v_pad {v_chunk} "
        f"({c_ids:.2f} ids a row a chunk, walk {'dense' if ind_mod.dense_walk(c16.shape[1], v_chunk) else 'sparse'})"
        " equal the plain version")

    # the per-cluster secondary route (a primary cluster past the batching
    # size) on the card against the same call on the CPU
    from drep_tpu_torch.cluster import engines
    from drep_tpu_torch.utils.synth import planted_sketches

    gs, _ = planted_sketches(40, seed=13, s_bottom=200, s_scaled=20_000, cluster_size=40)
    on_card = engines.secondary_jax_ani(gs, list(range(40)), device=dev)
    on_cpu = engines.secondary_jax_ani(gs, list(range(40)), device=torch.device("cpu"))
    require(all(np.array_equal(x, y) for x, y in zip(on_card, on_cpu)),
            "per-cluster secondary (ani, cov) on the card != on the CPU")
    log("indicator_mm: a 40-genome cluster's per-cluster secondary (ani, cov) equals the CPU plain path")

    kernel_ms = cuda_ms(lambda: ind_mod.indicator_intersections(d32, v_pad), reps=20)
    # the library yardstick: the plain version, which is library calls (the
    # scatter_, torch._int_mm over the upper block triangle, the mirror), warm
    library_ms = cuda_ms(lambda: ind_mod.indicator_intersections_plain(d32, v_pad), reps=10)
    c_ms = cuda_ms(lambda: ind_mod.indicator_intersections(c16, v_chunk), reps=20)
    c_library_ms = cuda_ms(lambda: ind_mod.indicator_intersections_plain(c16, v_chunk), reps=10)
    walks = {"dense_pack": {"ids_per_row_chunk": dense_ids, **time_walks(d32, v_pad, want, "dense pack")},
             "cluster_C_chunk": {"ids_per_row_chunk": c_ids, **time_walks(c32, v_chunk, c_want, "C's chunk")}}
    entry = {
        "name": "indicator_mm",
        "route": "cuda",
        "source": "drep_tpu_torch/csrc/indicator_mm.cu",
        "replaces": "drep_tpu/ops/pallas_indicator.py:50",
        "equal": True,
        "max_abs_err": 0,
        "shape": [m, width, v_pad],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **mm_bounds(d32, v_pad),
        "library_ms": library_ms,
        "cluster_C_chunk": {"shape": [*c16.shape, v_chunk], "dtype": str(c16.dtype), "ms": c_ms,
                            "plain_ms": c_plain_ms, **mm_bounds(c16, v_chunk), "library_ms": c_library_ms},
        "walks_ms": walks,
    }
    log(f"indicator_mm: {json.dumps(entry)}")
    return entry


def plant_beyond():
    """(sketches, planted cluster per genome) of the beyond-budget slice:
    one planted primary cluster per BEYOND entry, in order."""
    from drep_tpu_torch.utils.synth import join_planted, planted_sketches

    return join_planted([
        planted_sketches(n, seed=21 + i, s_bottom=1000, s_scaled=depth, cluster_size=n, core=core)
        for i, (n, depth, core, _) in enumerate(BEYOND.values())
    ])


_PACKS: dict = {}


def beyond_pack(gs, planted, key: str):
    """The secondary stage's pack of one BEYOND cluster, packed once for
    the checks outside the main path (the main path packs its own)."""
    from drep_tpu_torch.ops.containment import pack_scaled_sketches

    if key not in _PACKS:
        idx = np.flatnonzero(planted == list(BEYOND).index(key))
        _PACKS[key] = pack_scaled_sketches([gs.scaled[i] for i in idx], [gs.names[i] for i in idx])
    return _PACKS[key]


def merge_cost(stacked: np.ndarray, symmetric: bool) -> tuple[int, int]:
    """(merge steps, bytes) the merge-intersect kernel needs on stacked
    [R, n, W] rows: every computed pair walks cnt_a + cnt_b elements in
    every bucket; inputs read once, the int32 output written once."""
    from drep_tpu_torch.ops.intersect import TILE_A
    from drep_tpu_torch.ops.minhash import pad_sentinel

    per_row = (stacked != pad_sentinel(stacked.dtype)).sum(axis=(0, 2)).astype(np.int64)
    n = stacked.shape[1]
    tiles = per_row.reshape(n // TILE_A, TILE_A).sum(axis=1)
    t = len(tiles)
    cells = [(i, (i + jj) % t) for i in range(t) for jj in range(t // 2 + 1)] if symmetric else \
        [(i, j) for i in range(t) for j in range(t)]
    steps = sum(TILE_A * (int(tiles[i]) + int(tiles[j])) for i, j in cells)
    out_elems = n * ((t // 2 + 1) * TILE_A if symmetric else n)
    return steps, stacked.nbytes + out_elems * 4


def intersect_entry(name: str, replaces: str, ms: float, plain_ms: float, steps: int, nbytes: int) -> dict:
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = steps / SCALAR_OPS_PER_S * 1e3
    log(f"{name}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(bound_bytes_ms, bound_ops_ms):.6f} "
        f"(bytes {bound_bytes_ms:.6f}, ops {bound_ops_ms:.6f}; {steps} merge steps)")
    return {
        "name": name,
        "route": "cuda",
        "source": "drep_tpu_torch/csrc/intersect.cu",
        "replaces": replaces,
        "equal": True,
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None,
    }


def intersect_rows_2048(rng) -> np.ndarray:
    """[2048, 2048] int32 rows of 1500-2048 distinct ids of a 2^16
    vocabulary, PAD_ID after: kernel 3 at the width of its route."""
    from drep_tpu_torch.ops.minhash import PAD_ID

    rows, width = 2048, 2048
    ids = np.full((rows, width), PAD_ID, np.int32)
    for r in range(rows):
        u = np.unique(rng.integers(0, 1 << 16, size=2300))[: int(rng.integers(1500, width + 1))]
        ids[r, : len(u)] = u
    return ids


def phase_intersect(dev, gs, planted) -> list[dict]:
    import torch

    from drep_tpu_torch.ops import intersect as ti
    from drep_tpu_torch.ops.mash import _wrap_symmetric_plain
    from drep_tpu_torch.ops.minhash import PAD_ID, U16_PAD, widen_ids
    from drep_tpu_torch.ops.rangepart import stacked_range_buckets

    def check(a, b, symmetric, what, stacked=False):
        fn = ti.intersect_stacked if stacked else ti.intersect
        plain = ti.intersect_stacked_plain if stacked else ti.intersect_plain
        got = fn(a, a if b is None else b, symmetric=symmetric)
        wa = widen_ids(a)
        want = plain(wa, wa if b is None else widen_ids(b))
        require(torch.equal(got, _wrap_symmetric_plain(want) if symmetric else want), f"{what} != plain")

    # kernel 3 at [2048 rows, width 2048]: distinct ids over a 2^16 vocabulary, ragged
    rng = np.random.default_rng(31)
    ids = intersect_rows_2048(rng)
    d = torch.from_numpy(ids).to(dev)
    check(d, None, True, "intersect symmetric [2048, 2048]")
    check(d[:1024], d, False, "intersect rectangular [1024 x 2048, 2048]")
    # ragged with empty rows, in-row repeats, and a uint16 pack of the same rows
    small = np.full((512, 512), PAD_ID, np.int32)
    for r in range(512):
        n = 0 if r % 7 == 0 else int(rng.integers(1, 513))
        small[r, :n] = np.sort(rng.integers(0, 3000 if r % 2 else 600, size=n))  # odd rows: few repeats
    sd = torch.from_numpy(small).to(dev)
    sd16 = torch.from_numpy(np.where(small == PAD_ID, U16_PAD, small).astype(np.uint16)).to(dev)
    check(sd, None, True, "intersect ragged/empty/repeat rows, symmetric")
    check(sd[:256], sd, False, "intersect ragged/empty/repeat rows, rectangular")
    check(sd16, None, True, "intersect uint16 rows, symmetric")
    check(sd16[:128], sd16, False, "intersect uint16 rows, rectangular")
    # the same rows as two stacked buckets (the second in reverse row order)
    st2 = torch.stack([sd, sd.flip(0)])
    check(st2, None, True, "intersect_stacked ragged/empty/repeat rows, symmetric", stacked=True)
    check(st2[:, :256], st2, False, "intersect_stacked ragged/empty/repeat rows, rectangular", stacked=True)
    # the merge-path schedule's edge cases (the CPU rehearsal's, on the
    # card) at the widest rows the wrapper takes
    w = ti.PALLAS_MAX_WIDTH
    e = torch.from_numpy(edge_rows(rng, w, 4 * w)).to(dev)
    check(e, None, True, f"intersect edge rows, width {w}, symmetric")
    check(e, e.flip(0).contiguous(), False, f"intersect edge rows, width {w}, rectangular")
    check(torch.stack([e, e.flip(0)]), None, True, "intersect_stacked edge rows, symmetric", stacked=True)
    log("intersect: [2048, 2048] symmetric and rectangular, ragged/empty/repeat rows (plain and as two "
        "stacked buckets), uint16 rows, and edge rows (equal rows, runs, empty / one-element / full rows) at "
        f"width {w} equal the plain version")
    k3_ms = cuda_ms(lambda: ti.intersect(d, d, symmetric=True), reps=5)
    k3_plain_ms = cuda_ms(lambda: ti.intersect_plain(d, d), reps=1, warmup=0)
    steps, nbytes = merge_cost(ids[None], symmetric=True)
    k3 = intersect_entry("intersect", "drep_tpu/ops/pallas_merge.py:79", k3_ms, k3_plain_ms, steps, nbytes)

    # kernel 4 on cluster A's stacked int32 buckets (a 256-row block) and
    # cluster C's uint16 buckets
    t0 = time.perf_counter()
    pack_a = beyond_pack(gs, planted, "A")
    t_pack = time.perf_counter() - t0
    (st_a,) = stacked_range_buckets([pack_a.ids], ti.PALLAS_MAX_WIDTH)
    t_plan = time.perf_counter() - t0 - t_pack
    require(st_a.dtype == np.int32, f"cluster A's buckets should ship int32, got {st_a.dtype}")
    log(f"intersect_stacked: cluster A pack {pack_a.ids.shape} in {t_pack:.2f} s, "
        f"{st_a.shape[0]} buckets {st_a.shape} {st_a.dtype} in {t_plan:.2f} s")
    blk = torch.from_numpy(np.ascontiguousarray(st_a[:, :256])).to(dev)
    nxt = torch.from_numpy(np.ascontiguousarray(st_a[:, 256:512])).to(dev)
    check(blk, None, True, "intersect_stacked cluster A block, symmetric", stacked=True)
    check(blk, nxt, False, "intersect_stacked cluster A block, rectangular", stacked=True)
    pack_c = beyond_pack(gs, planted, "C")
    (st_c,) = stacked_range_buckets([pack_c.ids], ti.PALLAS_MAX_WIDTH)
    require(st_c.dtype == np.uint16, f"cluster C's buckets should ship uint16, got {st_c.dtype}")
    cblk = torch.from_numpy(np.ascontiguousarray(st_c[:, :256])).to(dev)
    check(cblk, None, True, "intersect_stacked cluster C uint16 block, symmetric", stacked=True)
    check(cblk[:, :128], cblk, False, "intersect_stacked cluster C uint16 block, rectangular", stacked=True)
    log(f"intersect_stacked: cluster A int32 {tuple(blk.shape)} and cluster C uint16 {tuple(cblk.shape)} "
        "blocks equal the plain version in both layouts")
    k4_ms = cuda_ms(lambda: ti.intersect_stacked(blk, blk, symmetric=True), reps=5)
    k4_plain_ms = cuda_ms(lambda: ti.intersect_stacked_plain(blk, blk), reps=1, warmup=0)
    steps, nbytes = merge_cost(st_a[:, :256], symmetric=True)
    k4 = intersect_entry("intersect_stacked", "drep_tpu/ops/pallas_merge.py:102", k4_ms, k4_plain_ms,
                         steps, nbytes)
    return [k3, k4]


def reset_launches() -> None:
    from drep_tpu_torch.ops import indicator, intersect, mash, ring

    mash.LAUNCHES["mash_shared"] = 0
    indicator.LAUNCHES["indicator_mm"] = 0
    indicator.LAUNCHES["indicator_mm_rect"] = 0
    intersect.LAUNCHES["intersect"] = 0
    intersect.LAUNCHES["intersect_stacked"] = 0
    ring.LAUNCHES["ring_step"] = 0
    ring.LAUNCHES["ring_step_mm"] = 0


def read_launches() -> dict:
    from drep_tpu_torch.ops import indicator, intersect, mash, ring

    return {"mash_shared": mash.LAUNCHES["mash_shared"], **indicator.LAUNCHES, **intersect.LAUNCHES, **ring.LAUNCHES}


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
    require(all(launches[k] > 0 for k in PRIMARY_PATH_KERNELS), f"fixture run skipped a kernel: {launches}")
    log(f"cli dereplicate: winners {winners} in {dt:.2f} s, launches {launches}")
    return {"launches": launches, "argv": ["dereplicate", wd, "-g", *genomes, "--genomeInfo", q, "--skip_plots",
                                           "-p", "1", "--device", dev.type], "wd": wd, "winners": winners}


def phase_real_size(tmp: str, dev, plant: "Planting") -> dict:
    import pandas as pd
    import torch

    from drep_tpu_torch.choose import d_choose_wrapper
    from drep_tpu_torch.cluster import controller, engines
    from drep_tpu_torch.evaluate import d_evaluate_wrapper
    from drep_tpu_torch.ingest import save_sketch_cache
    from drep_tpu_torch.ops import containment, mash
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.workdir import WorkDirectory

    n = REAL_GENOMES
    (gs, planted), t_plant, t_wait = plant.result()
    t0 = time.perf_counter() - t_plant
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
        f"{max(len(s) for s in gs.scaled)}): planting {t_plant:.1f} s (in its own process beside phases 1-4; "
        f"waited {t_wait:.1f} s for it), placeholder files "
        f"{t_files:.1f} s, sketch cache {time.perf_counter() - t0 - t_plant - t_files:.1f} s")

    # each one-shot secondary batch's operand, as the main path hands it to
    # the fused indicator product (the spy calls the real function)
    batches = []
    real_fn = containment.indicator_intersections

    def spy(ids, v_pad, out=None):
        batches.append((ids, v_pad))
        return real_fn(ids, v_pad, out=out)

    paths_before = dict(engines.SECONDARY_PATH_COUNTS)
    containment.indicator_intersections = spy
    try:
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cdb = controller.d_cluster_wrapper(wd, bdb, device=dev, mesh_shape=1)
        t_cluster = time.perf_counter() - t1
        wdb = d_choose_wrapper(wd, bdb)
        d_evaluate_wrapper(wd)
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t1
        launches = read_launches()
    finally:
        containment.indicator_intersections = real_fn
    paths = {p: c - paths_before.get(p, 0) for p, c in engines.SECONDARY_PATH_COUNTS.items()
             if c - paths_before.get(p, 0)}
    stages = dict(controller.STAGE_SECONDS)
    pairs = n * (n - 1) // 2
    log(f"real size: d_cluster_wrapper {t_cluster:.2f} s, with choose+evaluate {t_total:.2f} s; "
        f"stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    log(f"real size: primary compare {pairs} pairs in {stages['primary_compare']:.3f} s = "
        f"{pairs / stages['primary_compare']:.1f} pairs/s ({pairs / stages['primary']:.1f} pairs/s "
        f"with linkage); launches {launches}; secondary paths {paths}")

    require(all(launches[k] > 0 for k in PRIMARY_PATH_KERNELS), f"real-size run skipped a kernel: {launches}")
    require(set(paths) == {"one_shot_clusterlocal"}, f"secondary left the one-shot cluster-local route: {paths}")
    require(launches["indicator_mm"] == len(batches) == paths["one_shot_clusterlocal"],
            f"{launches['indicator_mm']} indicator_mm launches for {len(batches)} one-shot batches")
    secondary = phase_real_batches(batches)
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
    steps, nbytes = mash_grid_cost(full, packed.counts, width)
    main_bound_ms = max(steps / SCALAR_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    log(f"real size: the Mash kernel's main-path bound {main_bound_ms:.6f} ms ({steps} merge steps, {nbytes} bytes)")
    log(f"real size: primary compare parts: pack {t_pack:.2f} s, shared counts {n}x{n} "
        f"(kernel + transfer + host unwrap) {t_shared:.2f} s, host distance transform "
        f"{t_transform:.2f} s; kernel alone on [{pad.shape[0]}, {width}] {main_ms:.2f} ms")
    require(np.array_equal(full[np.ix_(rows, cols)],
                           mash.mash_shared_plain(a, na, b, nb, s_orig=width).cpu().numpy()),
            "real-size 512x512 shared-count block != plain")
    log(f"real size: {n_planted} planted clusters recovered exactly; random 512x512 shared block "
        "equals the plain version")
    return {"launches": launches, "mash_ms": main_ms, "mash_bound_ms": main_bound_ms, "mash_rows": int(pad.shape[0]),
            "packed": packed, "k": gs.k, "secondary": secondary, "gs": gs, "planted": planted, "wd": wd.location,
            "bdb": bdb, "cdb": cdb}


def phase_real_batches(batches) -> dict:
    """Phase 5's one-shot secondary batches: each one's (m_pad, W, v_pad,
    mean ids a row a chunk), and the fused kernel on the largest held
    against its plain version and timed beside both bounds, the plain
    version and both walks."""
    import torch

    from drep_tpu_torch.ops import indicator as ind_mod
    from drep_tpu_torch.ops.minhash import widen_ids

    shapes = [[int(ids.shape[0]), int(ids.shape[1]), v_pad, ids_per_row_chunk(ids, v_pad)] for ids, v_pad in batches]
    log(f"real size: one-shot secondary batches [m_pad, W, v_pad, ids a row a chunk]: {json.dumps(shapes)}")
    ids, v_pad = max(batches, key=lambda b: b[0].shape[0] * b[1])
    got = ind_mod.indicator_intersections(ids, v_pad)
    want, plain_ms = cuda_timed(lambda: ind_mod.indicator_intersections_plain(ids, v_pad))
    require(torch.equal(got, want), f"indicator_mm on the largest batch {tuple(ids.shape)} != plain")
    largest = {"shape": [int(ids.shape[0]), int(ids.shape[1]), v_pad], "dtype": str(ids.dtype),
               "ids_per_row_chunk": ids_per_row_chunk(ids, v_pad),
               "walk": "dense" if ind_mod.dense_walk(ids.shape[1], v_pad) else "sparse",
               "ms": cuda_ms(lambda: ind_mod.indicator_intersections(ids, v_pad), reps=20), "plain_ms": plain_ms,
               **mm_bounds(ids, v_pad),
               "library_ms": cuda_ms(lambda: ind_mod.indicator_intersections_plain(ids, v_pad), reps=10),
               "walks_ms": time_walks(widen_ids(ids), v_pad, want, "largest batch")}
    log(f"real size: indicator_mm on the largest batch equals the plain version; {json.dumps(largest)}")
    return {"batches": shapes, "largest": largest}


def beyond_workdir(tmp: str, name: str, gs):
    """(WorkDirectory, Bdb) of the beyond-budget slice: placeholder genome
    files (shared by every workdir), the sketch cache, genomeInformation."""
    import pandas as pd

    from drep_tpu_torch.ingest import save_sketch_cache
    from drep_tpu_torch.workdir import WorkDirectory

    wd = WorkDirectory(os.path.join(tmp, name))
    gdir = os.path.join(tmp, "beyond_genomes")
    if not os.path.isdir(gdir):
        os.makedirs(gdir)
        for g in gs.names:
            open(os.path.join(gdir, g), "wb").close()
    bdb = pd.DataFrame({"genome": gs.names, "location": [os.path.join(gdir, g) for g in gs.names]})
    wd.store_db(bdb, "Bdb")
    save_sketch_cache(wd, gs)
    wd.store_db(gs.gdb[["genome", "length", "N50", "contigs"]], "genomeInformation")
    return wd, bdb


def run_beyond(wd, bdb, dev, what: str, choose: bool = True, **kw):
    """d_cluster -> choose -> evaluate (d_cluster alone without `choose`)
    on a beyond-budget workdir with the launch counts zeroed just before:
    (Cdb, launches, secondary paths, stage seconds, d_cluster seconds)."""
    import torch

    from drep_tpu_torch.choose import d_choose_wrapper
    from drep_tpu_torch.cluster import controller, engines
    from drep_tpu_torch.evaluate import d_evaluate_wrapper

    paths_before = dict(engines.SECONDARY_PATH_COUNTS)
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cdb = controller.d_cluster_wrapper(wd, bdb, device=dev, **kw)
    t_cluster = time.perf_counter() - t1
    if choose:
        d_choose_wrapper(wd, bdb)
        d_evaluate_wrapper(wd)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t1
    launches = read_launches()
    paths = {p: c - paths_before.get(p, 0) for p, c in engines.SECONDARY_PATH_COUNTS.items()
             if c - paths_before.get(p, 0)}
    stages = dict(controller.STAGE_SECONDS)
    log(f"{what}: d_cluster_wrapper {t_cluster:.2f} s, with choose+evaluate {t_total:.2f} s; "
        f"stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}; launches {launches}; "
        f"secondary paths {paths}")
    return cdb, launches, paths, stages, t_cluster


def phase_beyond(tmp: str, dev, gs, planted) -> dict:
    """The beyond-budget slice (phase 6): d_cluster over the three BEYOND
    clusters, then each cluster's counts on both routes."""
    import pandas as pd
    import torch

    from drep_tpu_torch.cluster import engines
    from drep_tpu_torch.cluster.pairs import directional_ndb
    from drep_tpu_torch.ops import intersect as ti
    from drep_tpu_torch.ops.containment import (
        ani_cov_from_intersections,
        intersections_chunked,
        matmul_vocab_pad,
    )
    from drep_tpu_torch.ops.mash import _wrap_symmetric_plain
    from drep_tpu_torch.ops.minhash import ids_to_device, widen_ids

    t0 = time.perf_counter()
    wd, bdb = beyond_workdir(tmp, "beyond_wd", gs)
    log(f"beyond budget: {len(gs.names)} genomes in clusters "
        f"{ {k: int((planted == i).sum()) for i, k in enumerate(BEYOND)} }, workdir in {time.perf_counter() - t0:.1f} s")
    cdb, launches, paths, _, t_cluster = run_beyond(wd, bdb, dev, "beyond budget", choose=False, mesh_shape=1)
    require(paths == {"pallas_range": 2, "matmul_chunked": 1}, f"beyond-budget routes {paths}")
    launches = {k: v for k, v in launches.items() if k not in ("ring_step", "ring_step_mm", "indicator_mm_rect")}
    require(all(v > 0 for v in launches.values()), f"beyond-budget run skipped a kernel: {launches}")
    n_chunks = c_chunks(gs, planted)[0].shape[0]
    require(launches["indicator_mm"] == n_chunks,
            f"cluster C's {n_chunks} vocabulary chunks took {launches['indicator_mm']} indicator_mm launches")
    by_name = cdb.set_index("genome")
    prim = by_name.loc[gs.names, "primary_cluster"].to_numpy()
    sec = by_name.loc[gs.names, "secondary_cluster"].to_numpy()
    for i, (key, (n, _, _, route)) in enumerate(BEYOND.items()):
        members = planted == i
        require(len(set(prim[members])) == 1, f"cluster {key} split across primary clusters")
        want = n if route == "pallas_range" else 1
        require(len(set(sec[members])) == want, f"cluster {key}: {len(set(sec[members]))} secondary clusters, "
                f"expected {want}")

    # each cluster's counts on both routes, both timed on the same pack, and
    # the Ndb rows the run wrote held against them; where the main path ran
    # the merge kernel (A, B), the kernel is also held against its plain
    # version on the whole operand the route builds
    ndb = wd.get_db("Ndb")
    routes, parts, ani_cov = {}, {}, {}
    for key, (n, _, _, route) in BEYOND.items():
        pack = beyond_pack(gs, planted, key)
        torch.cuda.synchronize()
        t = time.perf_counter()
        merged = ti.intersect_counts_self(pack.ids, dev)
        t_merge = time.perf_counter() - t
        merge_parts = dict(ti.STAGE_SECONDS)
        t = time.perf_counter()
        chunked = intersections_chunked(pack, dev)
        t_chunk = time.perf_counter() - t
        require(np.array_equal(merged, chunked), f"cluster {key}: pallas_range counts != matmul_chunked counts")
        routes[key] = {"rows": pack.n, "width": int(pack.ids.shape[1]), "v_pad": matmul_vocab_pad(pack),
                       "route": engines.beyond_budget_secondary_path(pack.sketch_size, matmul_vocab_pad(pack)),
                       "pallas_range_s": t_merge, "matmul_chunked_s": t_chunk}
        log(f"beyond budget: cluster {key} {routes[key]}: both routes give equal counts")

        t = time.perf_counter()
        ani, cov = ani_cov_from_intersections(merged, pack.counts, gs.k)
        merge_parts["ani_cov"] = time.perf_counter() - t
        ani_cov[key] = (ani, cov)
        t = time.perf_counter()
        directional_ndb(pack.names, ani, cov, 1)
        merge_parts["ndb_rows"] = time.perf_counter() - t
        pos = pd.Index(pack.names)
        rows = ndb[ndb["querry"].isin(pos)]
        require(len(rows) == n * (n - 1), f"cluster {key}: {len(rows)} Ndb rows, expected {n * (n - 1)}")
        qi, ri = pos.get_indexer(rows["querry"]), pos.get_indexer(rows["reference"])
        require(min(qi.min(), ri.min()) >= 0, f"cluster {key}: Ndb rows pair genomes of other clusters")
        require(np.array_equal(rows["ani"].to_numpy().astype(np.float32), ani[qi, ri])
                and np.array_equal(rows["alignment_coverage"].to_numpy().astype(np.float32), cov[qi, ri]),
                f"cluster {key}: the run's Ndb ani/coverage != the counts checked across both routes")
        log(f"beyond budget: cluster {key}: the run's {len(rows)} Ndb rows equal (ani, cov) of those counts")
        if route != "pallas_range":
            continue

        op = ti.self_operand(pack.ids)
        stacked = op.ndim == 3
        kernel = ti.intersect_stacked if stacked else ti.intersect
        plain = ti.intersect_stacked_plain if stacked else ti.intersect_plain
        d = ids_to_device(op, dev)
        got = kernel(d, d, symmetric=True)
        wide = widen_ids(d)
        want, plain_ms = cuda_timed(lambda: plain(wide, wide))
        require(torch.equal(got, _wrap_symmetric_plain(want)),
                f"cluster {key}: {kernel.__name__} {tuple(op.shape)} != plain")
        del want, wide
        steps, nbytes = merge_cost(op if stacked else op[None], symmetric=True)
        parts[key] = {
            "kernel": kernel.__name__, "shape": list(op.shape), "dtype": str(op.dtype),
            "ms": cuda_ms(lambda: kernel(d, d, symmetric=True), reps=3), "plain_ms": plain_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, steps / SCALAR_OPS_PER_S) * 1e3, "merge_steps": steps,
            "route_parts_s": merge_parts,
        }
        log(f"beyond budget: cluster {key} {kernel.__name__} on the route's whole operand "
            f"{tuple(op.shape)} {op.dtype} equals the plain version; {json.dumps(parts[key])}")
    return {"launches": launches, "routes": routes, "parts": parts, "wd": wd.location, "d_cluster_s": t_cluster,
            "ani_cov": ani_cov}


def ring_cost(kind: str, na: np.ndarray, nb: np.ndarray, tile: np.ndarray, width: int, copy: bool):
    """(walk steps, bytes) of one ring step on this data: a Mash pair walks
    s_use distinct ids plus its duplicates among them; a containment pair
    at most the two rows (cnt_a + cnt_b). Bytes: both blocks read once,
    the tile written once, and with the copy B's ids and counts written."""
    if kind == "mash":
        steps = mash_ops(tile, na, nb, width)
    else:
        steps = len(nb) * int(na.astype(np.int64).sum()) + len(na) * int(nb.astype(np.int64).sum())
    block = len(na) * (width + 1) * 4
    return steps, 2 * block + tile.size * 4 + (block if copy else 0)


def check_ring_step(kind: str, a, na, b, nb, what: str, dst_device=None) -> dict:
    """ring_step against ring_step_plain on the card: the tile and the
    receive buffers (torch.equal), and the step without a copy. Returns
    the plain tile, its milliseconds and the receive buffers."""
    import torch

    from drep_tpu_torch.ops import ring

    dst_device = b.device if dst_device is None else dst_device
    dst = (torch.full(tuple(b.shape), -7, dtype=torch.int32, device=dst_device),
           torch.full(tuple(nb.shape), -7, dtype=torch.int32, device=dst_device))
    got = ring.ring_step(kind, a, na, b, nb, *dst)
    want, plain_ms = cuda_timed(lambda: ring.ring_step_plain(kind, a, na, b, nb))
    require(torch.equal(got, want), f"ring_step {kind} {what}: tile != plain")
    require(torch.equal(dst[0].to(b.device), b) and torch.equal(dst[1].to(b.device), nb),
            f"ring_step {kind} {what}: copied operand != B")
    require(torch.equal(ring.ring_step(kind, a, na, b, nb), want), f"ring_step {kind} {what} without a copy != plain")
    return {"tile": want, "plain_ms": plain_ms, "dst": dst}


_WIDE: list = []


def wide_pack():
    """(sketches, pack) of phase 7a's cluster at width 65 536, planted once."""
    from drep_tpu_torch.ops.containment import pack_scaled_sketches
    from drep_tpu_torch.utils.synth import planted_sketches

    if not _WIDE:
        gs_w, _ = planted_sketches(WIDE_GENOMES, seed=23, s_bottom=100, s_scaled=30_000,
                                   cluster_size=WIDE_GENOMES)
        _WIDE.extend([gs_w, pack_scaled_sketches(gs_w.scaled, gs_w.names)])
    return tuple(_WIDE)


def phase_ring_kernel(dev, packed, gs_beyond, planted_beyond) -> dict:
    """Phase 7a: the fused ring step at the ring's shapes, timed beside its
    bound, its plain version and the unfused step."""
    import torch

    from drep_tpu_torch.cluster.engines import SECONDARY_PATH_COUNTS, containment_matrices
    from drep_tpu_torch.ops import ring
    from drep_tpu_torch.ops.minhash import PAD_ID, pad_packed_rows
    from drep_tpu_torch.parallel.allpairs import sharded_containment_allpairs
    from drep_tpu_torch.parallel.mesh import make_mesh

    def blocks(ids, counts, n_local, first, second):
        out = []
        for blk in (first, second):
            rows = slice(blk * n_local, (blk + 1) * n_local)
            out += [torch.from_numpy(np.ascontiguousarray(ids[rows])).to(dev),
                    torch.from_numpy(np.ascontiguousarray(counts[rows])).to(dev)]
        return out

    def timed(kind, pk, n_local, label):
        """Check the step on blocks 0 and 1 of `pk`, then time it beside its
        bound, its plain version and the unfused step."""
        a, na, b, nb = blocks(pk.ids, pk.counts, n_local, 0, 1)
        width = pk.ids.shape[1]
        res = check_ring_step(kind, a, na, b, nb, f"[{n_local}, {width}]")
        dst = res["dst"]
        tiles = []
        ms = cuda_ms(lambda: tiles.append(ring.ring_step(kind, a, na, b, nb, *dst)), reps=3)

        def unfused():
            tiles.append(ring.ring_step(kind, a, na, b, nb))
            dst[0].copy_(b)
            dst[1].copy_(nb)

        unfused_ms = cuda_ms(unfused, reps=3)
        require(all(torch.equal(t, res["tile"]) for t in tiles),
                f"ring_step {kind} [{n_local}, {width}]: a timed launch's tile != plain")
        del tiles
        steps, nbytes = ring_cost(kind, pk.counts[:n_local], pk.counts[n_local : 2 * n_local],
                                  res["tile"].cpu().numpy(), width, copy=True)
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = steps / SCALAR_OPS_PER_S * 1e3
        entries[label] = {"shape": [n_local, width], "ms": ms, "plain_ms": res["plain_ms"],
                          "unfused_ms": unfused_ms, "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                          "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
                          "walk_steps": steps, "bytes": nbytes}
        log(f"ring_step {kind} [{n_local}, {width}]: equals the plain version (tile, copied operand, no-copy "
            f"step); {json.dumps(entries[label])}")

    entries = {}
    # Mash: phase 5's 10 000 genomes over RING_POSITIONS positions; containment: cluster A's 2000
    pack_a = beyond_pack(gs_beyond, planted_beyond, "A")
    for kind, pk in (("mash", packed), ("containment", pack_a)):
        timed(kind, pk, pk.n // RING_POSITIONS, kind)

    # a ragged block (rows cut short, some empty) and a block padded because
    # N is not a multiple of D (cluster B's 1300 genomes over 3 positions)
    rng = np.random.default_rng(17)
    n_local = packed.n // RING_POSITIONS
    rag, rag_n = packed.ids[:n_local].copy(), packed.counts[:n_local].copy()
    for r in rng.choice(n_local, size=n_local // 4, replace=False):
        keep = 0 if r % 9 == 0 else int(rng.integers(1, rag.shape[1]))
        rag[r, keep:] = PAD_ID
        rag_n[r] = min(keep, rag_n[r])
    a, na, b, nb = blocks(np.concatenate([rag, packed.ids[n_local : 2 * n_local]]),
                          np.concatenate([rag_n, packed.counts[n_local : 2 * n_local]]), n_local, 0, 1)
    check_ring_step("mash", a, na, b, nb, "ragged block")
    check_ring_step("mash", b, nb, a, na, "ragged block as B")
    pack_b = beyond_pack(gs_beyond, planted_beyond, "B")
    ids_p, cnt_p = pad_packed_rows(pack_b.ids, pack_b.counts, 3)
    n_local = ids_p.shape[0] // 3
    require(n_local * 3 != pack_b.n, "cluster B should not divide over 3 positions")
    a, na, b, nb = blocks(ids_p, cnt_p, n_local, 2, 0)
    check_ring_step("containment", a, na, b, nb, f"padded block [{n_local}, {ids_p.shape[1]}]")
    check_ring_step("containment", b, nb, a, na, "padded block as B")
    # a block of n_local not a multiple of 128 (the kernel's rows past it
    # read as PAD rows) whose rows repeat ids: phase 5's rows, every id of
    # each row's first half twice (sorted), both kinds
    n_odd = 333
    rep_ids = np.full((2 * n_odd, packed.ids.shape[1]), PAD_ID, np.int32)
    for r in range(2 * n_odd):
        real = packed.ids[r][packed.ids[r] != PAD_ID]
        half = real[: len(real) // 2]
        rep_ids[r, : 2 * len(half)] = np.sort(np.concatenate([half, half]))
    rep_cnt = (rep_ids != PAD_ID).sum(axis=1).astype(np.int32)
    a, na, b, nb = blocks(rep_ids, rep_cnt, n_odd, 0, 1)
    for kind in ring.KINDS:
        check_ring_step(kind, a, na, b, nb, f"[{n_odd}, {rep_ids.shape[1]}] with repeated ids")
    log("ring_step: ragged and padded blocks equal the plain version, as A and as B; so does a "
        f"[{n_odd}, {rep_ids.shape[1]}] block of repeated ids in both kinds")

    # rows wider than a block's shared memory could stage whole (the kernel
    # stages A in pieces): a cluster of WIDE_GENOMES genomes of ~39 000
    # scaled hashes (an ~8 Mb genome at scale 200), width 65 536; the step
    # checked and timed, the Mash walk checked, and the ring over the
    # cluster held against one device's own route
    gs_w, pack_w = wide_pack()
    require(pack_w.ids.shape[1] == 1 << 16, f"wide pack has width {pack_w.ids.shape[1]}, expected 65536")
    n_local = pack_w.n // RING_POSITIONS
    timed("containment", pack_w, n_local, "containment_wide")
    check_ring_step("mash", *blocks(pack_w.ids, pack_w.counts, n_local, 1, 0), f"[{n_local}, 65536]")
    mesh = make_mesh(RING_POSITIONS, dev)
    t0 = time.perf_counter()
    got = sharded_containment_allpairs(pack_w, k=gs_w.k, mesh=mesh)
    t_ring = time.perf_counter() - t0
    before = dict(SECONDARY_PATH_COUNTS)
    t0 = time.perf_counter()
    want = containment_matrices(pack_w, gs_w.k, dev)
    t_one = time.perf_counter() - t0
    route = [p for p, c in SECONDARY_PATH_COUNTS.items() if c != before.get(p, 0)]
    require(all(x.tobytes() == y.tobytes() for x, y in zip(got, want, strict=True)),
            f"the ring's (ani, cov) at width 65536 != one device's ({route})")
    entries["containment_wide"].update(ring_s=t_ring, one_device_s=t_one, one_device_route=route)
    log(f"ring_step: width 65536 equals the plain version (containment and Mash); the {RING_POSITIONS}-position "
        f"ring over {pack_w.n} such genomes {t_ring:.2f} s, bit-identical to one device's {route} {t_one:.2f} s")

    cards = torch.cuda.device_count()
    log(f"cards: {cards}")
    if cards >= 2:
        other = torch.device("cuda", 1)
        for kind, pk in (("mash", packed), ("containment", pack_a)):
            n_loc = pk.n // RING_POSITIONS
            a, na, b, nb = blocks(pk.ids, pk.counts, n_loc, 0, 1)
            check_ring_step(kind, a, na, b, nb, "copy onto cuda:1", dst_device=other)
        log("ring_step: with the receive buffers on cuda:1, tile and copied operand equal the plain version")
    return entries


def phase_ring_primary(dev, packed, k: int) -> dict:
    """Phase 7b: the primary over RING_POSITIONS positions of the card,
    bit-identical to the single-device distance matrix."""
    import torch

    from drep_tpu_torch.ops.mash import all_vs_all_mash
    from drep_tpu_torch.parallel.allpairs import sharded_mash_allpairs
    from drep_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(RING_POSITIONS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = all_vs_all_mash(packed, k=k, device=dev)[0]
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    ringed = sharded_mash_allpairs(packed, k=k, mesh=mesh)
    t_ring = time.perf_counter() - t0
    require(ringed.tobytes() == single.tobytes(),
            f"{RING_POSITIONS}-position ring distance matrix != the single-device matrix")
    log(f"ring primary: {packed.n} genomes over {RING_POSITIONS} positions on "
        f"{sorted({str(d) for d in mesh.devices})}: sharded_mash_allpairs {t_ring:.2f} s, all_vs_all_mash "
        f"{t_single:.2f} s, distance matrices bit-identical")
    return {"ring_s": t_ring, "single_s": t_single}


# the beyond-budget clusters phase 9c re-runs: B and C, cut from A, B and
# C for the time limit (A's 2000 genomes hold ~4 M of phase 6's ~6.7 M Ndb
# and Mdb rows, whose CSV sets those phases' pace)
BEYOND_RERUN = ("B", "C")
# and phase 7c: C alone, cut from B and C for the time limit: its
# Mash primary ring runs the merge step and its containment ring the
# matmul step, so both ring kernels still launch on the path
RING_RERUN = ("C",)


def beyond_subset(gs, planted, keys):
    """(sketches, planted cluster per genome) of the beyond-budget clusters
    `keys` alone, their genomes in phase 6's order under its names."""
    from drep_tpu_torch.ingest import GenomeSketches

    keep = [i for i, p in enumerate(planted.tolist()) if list(BEYOND)[p] in keys]
    sub = GenomeSketches(names=[gs.names[i] for i in keep], gdb=gs.gdb.iloc[keep].reset_index(drop=True),
                         bottom=[gs.bottom[i] for i in keep], scaled=[gs.scaled[i] for i in keep],
                         k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale)
    return sub, planted[keep]


def read_csv_tail(path: str, first_fields: list[str], **kw):
    """A CSV's header and its lines from the first whose first field is one
    of `first_fields` on (the whole table where none is): the rows of a
    later cluster parsed without the millions of rows before them."""
    import io

    import pandas as pd

    with open(path, "rb") as f:
        data = f.read()
    head = data.index(b"\n") + 1
    hits = [h for h in (data.find(b"\n" + s.encode() + b",", head - 1) for s in first_fields) if h >= 0]
    at = min(hits) + 1 if hits else head
    return pd.read_csv(io.BytesIO(data[:head] + data[at:]), **kw)


def phase6_rows(root: str, names: list[str], cdb_only: bool = False) -> dict:
    """Phase 6's Cdb, Ndb and Mdb rows of the genomes `names` (as strings,
    as its CSV holds them; `names` in phase 6's order), primary clusters
    renumbered by first appearance: the tables a run on those genomes
    alone writes. With `cdb_only`, Cdb alone. Phase 6's Ndb and Mdb hold
    ~6.7 M rows each, tens of seconds to parse on the chip machine's host,
    so each is parsed from the first line that can hold a row of `names`
    on: Mdb is ordered by genome1 in the run's genome order (names[0] is
    its own first row's genome1, the diagonal); Ndb by primary cluster,
    each cluster's first row (query 0, reference 1) naming names[1], or
    names[0] as its reference. Where the Ndb tail lacks rows a cluster
    must have (m (m - 1) a cluster of m), the whole table is read."""
    import pandas as pd

    cdb = pd.read_csv(os.path.join(root, "data_tables", "Cdb.csv"), dtype=str)
    cdb = cdb[cdb["genome"].isin(set(names))].reset_index(drop=True)
    renum = {p: str(i) for i, p in enumerate(dict.fromkeys(cdb["primary_cluster"]), start=1)}
    cdb["secondary_cluster"] = [f"{renum[p]}_{s.rsplit('_', 1)[1]}"
                                for p, s in zip(cdb["primary_cluster"], cdb["secondary_cluster"])]
    sizes = cdb["primary_cluster"].value_counts()
    cdb["primary_cluster"] = cdb["primary_cluster"].map(renum)
    if cdb_only:
        return {"Cdb": cdb}
    path = os.path.join(root, "data_tables", "Ndb.csv")
    for ndb in (read_csv_tail(path, names[:2], dtype=str), None):
        ndb = pd.read_csv(path, dtype=str) if ndb is None else ndb
        ndb = ndb[ndb["primary_cluster"].isin(set(renum))].reset_index(drop=True)
        if len(ndb) == int((sizes * (sizes - 1)).sum()):
            break
    ndb["primary_cluster"] = ndb["primary_cluster"].map(renum)
    mdb = read_csv_tail(os.path.join(root, "data_tables", "Mdb.csv"), names[:1])
    mdb = mdb[mdb["genome1"].isin(set(names)) & mdb["genome2"].isin(set(names))].reset_index(drop=True)
    return {"Cdb": cdb, "Ndb": ndb, "Mdb": mdb}


def phase_ring_path(tmp: str, dev, gs, planted, beyond: dict) -> dict:
    """Phase 7c: phase 6's d_cluster_wrapper again on clusters
    RING_RERUN with mesh_shape=RING_POSITIONS (choose and evaluate read
    only tables held equal here, so they are not run again)."""
    import pandas as pd

    sub, _ = beyond_subset(gs, planted, RING_RERUN)
    wd, bdb = beyond_workdir(tmp, "beyond_mesh_wd", sub)
    _, launches, paths, stages, t_cluster = run_beyond(
        wd, bdb, dev, f"ring path (mesh_shape={RING_POSITIONS}, clusters {RING_RERUN})", choose=False,
        mesh_shape=RING_POSITIONS)
    require(paths == {"mesh_ring": len(RING_RERUN)}, f"mesh run's secondary routes {paths}")
    require(launches["ring_step"] > 0 and launches["ring_step_mm"] > 0,
            f"mesh run launched no merge or no matmul ring step: {launches}")
    want = phase6_rows(beyond["wd"], sub.names)

    def table(name: str, **kw):
        return pd.read_csv(os.path.join(wd.location, "data_tables", f"{name}.csv"), **kw)

    for name in ("Cdb", "Ndb"):
        require(table(name, dtype=str).equals(want[name]), f"mesh run's {name} != the single-device run's rows")
    got = table("Mdb")
    require(got[["genome1", "genome2"]].equals(want["Mdb"][["genome1", "genome2"]]), "mesh run's Mdb pairs differ")
    err = float(np.abs(got["dist"].to_numpy() - want["Mdb"]["dist"].to_numpy()).max()) if len(got) else 0.0
    require(err <= 1e-7, f"mesh run's Mdb distances differ by {err}")
    log(f"ring path: Cdb and Ndb equal to phase 6's rows of clusters {RING_RERUN} (primary clusters renumbered), "
        f"Mdb max |diff| {err}; d_cluster_wrapper {t_cluster:.2f} s")
    return {"launches": launches, "stages": stages, "d_cluster_s": t_cluster, "mdb_max_abs_err": err,
            "clusters": list(RING_RERUN)}


def mm_library_tile(a, b, v_pad: int):
    """The yardstick for the matmul step: the same tile by library calls,
    the scatter_ of indicator_plain and torch._int_mm, over vocabulary
    chunks of 2^22 ids (rows padded with PAD_ID rows to a multiple of 8,
    as _int_mm asks)."""
    import torch

    from drep_tpu_torch.ops.indicator import indicator_plain
    from drep_tpu_torch.ops.minhash import PAD_ID

    n, width = a.shape
    pad = torch.full(((-n) % 8, width), int(PAD_ID), dtype=torch.int32, device=a.device)
    a8, b8 = torch.cat([a, pad]), torch.cat([b, pad])
    chunk = min(v_pad, 1 << 22)
    tile = torch.zeros((a8.shape[0], b8.shape[0]), dtype=torch.int32, device=a.device)
    for base in range(0, v_pad, chunk):
        ia, ib = (indicator_plain(torch.where((x >= base) & (x < base + chunk), x - base, int(PAD_ID)), chunk)
                  for x in (a8, b8))
        tile += torch._int_mm(ia, ib.T)
    return tile[:n, :n]


def phase_ring_matmul(dev, gs_beyond, planted_beyond, beyond: dict) -> dict:
    """Phase 7d: the matmul ring step against its plain version and the
    merge step at the ring's block shapes, timed beside its bound, its
    plain version, the library yardstick and the merge step; then the
    matmul ring over clusters A, B and C byte-identical to the merge ring
    and to phase 6's one-device (ani, cov)."""
    import torch

    from drep_tpu_torch.ops import ring
    from drep_tpu_torch.ops.minhash import PAD_ID
    from drep_tpu_torch.parallel.allpairs import sharded_containment_allpairs
    from drep_tpu_torch.parallel.mesh import make_mesh

    shapes = {}
    packs = {key: beyond_pack(gs_beyond, planted_beyond, key) for key in BEYOND}
    packs["wide"] = wide_pack()[1]
    for label, pk in packs.items():
        n_local = pk.n // RING_POSITIONS
        v_pad = ring.matmul_ring_vocab_pad(pk.ids)
        a, na, b, nb = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
            pk.ids[:n_local], pk.counts[:n_local], pk.ids[n_local : 2 * n_local], pk.counts[n_local : 2 * n_local]))
        what = f"ring_step_mm {label} [{n_local}, {pk.ids.shape[1]}] v_pad {v_pad}"
        dst = (torch.full_like(b, -7), torch.full_like(nb, -7))
        got = ring.ring_step_matmul(a, na, b, nb, v_pad, *dst)
        want, plain_ms = cuda_timed(lambda: ring.ring_step_matmul_plain(a, na, b, nb, v_pad))
        require(torch.equal(got, want), f"{what}: tile != plain")
        require(torch.equal(dst[0], b) and torch.equal(dst[1], nb), f"{what}: copied operand != B")
        require(torch.equal(ring.ring_step_matmul(a, na, b, nb, v_pad), want), f"{what}: step without a copy != plain")
        require(torch.equal(ring.ring_step("containment", a, na, b, nb), want), f"{what}: tile != the merge step's")
        lib, library_ms = cuda_timed(lambda: mm_library_tile(a, b, v_pad))
        require(torch.equal(lib, want), f"{what}: the library yardstick's tile != plain")
        del lib, want
        plain_tile = got.clone()
        timed = {"matmul": [], "merge": []}
        ms = cuda_ms(lambda: timed["matmul"].append(ring.ring_step_matmul(a, na, b, nb, v_pad, *dst)), reps=3)
        merge_ms = cuda_ms(lambda: timed["merge"].append(ring.ring_step("containment", a, na, b, nb, *dst)), reps=3)
        require(all(torch.equal(t, plain_tile) for ts in timed.values() for t in ts),
                f"{what}: a timed launch's tile (matmul or merge step) != plain")
        del timed, plain_tile
        # the bound of the function, the same |A ∩ B| tile and copy as the
        # merge step's (row 5a): its compare-and-advance steps at the
        # scalar peak or its bytes at the HBM rate, whichever is longer
        steps, nbytes = ring_cost("containment", pk.counts[:n_local], pk.counts[n_local : 2 * n_local],
                                  got.cpu().numpy(), pk.ids.shape[1], copy=True)
        bound_ops_ms = steps / SCALAR_OPS_PER_S * 1e3
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # apart from it, the least time of this kernel's own formulation:
        # 2 n^2 x extent int8 operations at the tensor-core peak, extent
        # being the two blocks' largest real id + 1
        real = pk.ids[: 2 * n_local][pk.ids[: 2 * n_local] != PAD_ID]
        extent = int(real.max()) + 1 if real.size else 0
        tc_ops = 2 * n_local * n_local * extent
        shapes[label] = {"shape": [n_local, int(pk.ids.shape[1])], "v_pad": v_pad, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": max(bound_ops_ms, bound_bytes_ms),
                         "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
                         "steps": steps, "bytes": nbytes, "extent": extent, "tensor_core_ops": tc_ops,
                         "tensor_core_bound_ms": tc_ops / INT8_TENSOR_OPS_PER_S * 1e3,
                         "library_ms": library_ms, "merge_step_ms": merge_ms}
        log(f"{what}: equals the plain version (tile, copied operand, no-copy step) and the merge step; "
            f"{json.dumps(shapes[label])}")

    mesh = make_mesh(RING_POSITIONS, dev)
    rings = {}
    for key in BEYOND:
        pk = packs[key]
        runs = {}
        for variant in ("matmul", "merge"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[variant] = sharded_containment_allpairs(pk, k=gs_beyond.k, mesh=mesh, variant=variant)
            runs[variant + "_s"] = time.perf_counter() - t0
        require(all(x.tobytes() == y.tobytes() == z.tobytes()
                    for x, y, z in zip(runs["matmul"], runs["merge"], beyond["ani_cov"][key], strict=True)),
                f"ring over cluster {key}: the matmul ring's (ani, cov) != the merge ring's or phase 6's")
        rings[key] = {"matmul_ring_s": runs["matmul_s"], "merge_ring_s": runs["merge_s"]}
        log(f"ring_step_mm: cluster {key} ({pk.n} genomes) over {RING_POSITIONS} positions: the matmul ring's "
            f"(ani, cov) byte-identical to the merge ring's and to phase 6's one device; {json.dumps(rings[key])}")
    return {"shapes": shapes, "rings": rings}


def phase_streaming_auto(tmp: str, dev, plant: "Planting") -> dict:
    """Phase 8a: STREAM_GENOMES planted genomes through d_cluster_wrapper
    with default arguments (the streaming switch; choose and evaluate cut
    for the time limit: they read only the tables held here);
    then the kernel on stripe 0 timed beside its bound and held against
    its plain version on a 512x512 block."""
    import pandas as pd
    import torch

    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.ingest import save_sketch_cache
    from drep_tpu_torch.ops import mash
    from drep_tpu_torch.ops.minhash import pad_packed_rows
    from drep_tpu_torch.parallel import streaming
    from drep_tpu_torch.workdir import WorkDirectory

    n = STREAM_GENOMES
    (gs, planted), t_plant, t_wait = plant.result()
    t0 = time.perf_counter() - t_plant
    wd = WorkDirectory(os.path.join(tmp, "stream_wd"))
    # the sketch cache covers every genome: no FASTA is read
    bdb = pd.DataFrame({"genome": gs.names, "location": [os.path.join(tmp, "stream_genomes", g) for g in gs.names]})
    wd.store_db(bdb, "Bdb")
    save_sketch_cache(wd, gs)
    log(f"streaming: planted {n} genomes (MASH_sketch 1000, scaled depth {STREAM_SCALED_DEPTH}) in "
        f"{t_plant:.1f} s in its own process beside phases 1-7 (waited {t_wait:.1f} s for it), workdir "
        f"{time.perf_counter() - t0 - t_plant:.1f} s")

    # the pack and retention bound the main path hands the edge walk (the
    # spy calls the real function)
    calls = []
    real_fn = streaming.streaming_mash_edges

    def spy(packed, k, cutoff, **kw):
        calls.append((packed, k, cutoff))
        return real_fn(packed, k, cutoff, **kw)

    streaming.streaming_mash_edges = spy
    try:
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cdb = controller.d_cluster_wrapper(wd, bdb, device=dev)
        torch.cuda.synchronize()
        t_cluster = time.perf_counter() - t1
        launches = read_launches()
    finally:
        streaming.streaming_mash_edges = real_fn
    st = dict(streaming.STATS)
    stages = dict(controller.STAGE_SECONDS)
    resolved = wd.get_arguments("cluster")["primary_estimator_resolved"]
    log(f"streaming: d_cluster_wrapper {t_cluster:.2f} s; stages "
        f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; route {resolved}; walk {json.dumps(st)}; "
        f"launches {launches}")
    log(f"streaming: primary compare {st['pairs_computed']} pairs in {st['seconds']:.3f} s = "
        f"{st['pairs_computed'] / st['seconds']:.1f} pairs/s ({st['pairs_computed'] / stages['primary']:.1f} "
        f"pairs/s with the pack and linkage)")
    require(resolved == "streaming_sort", f"{n} genomes took the {resolved} route, not streaming_sort")
    require(len(calls) == 1, f"{len(calls)} streaming edge walks")
    require(launches["mash_shared"] == st["launches"] == st["stripes"] == st["n_blocks"] > 1,
            f"mash_shared launches {launches['mash_shared']} for {st['n_blocks']} stripes ({st})")
    require(launches["indicator_mm"] > 0, f"the streaming run's secondary launched no indicator_mm: {launches}")
    by_name = cdb.set_index("genome")
    prim = by_name.loc[gs.names, "primary_cluster"].to_numpy()
    sec = by_name.loc[gs.names, "secondary_cluster"].to_numpy()
    for c in np.unique(planted):
        members = planted == c
        require(len(set(prim[members])) == 1, f"planted cluster {c} split across primary clusters")
        require(len(set(sec[members])) == 1, f"planted cluster {c} split across secondary clusters")
    n_planted = len(np.unique(planted))
    require(cdb["primary_cluster"].nunique() == cdb["secondary_cluster"].nunique() == n_planted,
            "primary or secondary clusters != planted clusters")
    log(f"streaming: {n_planted} planted clusters recovered as one primary and one secondary cluster each")

    # stripe 0: the kernel over its whole column range, as the walk launched it
    packed, k, cutoff = calls[0]
    block, width = st["block"], packed.ids.shape[1]
    ids, counts = pad_packed_rows(packed.ids, packed.counts, block)
    ids_d, cnt_d = torch.from_numpy(ids).to(dev), torch.from_numpy(counts).to(dev)
    a, na = ids_d[:block], cnt_d[:block]
    shared = mash.mash_shared(a, na, ids_d, cnt_d, s_orig=width)
    ms = cuda_ms(lambda: mash.mash_shared(a, na, ids_d, cnt_d, s_orig=width), reps=3)
    keep_d = torch.from_numpy(mash.distance_table(width, k) <= cutoff).to(dev)
    stripe_ms = cuda_ms(lambda: mash.stripe_survivors(a, na, ids_d, cnt_d, width, keep_d, diag=True), reps=3)
    sh = shared.cpu().numpy()
    steps, nbytes = mash_rect_cost(sh, counts[:block], counts, width)
    bound_ops_ms = steps / SCALAR_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rng = np.random.default_rng(8)
    m = min(512, block)
    rows = np.sort(rng.choice(block, size=m, replace=False))
    cols = np.sort(rng.choice(n, size=m, replace=False))
    plain = mash.mash_shared_plain(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        ids[rows], counts[rows], ids[cols], counts[cols])), s_orig=width)
    require(np.array_equal(sh[np.ix_(rows, cols)], plain.cpu().numpy()),
            "streaming stripe 0: a 512x512 block of the kernel's shared counts != plain")
    out = {"launches": launches["mash_shared"], "stripes": st["stripes"], "block": block,
           "stripe0_shape": [block, int(ids.shape[0]), width], "stripe0_ms": ms,
           "stripe0_bound_ms": max(bound_ops_ms, bound_bytes_ms),
           "stripe0_bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
           "stripe0_steps": steps, "stripe0_bytes": nbytes, "stripe0_with_compaction_ms": stripe_ms,
           "edge_walk_s": st["seconds"], "pairs_per_s": st["pairs_computed"] / st["seconds"],
           "d_cluster_s": t_cluster, "stages": stages}
    log(f"streaming: stripe 0 [{block} x {ids.shape[0]}] at width {width}: a 512x512 block equals the plain "
        f"version; {json.dumps({k: v for k, v in out.items() if k != 'stages'})}")
    return out


def phase_streaming_edges(tmp: str, dev, packed, k: int) -> dict:
    """Phases 8b and 8c on phase 5's pack: the streaming edges against the
    dense matrix, the pruned walk against the dense walk, then a resume
    after deleting half the shards."""
    import glob

    from drep_tpu_torch.ops.lsh import build_candidates
    from drep_tpu_torch.ops.mash import all_vs_all_mash
    from drep_tpu_torch.parallel import streaming

    n = packed.n
    keep = streaming.retention_bound(0.1, 0.25, "average")
    t0 = time.perf_counter()
    dist, _ = all_vs_all_mash(packed, k=k, device=dev)
    t_dense = time.perf_counter() - t0
    wi, wj = np.nonzero(np.triu(dist <= keep, 1))
    ck = os.path.join(tmp, "stream_store")
    t0 = time.perf_counter()
    dense = streaming.streaming_mash_edges(packed, k, keep, checkpoint_dir=ck, device=dev)
    t_walk = time.perf_counter() - t0
    st_dense = dict(streaming.STATS)
    ii, jj, dd, pairs = dense
    order = np.lexsort((jj, ii))
    require(np.array_equal(ii[order], wi) and np.array_equal(jj[order], wj),
            f"streaming edges at keep {keep} != the dense matrix's pairs")
    require(dd[order].tobytes() == dist[wi, wj].tobytes(), "streaming edge distances != the dense matrix's entries")
    require(pairs == n * (n - 1) // 2, f"dense walk computed {pairs} pairs")
    log(f"streaming edges: {len(ii)} edges at keep {keep} over {n} genomes bit-identical to all_vs_all_mash "
        f"thresholded there; walk {t_walk:.2f} s ({st_dense['launches']} launches), dense matrix {t_dense:.2f} s")

    t0 = time.perf_counter()
    cand = build_candidates(packed, keep=keep, k=k)
    t_cand = time.perf_counter() - t0
    t0 = time.perf_counter()
    pruned = streaming.streaming_mash_edges(packed, k, keep, prune=cand, device=dev)
    t_pruned = time.perf_counter() - t0
    st_pruned = dict(streaming.STATS)
    require(all(x.tobytes() == y.tobytes() for x, y in zip(pruned[:3], dense[:3])),
            "the pruned walk's edges != the dense walk's")
    require(st_pruned["tiles_skipped"] > 0, "the pruned walk skipped no tile")
    log(f"streaming edges: the LSH-pruned walk bit-identical to the dense walk; {cand.n_candidates} candidates "
        f"in {t_cand:.2f} s, walk {t_pruned:.2f} s: {st_pruned['tiles_computed']} tiles computed, "
        f"{st_pruned['tiles_skipped']} skipped, {st_pruned['launches']} launches, {pruned[3]} pairs")

    shards = sorted(glob.glob(os.path.join(ck, "row_*.npz")))
    require(len(shards) == st_dense["n_blocks"], f"{len(shards)} shards for {st_dense['n_blocks']} stripes")
    block, n_blocks = st_dense["block"], st_dense["n_blocks"]
    deleted = list(range(0, n_blocks, 2))
    for bi in deleted:
        os.remove(shards[bi])
    want = sum(streaming._real_pairs_in_tile(bi * block, bj * block, block, n)
               for bi in deleted for bj in range(bi, n_blocks))
    t0 = time.perf_counter()
    again = streaming.streaming_mash_edges(packed, k, keep, checkpoint_dir=ck, device=dev)
    t_resume = time.perf_counter() - t0
    require(all(x.tobytes() == y.tobytes() for x, y in zip(again[:3], dense[:3])), "resumed edges != the first run's")
    require(again[3] == want, f"resume computed {again[3]} pairs, the deleted stripes hold {want}")
    log(f"streaming resume: {len(deleted)} of {n_blocks} shards deleted; rerun {t_resume:.2f} s recomputed "
        f"{again[3]} pairs (the deleted stripes' {want}), edges identical")
    return {"edges": len(ii), "walk_s": t_walk, "dense_s": t_dense, "candidates_s": t_cand,
            "pruned_walk_s": t_pruned, "tiles_computed": st_pruned["tiles_computed"],
            "tiles_skipped": st_pruned["tiles_skipped"], "resume_s": t_resume, "resume_pairs": again[3],
            "keep": keep, "edge_arrays": dense[:3]}


# phase 9: the options of ROADMAP queue 1 item 9a on phases 5's and 6's
# genomes. The cut of phase 5's genomes that 9a, 9b, 9c's batched route
# and 9d run on: the tertiary Ndb holds every cross-primary pair of
# representatives (~12 M rows at 10 000 genomes, ~2 minutes of CSV on the
# chip machine's host), so 9d takes the first 2 500 genomes (~0.8 M
# rows), and the others the same genomes for the time limit (9a and 9b
# to make room for phase 12); the multiround chunk, a fifth of them
MULTIROUND_CHUNK = 500
PREFIX_OPTION_GENOMES = 2_500


def run_option(wd, bdb, dev, what: str, **kw):
    """d_cluster_wrapper on `wd` with the launch counts zeroed just before:
    (Cdb, launches, stage seconds, stage pairs, seconds)."""
    import torch

    from drep_tpu_torch.cluster import controller

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cdb = controller.d_cluster_wrapper(wd, bdb, device=dev, mesh_shape=1, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    stages, pairs = dict(controller.STAGE_SECONDS), dict(controller.STAGE_PAIRS)
    log(f"{what}: d_cluster_wrapper {dt:.2f} s; stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
        f"pairs {pairs}; launches { {k: v for k, v in launches.items() if v} }")
    return cdb, launches, stages, pairs, dt


def same_partition(got: np.ndarray, want: np.ndarray) -> int:
    """-1 where two label arrays are one partition up to renumbering, else
    the first position where they part."""
    fwd, back = {}, {}
    for i, (g, w) in enumerate(zip(got.tolist(), want.tolist())):
        if fwd.setdefault(g, w) != w or back.setdefault(w, g) != g:
            return i
    return -1


def require_planted(cdb, names, planted, column: str, what: str) -> None:
    """Every planted cluster is one `column` cluster, and no two share one."""
    labels = cdb.set_index("genome").loc[names, column].to_numpy()
    require(len(set(zip(planted.tolist(), labels.tolist()))) == len(set(planted.tolist())) == len(set(labels.tolist())),
            f"{what}: the planted clusters are not the {column}s")


def phase_matmul_estimator(tmp: str, dev, real: dict) -> dict:
    """Phase 9a: --primary_estimator matmul on phase 5's first
    PREFIX_OPTION_GENOMES genomes."""
    import torch

    from drep_tpu_torch.cluster import engines
    from drep_tpu_torch.ops import containment, intersect, minhash_matmul
    from drep_tpu_torch.ops import indicator as ind_mod
    from drep_tpu_torch.ops.mash import all_vs_all_mash
    from drep_tpu_torch.ops.minhash import ids_to_device

    from drep_tpu_torch.ops.minhash import pack_sketches

    gs, n = real["gs"], PREFIX_OPTION_GENOMES
    packed = pack_sketches(gs.bottom[:n], gs.names[:n], gs.sketch_size)
    m_pad = -(-n // minhash_matmul.ROW_PAD) * minhash_matmul.ROW_PAD
    chunks, v_chunk = containment.vocab_chunks(packed, m_pad)
    # the estimator's Jaccard and its [N, N] counts, as the main path
    # computes them (the spies call the real functions)
    out = {}
    real_fn, real_counts = engines.all_vs_all_mash_matmul, minhash_matmul.intersections_chunked

    def spy(p, k, device):
        out["dist"], out["jac"] = real_fn(p, k=k, device=device)
        return out["dist"], out["jac"]

    def counts_spy(p, device, m_pad=None):
        out["inter"] = real_counts(p, device, m_pad=m_pad)
        return out["inter"]

    wd, bdb = prefix_workdir(tmp, "p9a_wd", real, n)
    engines.all_vs_all_mash_matmul, minhash_matmul.intersections_chunked = spy, counts_spy
    try:
        cdb, launches, stages, pairs, dt = run_option(wd, bdb, dev, f"9a matmul estimator on {n} genomes",
                                                      primary_estimator="matmul", SkipSecondary=True)
    finally:
        engines.all_vs_all_mash_matmul, minhash_matmul.intersections_chunked = real_fn, real_counts
    parts = dict(minhash_matmul.STAGE_SECONDS)
    require(launches["indicator_mm"] == chunks.shape[0] > 1 and launches["mash_shared"] == 0,
            f"9a: {launches} for {chunks.shape[0]} vocabulary chunks")
    require(wd.get_arguments("cluster")["primary_estimator_resolved"] == "matmul", "9a did not resolve to matmul")
    require_planted(cdb, gs.names[:n], real["planted"][:n], "primary_cluster", "9a")
    want_cdb = real["cdb"].set_index("genome").loc[cdb["genome"], "primary_cluster"].to_numpy()
    require(same_partition(cdb["primary_cluster"].to_numpy(), want_cdb) < 0, "9a: primary != phase 5's")

    # the whole [N, N] counts against the merge-intersect kernel's (an
    # independent kernel of the same |A ∩ B|), and one chunk's launch
    # against the plain version on the card
    t = time.perf_counter()
    merged = intersect.intersect_counts_self(packed.ids, dev)
    t_merge = time.perf_counter() - t
    require(np.array_equal(out.pop("inter"), merged), "9a: the chunked indicator counts != intersect.cu's")
    del merged
    c0 = ids_to_device(chunks[0], dev)
    want, plain_ms = cuda_timed(lambda: ind_mod.indicator_intersections_plain(c0, v_chunk))
    acc = torch.zeros((m_pad, m_pad), dtype=torch.int32, device=dev)
    require(torch.equal(ind_mod.indicator_intersections(c0, v_chunk, out=acc), want), "9a: chunk 0 != plain")
    del want

    def one_chunk():
        acc.zero_()
        ind_mod.indicator_intersections(c0, v_chunk, out=acc)

    zero_ms = cuda_ms(acc.zero_, reps=5)
    chunk = {"shape": [*c0.shape, v_chunk], "dtype": str(c0.dtype), "chunks": int(chunks.shape[0]),
             "walk": "dense" if ind_mod.dense_walk(c0.shape[1], v_chunk) else "sparse",
             "ids_per_row_chunk": ids_per_row_chunk(c0, v_chunk),
             "ms": cuda_ms(one_chunk, reps=5) - zero_ms, "plain_ms": plain_ms, **mm_bounds(c0, v_chunk),
             "library_ms": cuda_ms(lambda: ind_mod.indicator_intersections_plain(c0, v_chunk), reps=3)}
    del acc, c0

    # the estimators agree within tests/test_minhash_matmul.py's 0.06 in Jaccard
    _, jac_sort = all_vs_all_mash(packed, k=real["k"], device=dev)
    jac_diff = float(np.abs(out["jac"] - jac_sort).max())
    require(jac_diff < 0.06, f"9a: matmul Jaccard off the sort estimator's by {jac_diff}")
    res = {"launches": launches, "d_cluster_s": dt, "stages": stages, "estimator_s": parts,
           "merge_counts_s": t_merge, "jaccard_max_diff_vs_sort": jac_diff,
           "chunk0": chunk}
    log(f"9a: {chunks.shape[0]} indicator_mm launches (one a vocabulary chunk); primary == phase 5's; [N, N] counts "
        f"== intersect.cu's; chunk 0 == plain; {json.dumps(res)}")
    return res


def phase_multiround(tmp: str, dev, real: dict) -> dict:
    """Phase 9b: --multiround_primary_clustering on phase 5's first
    PREFIX_OPTION_GENOMES genomes in chunks of MULTIROUND_CHUNK."""
    n = PREFIX_OPTION_GENOMES
    wd, bdb = prefix_workdir(tmp, "p9b_wd", real, n)
    cdb, launches, stages, pairs, dt = run_option(
        wd, bdb, dev, f"9b multiround on {n} genomes", multiround_primary_clustering=True,
        primary_chunksize=MULTIROUND_CHUNK, SkipSecondary=True)
    want_launches = -(-n // MULTIROUND_CHUNK) + 1
    require(launches["mash_shared"] == want_launches and launches["indicator_mm"] == 0,
            f"9b: {launches}, expected {want_launches} mash_shared launches")
    require(not wd.hasDb("Mdb"), "9b wrote an Mdb")
    want = real["cdb"].set_index("genome").loc[cdb["genome"], "primary_cluster"].to_numpy()
    first = same_partition(cdb["primary_cluster"].to_numpy(), want)
    require(first < 0, f"9b: the multiround partition parts from phase 5's dense primary at genome "
            f"{cdb['genome'].iloc[max(first, 0)]} (multiround {cdb['primary_cluster'].iloc[max(first, 0)]}, "
            f"dense {want[max(first, 0)]})")
    log(f"9b: {launches['mash_shared']} mash_shared launches; the partition equals phase 5's dense primary; "
        f"{pairs['primary_compare']} pairs in {stages['primary_compare']:.2f} s")
    return {"launches": launches, "d_cluster_s": dt, "stages": stages, "pairs": pairs}


def mm_rect_bounds(a, b, v_pad: int) -> dict:
    """The rectangular entry's two bounds on [na, W] x [nb, W] ids: the
    function's (both packs read once, the [na, nb] int32 counts written
    once, at the HBM rate) and its tensor-core formulation's (2 x 128^2 x
    v_pad int8 operations an output tile, at the int8 peak)."""
    na, nb = a.shape[0], b.shape[0]
    bytes_ms = ((a.numel() + b.numel()) * a.element_size() + 4 * na * nb) / HBM_BYTES_PER_S * 1e3
    tiles = -(-na // 128) * -(-nb // 128)
    return {"bound_ms": bytes_ms, "bound_by": "bytes",
            "tensor_core_bound_ms": tiles * 2 * 128 * 128 * v_pad / INT8_TENSOR_OPS_PER_S * 1e3}


def check_rect(a, b, v_pad: int, what: str) -> dict:
    """The rectangular entry at one of the path's shapes: both walks forced
    equal to the plain version, then kernel, plain and library timed."""
    import torch

    from drep_tpu_torch.ops import indicator as ind_mod

    want, plain_ms = cuda_timed(lambda: ind_mod.indicator_rect_intersections_plain(a, b, v_pad))
    out = torch.zeros_like(want)
    for dense in (True, False):
        out.zero_()
        ind_mod._launch_rect(a, b, v_pad, out, dense)
        require(torch.equal(out, want), f"indicator_mm_rect {what}, {'dense' if dense else 'sparse'} walk != plain")
    require(torch.equal(ind_mod.indicator_rect_intersections(a, b, v_pad), want), f"indicator_mm_rect {what} != plain")

    def run(dense):
        out.zero_()
        ind_mod._launch_rect(a, b, v_pad, out, dense)

    zero_ms = cuda_ms(out.zero_, reps=20)
    walks = {"dense": [], "sparse": []}
    for walk in ("dense", "sparse", "sparse", "dense"):
        walks[walk].append(cuda_ms(lambda: run(walk == "dense"), reps=20) - zero_ms)
    picked = "dense" if ind_mod.dense_walk(max(a.shape[1], b.shape[1]), v_pad) else "sparse"
    return {"shape": [int(a.shape[0]), int(b.shape[0]), int(a.shape[1]), v_pad], "walk": picked,
            "ids_per_row_chunk": ids_per_row_chunk(a, v_pad), "ms": sum(walks[picked]) / 2, "plain_ms": plain_ms,
            **mm_rect_bounds(a, b, v_pad),
            "library_ms": cuda_ms(lambda: ind_mod.indicator_rect_intersections_plain(a, b, v_pad), reps=5),
            "walks_ms": {k: sum(v) / 2 for k, v in walks.items()}}


def phase_greedy(tmp: str, dev, real: dict, gs_beyond, planted_beyond, beyond: dict) -> dict:
    """Phase 9c: --greedy_secondary_clustering on phase 6's clusters
    BEYOND_RERUN (past SMALL_CLUSTER_MAX: greedy_secondary_cluster on the
    rectangular kernel) and on phase 5's first PREFIX_OPTION_GENOMES
    genomes (every cluster small: the batched route)."""
    import torch

    from drep_tpu_torch.cluster import controller, greedy
    from drep_tpu_torch.ops import containment

    # each large cluster's (pc, indices, kw, result) and its first block x
    # rep-tile operands, as the path hands them to the rectangular kernel
    runs, first_rect = {}, {}
    real_greedy, real_rect = controller.greedy_secondary_cluster, containment.indicator_rect_intersections
    current = []

    def greedy_spy(gs, bdb, indices, pc, kw):
        current[:] = [pc]
        res = real_greedy(gs, bdb, indices, pc, kw)
        runs[pc] = (list(indices), dict(kw), res)
        return res

    def rect_spy(a, b, v_pad, out=None):
        first_rect.setdefault(current[0], (a, b, v_pad))
        return real_rect(a, b, v_pad, out=out)

    gs6, planted6 = beyond_subset(gs_beyond, planted_beyond, BEYOND_RERUN)
    wd6, bdb6 = beyond_workdir(tmp, "p9c6_wd", gs6)
    greedy.GREEDY_TIMINGS.clear()
    controller.greedy_secondary_cluster, containment.indicator_rect_intersections = greedy_spy, rect_spy
    try:
        cdb6, launches6, stages6, pairs6, dt6 = run_option(wd6, bdb6, dev, "9c greedy on phase 6's clusters B and C",
                                                           greedy_secondary_clustering=True)
    finally:
        controller.greedy_secondary_cluster, containment.indicator_rect_intersections = real_greedy, real_rect
    timings = dict(greedy.GREEDY_TIMINGS)
    require(len(runs) == len(BEYOND_RERUN) and launches6["indicator_mm_rect"] > 0 and launches6["indicator_mm"] > 0,
            f"9c: {len(runs)} clusters took greedy_secondary_cluster; launches {launches6}")
    require(pairs6["secondary_compare"] == len(wd6.get_db("Ndb")), "9c: the pair counter != the Ndb rows")
    by = cdb6.set_index("genome")
    for i, (key, (n, _, _, route)) in enumerate(BEYOND.items()):
        if key not in BEYOND_RERUN:
            continue
        sec = by.loc[np.array(gs6.names)[planted6 == i], "secondary_cluster"]
        want = n if route == "pallas_range" else 1
        require(sec.nunique() == want, f"9c: cluster {key} in {sec.nunique()} greedy clusters, expected {want}")
    want_primary = phase6_rows(beyond["wd"], gs6.names, cdb_only=True)["Cdb"]["primary_cluster"].astype(int).tolist()
    require(cdb6["primary_cluster"].tolist() == want_primary, "9c: phase 6's primary changed")

    # cluster B on the host: the port's own CPU run, byte for byte
    key_b = list(BEYOND).index("B")
    pc_b = int(by.loc[gs6.names[int(np.flatnonzero(planted6 == key_b)[0])], "primary_cluster"])
    indices, kw, (ndb_b, labels_b) = runs[pc_b]
    t = time.perf_counter()
    cpu_ndb, cpu_labels = real_greedy(gs6, bdb6, indices, pc_b, {**kw, "device": torch.device("cpu")})
    t_cpu = time.perf_counter() - t
    require(ndb_b.to_csv(index=False) == cpu_ndb.to_csv(index=False) and np.array_equal(labels_b, cpu_labels),
            "9c: cluster B's greedy Ndb/labels on the card != the CPU run's")
    log(f"9c: cluster B ({len(indices)} genomes, {len(ndb_b)} Ndb rows) byte-identical to its CPU run "
        f"({t_cpu:.1f} s on the host)")

    rect = {}
    for pc, (a, b, v_pad) in sorted(first_rect.items()):
        key = list(BEYOND)[int(planted6[runs[pc][0][0]])]
        rect[key] = check_rect(a, b, v_pad, f"cluster {key}'s first block x rep tile")
        log(f"9c: indicator_mm_rect on cluster {key}'s first block x rep tile equals the plain version (both "
            f"walks); {json.dumps(rect[key])}")

    m = PREFIX_OPTION_GENOMES
    wd5, bdb5 = prefix_workdir(tmp, "p9c5_wd", real, m)
    cdb5, launches5, stages5, pairs5, dt5 = run_option(wd5, bdb5, dev, f"9c greedy on phase 5's first {m} genomes",
                                                       greedy_secondary_clustering=True)
    require(launches5["indicator_mm"] > 0 and launches5["indicator_mm_rect"] == 0,
            f"9c: phase 5's small clusters left the batched route: {launches5}")
    require(cdb5.to_csv(index=False) == real["cdb"].iloc[:m].to_csv(index=False),
            f"9c: the greedy Cdb of phase 5's first {m} genomes != phase 5's rows")
    log(f"9c: phase 5's clusters took the batched route ({launches5['indicator_mm']} indicator_mm launches) and "
        f"Cdb equals phase 5's first {m} rows")
    return {"launches": launches6, "d_cluster_s": dt6, "stages": stages6, "pairs": pairs6, "timings": timings,
            "cluster_B_cpu_s": t_cpu, "rect": rect, "phase5": {"launches": launches5, "d_cluster_s": dt5,
                                                               "stages": stages5, "pairs": pairs5}}


def prefix_workdir(tmp: str, name: str, real: dict, m: int):
    """(WorkDirectory, Bdb) holding the sketch cache of phase 5's first `m`
    genomes."""
    from drep_tpu_torch.ingest import GenomeSketches, save_sketch_cache
    from drep_tpu_torch.workdir import WorkDirectory

    gs = real["gs"]
    cut = GenomeSketches(names=gs.names[:m], gdb=gs.gdb.iloc[:m].reset_index(drop=True), bottom=gs.bottom[:m],
                         scaled=gs.scaled[:m], k=gs.k, sketch_size=gs.sketch_size, scale=gs.scale)
    wd = WorkDirectory(os.path.join(tmp, name))
    save_sketch_cache(wd, cut)
    return wd, real["bdb"].iloc[:m].reset_index(drop=True)


def phase_tertiary(tmp: str, dev, real: dict) -> dict:
    """Phase 9d: --run_tertiary_clustering on phase 5's first
    PREFIX_OPTION_GENOMES genomes: the merges, and Cdb equal to phase 5's
    rows of those genomes wherever nothing merged."""
    m = PREFIX_OPTION_GENOMES
    wd, bdb = prefix_workdir(tmp, "p9d_wd", real, m)
    cdb, launches, stages, pairs, dt = run_option(wd, bdb, dev, "9d tertiary", run_tertiary_clustering=True)
    require(launches["mash_shared"] > 0 and launches["indicator_mm"] > 0, f"9d skipped a kernel: {launches}")
    want = real["cdb"].iloc[:m].reset_index(drop=True)
    before, after = want["secondary_cluster"], cdb["secondary_cluster"]
    merged = set(before) - set(after)
    kept = ~before.isin(merged)
    require(cdb[kept].to_csv(index=False) == want[kept].to_csv(index=False),
            "9d: Cdb rows where nothing merged != phase 5's")
    ndb = wd.get_db("Ndb")
    n_tertiary = int((ndb["primary_cluster"] == 0).sum())
    log(f"9d: {len(merged)} secondary clusters merged across primary clusters; Cdb equals phase 5's first {m} rows "
        f"where nothing merged; {n_tertiary} tertiary Ndb rows")
    return {"launches": launches, "d_cluster_s": dt, "stages": stages, "merges": len(merged),
            "tertiary_ndb_rows": n_tertiary, "genomes": m}


# phase 10: the incremental genome index (ROADMAP queue 1 item 10a),
# snapshotted from phase 5's finished workdir: the update's batch and the
# classify queries, each half near an indexed genome and half novel. The
# card-against-CPU comparisons run on a prefix index of phase 5's first
# INDEX_PREFIX genomes at streaming block INDEX_PREFIX_BLOCK, cut from
# 10 000 genomes at block 1024: the plain Mash version sorts 2 x 1000 ids
# a pair on the host, ~40 s a 1024 x 1024 tile, and the 10 000-genome
# update's rectangle is 20 such tiles
INDEX_NEW = 512
INDEX_QUERIES = 64
INDEX_CPU_QUERIES = 8
INDEX_PREFIX = 512
INDEX_PREFIX_BLOCK = 128


def plant_near(gs, sources, n_novel: int, seed: int, stem: str, gdir: str):
    """(Bdb, sketch results) of one genome near each indexed genome of
    `sources` (~92% of its bottom and ~97% of its scaled sketch, plus
    private hashes, as a planted cluster's members), then `n_novel`
    genomes of fresh hashes; names stem_0, stem_1, ..., in that order."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    s_b = gs.sketch_size
    names, results = [], {}
    for t in range(len(sources) + n_novel):
        name = f"{stem}_{t}.fasta"
        if t < len(sources):
            i = int(sources[t])
            kb, ks = gs.bottom[i], gs.scaled[i]
            kb, ks = kb[rng.random(len(kb)) < 0.92], ks[rng.random(len(ks)) < 0.97]
            n_own_s = max(1, len(gs.scaled[i]) // 25)
        else:
            kb = ks = np.empty(0, np.uint64)
            n_own_s = REAL_SCALED_DEPTH
        own_b = rng.integers(0, 2**63, size=max(1, s_b // 6) if t < len(sources) else 2 * s_b, dtype=np.uint64)
        own_s = rng.integers(0, 2**63, size=n_own_s, dtype=np.uint64)
        results[name] = {"length": 4_000_000, "N50": 50_000, "contigs": 100, "n_kmers": 3_900_000,
                         "bottom": np.unique(np.concatenate([kb, own_b]))[:s_b],
                         "scaled": np.unique(np.concatenate([ks, own_s]))}
        names.append(name)
    return pd.DataFrame({"genome": names, "location": [os.path.join(gdir, g) for g in names]}), results


def tree_digest(root: str) -> dict:
    """sha256 of every file under `root`, by relative path."""
    import hashlib

    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            h = hashlib.sha256()
            with open(path, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 24), b""):
                    h.update(chunk)
            out[os.path.relpath(path, root)] = h.hexdigest()
    return out


def build_prefix_index(loc: str, params: dict, gs, n: int, dev) -> None:
    """Generation 0 of an index of `gs`'s first `n` genomes, on the card,
    through the machinery build_from_paths runs after sketching."""
    import pandas as pd

    from drep_tpu_torch.index.store import IndexStore, empty_index
    from drep_tpu_torch.index.update import _admit_batch, _rect_edges, publish_generation, recluster

    store = IndexStore(loc)
    names = gs.names[:n]
    results = {g: {**{c: int(gs.gdb[c].iloc[i]) for c in ("length", "N50", "contigs", "n_kmers")},
                   "bottom": gs.bottom[i], "scaled": gs.scaled[i]} for i, g in enumerate(names)}
    idx = empty_index(params, location=store.location)
    _admit_batch(idx, pd.DataFrame({"genome": names, "location": [f"/nonexistent/{g}" for g in names]}), results, 0)
    ii, jj, dd, _ = _rect_edges(idx, 0, store.pending_dir(0), device=dev)
    order = np.lexsort((jj, ii))
    idx.edges = (ii[order], jj[order], dd[order])
    recluster(idx, 0, device=dev)
    publish_generation(store, idx, 0, 0, idx.edges)


def phase_index(tmp: str, dev, real: dict) -> dict:
    """Phase 10: build, update and classify of the genome index."""
    import torch

    from drep_tpu_torch.cluster import engines
    from drep_tpu_torch.index import build_from_workdir, index_update, load_resident_index, resident_device
    from drep_tpu_torch.index import classify as classify_mod
    from drep_tpu_torch.index import update as upd
    from drep_tpu_torch.index.classify import SketchedQueries
    from drep_tpu_torch.ops import containment, mash
    from drep_tpu_torch.ops import indicator as ind_mod
    from drep_tpu_torch.parallel import streaming
    from drep_tpu_torch.utils.durableio import load_npz_checked, read_json_checked
    from drep_tpu_torch.workdir import WorkDirectory

    gs, n = real["gs"], len(real["gs"].names)
    t_phase = time.perf_counter()
    gdir = os.path.join(tmp, "index_genomes")  # locations only: the index reads no FASTA here
    rng = np.random.default_rng(10)
    near = np.concatenate([rng.choice(INDEX_PREFIX, INDEX_NEW // 4, replace=False),
                           rng.choice(np.arange(INDEX_PREFIX, n), INDEX_NEW // 4, replace=False)])
    batch, results = plant_near(gs, near, INDEX_NEW // 2, 11, "index_new", gdir)
    # queries: near ones (the first few near prefix genomes) then novel ones;
    # the CPU comparison takes the first few of each, moved to the front
    half, few = INDEX_QUERIES // 2, INDEX_CPU_QUERIES // 2
    q_near = np.concatenate([rng.choice(INDEX_PREFIX, few, replace=False), rng.choice(n, half - few, replace=False)])
    qb, qres = plant_near(gs, q_near, half, 12, "query:index_query", gdir)
    head = [*range(few), *range(half, half + few)]
    order = head + [t for t in range(INDEX_QUERIES) if t not in head]
    queries = SketchedQueries(admitted=qb.iloc[order].reset_index(drop=True), results=qres)
    t_plant = time.perf_counter() - t_phase

    # 10a: generation 0 from phase 5's workdir
    wd = WorkDirectory(real["wd"])
    snap = wd.get_arguments("cluster")
    require(snap is not None and wd.hasDb("Mdb"), "phase 5's workdir lacks its cluster snapshot or Mdb")
    mdb_rows = len(wd.get_db("Mdb"))
    shape = "every ordered pair" if mdb_rows == n * n else \
        "the streaming shape: both directions and the diagonal of the pairs up to max(1 - P_ani, warn_dist)"
    log(f"index build: phase 5's workdir holds its cluster argument snapshot (estimator resolved to "
        f"{snap.get('primary_estimator_resolved')!r}) and an Mdb of {mdb_rows} rows ({shape}); nothing added")
    idx_dir = os.path.join(tmp, "index")
    t0 = time.perf_counter()
    built = build_from_workdir(idx_dir, real["wd"])
    t_build = time.perf_counter() - t0
    state = load_npz_checked(os.path.join(idx_dir, "state", "state_g000000.npz"))
    cdb = real["cdb"].set_index("genome").loc[[str(x) for x in state["names"]]]
    require(np.array_equal(state["primary"], cdb["primary_cluster"].to_numpy()), "10a: primary labels != phase 5's Cdb")
    sec = [f"{p}_{s}" for p, s in zip(state["primary"], state["suffix"])]
    require(sec == list(cdb["secondary_cluster"]), "10a: secondary labels != phase 5's Cdb")
    log(f"10a index build: {built} in {t_build:.2f} s; labels equal phase 5's Cdb")

    # 10b: the update, with the tail stripes and the per-cluster launches captured
    stripes, clusters, walks = [], [], []
    real_surv, real_ind, real_walk = streaming.stripe_survivors, containment.indicator_intersections, \
        streaming.streaming_mash_edges

    def surv_spy(a, na, b, nb, s_orig, keep, diag):
        if not stripes:
            stripes.append((a, na, b, nb, s_orig))
        return real_surv(a, na, b, nb, s_orig, keep, diag)

    def ind_spy(ids, v_pad, out=None):
        clusters.append((ids, v_pad))
        return real_ind(ids, v_pad, out=out)

    def walk_spy(packed, k, cutoff, **kw):
        walks.append((packed, k, cutoff))
        return real_walk(packed, k, cutoff, **kw)

    paths_before = dict(engines.SECONDARY_PATH_COUNTS)
    streaming.stripe_survivors, containment.indicator_intersections = surv_spy, ind_spy
    streaming.streaming_mash_edges = walk_spy
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = index_update(idx_dir, None, processes=1, presketched=(batch, results), device=dev)
        torch.cuda.synchronize()
        t_update = time.perf_counter() - t0
        launches_update = read_launches()
    finally:
        streaming.stripe_survivors, containment.indicator_intersections = real_surv, real_ind
        streaming.streaming_mash_edges = real_walk
    parts = dict(upd.STATS)
    walk = dict(streaming.STATS)
    paths = {p: c - paths_before.get(p, 0) for p, c in engines.SECONDARY_PATH_COUNTS.items()
             if c - paths_before.get(p, 0)}
    shapes = [[int(ids.shape[0]), int(ids.shape[1]), v_pad] for ids, v_pad in clusters]
    log(f"10b index update: {json.dumps(summary)} in {t_update:.2f} s; parts "
        f"{json.dumps({k: round(v, 3) if isinstance(v, float) else v for k, v in parts.items()})}; launches "
        f"{launches_update}; secondary paths {paths}; per-cluster indicator_mm shapes [m_pad, W, v_pad], the "
        f"largest {max(shapes, key=lambda s: s[0] * s[1]) if shapes else None}")
    require(summary["admitted"] == INDEX_NEW and summary["generation"] == 1, f"10b: {summary}")
    require(launches_update["mash_shared"] == parts["rect_launches"] == walk["stripes"] == walk["n_blocks"] > 1,
            f"10b: {launches_update['mash_shared']} mash_shared launches for {walk['n_blocks']} tail stripes")
    require(launches_update["indicator_mm"] == parts["secondary_calls"] == len(clusters) == paths.get("one_shot")
            and set(paths) == {"one_shot"},
            f"10b: {launches_update['indicator_mm']} indicator_mm launches for {parts['secondary_calls']} dirty "
            f"clusters ({paths})")
    require(parts["secondary_calls"] >= INDEX_NEW // 4, f"10b: only {parts['secondary_calls']} dirty clusters")

    # one tail stripe's counts against the plain version on the card
    a, na, b, nb, s_orig = stripes[0]
    got = mash.mash_shared(a, na, b, nb, s_orig)
    want, stripe_plain_ms = cuda_timed(lambda: mash.mash_shared_plain(a, na, b, nb, s_orig))
    require(torch.equal(got, want), f"10b: tail stripe 0 [{a.shape[0]} x {b.shape[0]}] shared counts != plain")
    stripe_ms = cuda_ms(lambda: mash.mash_shared(a, na, b, nb, s_orig), reps=5)
    steps, nbytes = mash_rect_cost(got.cpu().numpy(), na.cpu().numpy(), nb.cpu().numpy(), s_orig)
    ops_ms, bytes_ms = steps / SCALAR_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    stripe = {"shape": [int(a.shape[0]), int(b.shape[0]), int(a.shape[1])], "ms": stripe_ms,
              "plain_ms": stripe_plain_ms, "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "steps": steps, "bytes": nbytes}
    del got, want

    # the largest dirty cluster's counts against the plain version
    ids, v_pad = max(clusters, key=lambda c: c[0].shape[0] * c[0].shape[1])
    want, cl_plain_ms = cuda_timed(lambda: ind_mod.indicator_intersections_plain(ids, v_pad))
    require(torch.equal(ind_mod.indicator_intersections(ids, v_pad), want),
            f"10b: indicator_mm on the largest dirty cluster {tuple(ids.shape)} != plain")
    largest = {"shape": [int(ids.shape[0]), int(ids.shape[1]), v_pad], "dtype": str(ids.dtype),
               "walk": "dense" if ind_mod.dense_walk(ids.shape[1], v_pad) else "sparse",
               "ms": cuda_ms(lambda: ind_mod.indicator_intersections(ids, v_pad), reps=20),
               "plain_ms": cl_plain_ms, **mm_bounds(ids, v_pad),
               "library_ms": cuda_ms(lambda: ind_mod.indicator_intersections_plain(ids, v_pad), reps=10)}
    del clusters[:], stripes[:]

    # the new edges against the plain version over the same rectangle on the card
    packed, k, cutoff = walks[0]
    n_all, n_old, width = packed.n, n, packed.ids.shape[1]
    t0 = time.perf_counter()
    ids_d = torch.from_numpy(packed.ids).to(dev)
    cnt_d = torch.from_numpy(packed.counts).to(dev)
    dist_tbl = mash.distance_table(width, k)
    keep_d = torch.from_numpy(dist_tbl <= cutoff).to(dev)
    cols = torch.arange(n_old, n_all, device=dev)
    found = []
    for r0 in range(0, n_all, 1024):
        rows = torch.arange(r0, min(r0 + 1024, n_all), device=dev)
        sh = mash.mash_shared_plain(ids_d[rows], cnt_d[rows], ids_d[n_old:], cnt_d[n_old:], width).long()
        s_use = torch.clamp(torch.minimum(cnt_d[rows, None], cnt_d[None, n_old:]), max=width).long()
        hit = keep_d[s_use, sh] & (rows[:, None] < cols[None, :])
        r, c = torch.nonzero(hit, as_tuple=True)
        found.append(torch.stack([rows[r], cols[c], s_use[r, c], sh[r, c]], 1).cpu().numpy())
    f = np.concatenate(found)
    o = np.lexsort((f[:, 1], f[:, 0]))
    f = f[o]
    edges = load_npz_checked(os.path.join(idx_dir, "edges", "edges_g000001.npz"))
    require(np.array_equal(edges["ii"], f[:, 0]) and np.array_equal(edges["jj"], f[:, 1])
            and edges["dist"].tobytes() == dist_tbl[f[:, 2], f[:, 3]].astype(np.float32).tobytes(),
            "10b: the update's new edges != the plain version's over the same rectangle")
    t_rect_plain = time.perf_counter() - t0
    del ids_d, cnt_d, packed, walks[:]
    log(f"10b: tail stripe 0 and the largest dirty cluster equal their plain versions; the {len(f)} new edges "
        f"equal the plain version's over the [{n_all} x {n_all - n_old}] rectangle ({t_rect_plain:.2f} s); "
        f"stripe {json.dumps(stripe)}; largest cluster {json.dumps(largest)}")

    # the same update of a prefix index on the card (its CPU half, 19-26 s
    # of the host's plain Mash, is cut for the time limit; 10c and phase
    # 11 compare the prefix index's classify and resident rectangle on the
    # card and the CPU)
    params = dict(read_json_checked(os.path.join(idx_dir, "manifest.json"))["params"])
    params["streaming_block"] = INDEX_PREFIX_BLOCK
    pre_gpu = os.path.join(tmp, "index_prefix_gpu")
    build_prefix_index(pre_gpu, params, gs, INDEX_PREFIX, dev)
    t0 = time.perf_counter()
    s_gpu = index_update(pre_gpu, None, processes=1, presketched=(batch, results), device=dev)
    t_pre_gpu = time.perf_counter() - t0
    require(s_gpu["admitted"] == INDEX_NEW and s_gpu["generation"] == 1, f"10b: prefix update {s_gpu}")
    log(f"10b: the update of a {INDEX_PREFIX}-genome prefix index (block {INDEX_PREFIX_BLOCK}) on the card "
        f"({t_pre_gpu:.2f} s); {json.dumps(s_gpu)}")

    # 10c: classify from one resident load, both modes, through the union
    # rectangle (phase 11 holds the daemon's resident rectangle to these
    # verdicts); the tree untouched
    t0 = time.perf_counter()
    before = tree_digest(idx_dir)
    t_digest = time.perf_counter() - t0
    t0 = time.perf_counter()
    resident = load_resident_index(idx_dir)
    t_load = time.perf_counter() - t0
    classify = {}
    union_edges = []  # the union rectangle's edges of each 10c classify
    real_resident_rect, real_rect = resident_device.rect_edges_device, classify_mod._rect_edges

    def rect_spy(*a, **kw):
        out = real_rect(*a, **kw)
        union_edges.append(out[:3])
        return out

    resident_device.rect_edges_device = lambda *a: None
    classify_mod._rect_edges = rect_spy
    try:
        classify_10c(resident, queries, pre_gpu, qres, dev, classify)
    finally:
        resident_device.rect_edges_device, classify_mod._rect_edges = real_resident_rect, real_rect
    require(tree_digest(idx_dir) == before, "10c: classify changed the index tree")
    log(f"10c: the index tree's digest is unchanged ({len(before)} files, {t_digest:.2f} s a digest)")

    out = {"build_s": t_build, "update_s": t_update, "update_parts": parts, "plant_s": t_plant,
           "rect_pairs": parts["rect_pairs"], "rect_pairs_per_s": parts["rect_pairs"] / parts["rect_s"],
           "launches_update": launches_update, "secondary_calls": len(shapes),
           "secondary_shapes_largest": largest["shape"], "rect_plain_check_s": t_rect_plain,
           "prefix": {"genomes": INDEX_PREFIX, "block": INDEX_PREFIX_BLOCK, "update_gpu_s": t_pre_gpu,
                      "classify_card_and_cpu_s": classify["card_and_cpu_s"]},
           "load_resident_s": t_load, "digest_s": t_digest,
           **{f"classify_{k}_s": classify[k]["s"] for k in ("joint", "separate")},
           "classify_separate_pack_s": classify["separate"]["pack_s"],
           "classify_separate_walk_s": classify["separate"]["walk_s"],
           "stripe": stripe, "largest_cluster": largest,
           "launches_classify": {k: classify[k]["launches"] for k in ("joint", "separate")}}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10: {json.dumps({k: v for k, v in out.items() if k not in ('stripe', 'largest_cluster')})}")
    # what phase 11 serves: the post-update store, its queries and their
    # separate-mode verdicts, the prefix index (not printed)
    out["serve_inputs"] = {"idx_dir": idx_dir, "digest": before, "queries": queries, "qres": qres,
                           "separate": classify["separate"]["verdicts"], "prefix_dir": pre_gpu,
                           "union_edges": union_edges[1],  # the separate run's
                           "joint": classify["joint"]["verdicts"], "batch": batch, "results": results,
                           "params": params}
    return out


def classify_10c(resident, queries, pre_gpu: str, qres: dict, dev, classify: dict) -> None:
    """Phase 10c's classify of INDEX_QUERIES queries from one resident
    load, joint and separate, then the first INDEX_CPU_QUERIES on the
    prefix index on the card and the CPU; fills `classify`."""
    import torch

    from drep_tpu_torch.index import classify_batch, load_resident_index
    from drep_tpu_torch.index import update as upd
    from drep_tpu_torch.index.classify import SketchedQueries
    from drep_tpu_torch.parallel import streaming

    for joint in (True, False):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdicts = classify_batch(resident, queries, processes=1, joint=joint, device=dev)
        torch.cuda.synchronize()
        key = "joint" if joint else "separate"
        classify[key] = {"s": time.perf_counter() - t0, "launches": read_launches(), "verdicts": verdicts,
                         "rect_s": upd.STATS["classify_rect_s"], "pack_s": upd.STATS["pack_s"],
                         "walk_s": upd.STATS["rect_s"]}
        novel = sum(v["novel_primary"] for v in verdicts)
        log(f"10c classify joint={joint}: {len(verdicts)} verdicts in {classify[key]['s']:.2f} s "
            f"(pack {upd.STATS['pack_s']:.2f} s, rectangle {upd.STATS['rect_s']:.2f} s); {novel} novel primary; "
            f"launches { {k: v for k, v in classify[key]['launches'].items() if v} }")
        require(len(verdicts) == INDEX_QUERIES
                and classify[key]["launches"]["mash_shared"] == streaming.STATS["n_blocks"],
                f"10c: {len(verdicts)} verdicts, launches {classify[key]['launches']}")
        require(novel == INDEX_QUERIES // 2 and not any(v["novel_primary"] for v in verdicts[:INDEX_CPU_QUERIES // 2]),
                f"10c: {novel} novel primary verdicts for {INDEX_QUERIES // 2} novel queries")
    # the first queries on the prefix index (generation 1), card against CPU
    pre = load_resident_index(pre_gpu)
    first = SketchedQueries(admitted=queries.admitted.iloc[:INDEX_CPU_QUERIES].reset_index(drop=True),
                            results=qres)
    t0 = time.perf_counter()
    for joint in (True, False):
        g = classify_batch(pre, first, processes=1, joint=joint, device=dev)
        c = classify_batch(pre, first, processes=1, joint=joint, device=torch.device("cpu"))
        require(g == c, f"10c: prefix-index verdicts (joint={joint}) on the card != on the CPU")
    classify["card_and_cpu_s"] = time.perf_counter() - t0
    log(f"10c: the first {INDEX_CPU_QUERIES} queries on the prefix index give equal verdicts on the card and the "
        f"CPU, both modes ({classify['card_and_cpu_s']:.2f} s)")


# phase 11: the serve daemon (ROADMAP queue 1 item 11a) on phase 10's
# store: concurrent clients, each sending its share of the 64 queries
SERVE_CLIENTS = 8
SERVE_WINDOW_MS = 400.0
# the budget every phase 11 and 13 request carries: a request without
# deadline_ms gets the daemon's default of 30 s, which 13b's second router
# batch of 32 can spend waiting behind the first on a slow host; past it
# the router merges with the remaining partitions unavailable and answers
# PARTIAL, by contract (ROADMAP queue 3, F7). No phase can spend 600 s
SERVE_DEADLINE_MS = 600_000.0


def serve_classify_fn(queries, dev, rect_s: list):
    """The daemon's classify core over phase 10c's presketched queries,
    looked up by path: the port's classify_batch(joint=False) itself."""
    from drep_tpu_torch.index import classify_batch, resident_device
    from drep_tpu_torch.index.classify import SketchedQueries

    row_of = {loc: i for i, loc in enumerate(queries.admitted["location"])}

    def fn(resident, paths):
        sq = SketchedQueries(admitted=queries.admitted.iloc[[row_of[p] for p in paths]].reset_index(drop=True),
                             results=queries.results)
        resident_device.STATS.pop("rect_s", None)
        verdicts = classify_batch(resident, sq, processes=1, joint=False, device=dev)
        rect_s.append(resident_device.STATS.get("rect_s"))
        # keyed by the request's basename (the planted names carry the
        # query: prefix that the verdicts drop)
        return {os.path.basename(p): v for p, v in zip(paths, verdicts)}

    return fn


def serve_clients(addr: str, paths: list[str]) -> list[dict]:
    """SERVE_CLIENTS concurrent ServeClients, each pipelining its share of
    `paths` with a budget of SERVE_DEADLINE_MS; the replies in the order
    of `paths`."""
    import threading

    from drep_tpu_torch.serve import ServeClient

    shares = [paths[c::SERVE_CLIENTS] for c in range(SERVE_CLIENTS)]
    got: dict = {}
    errors: list = []
    barrier = threading.Barrier(SERVE_CLIENTS)

    def one(c):
        try:
            with ServeClient(addr, timeout_s=600) as cl:
                barrier.wait()
                got[c] = cl.classify_many(shares[c], deadline_ms=SERVE_DEADLINE_MS)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(c,), daemon=True) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    require(not errors and not any(t.is_alive() for t in threads) and len(got) == SERVE_CLIENTS,
            f"11a: clients failed: {errors}")
    out: list = [None] * len(paths)
    for c in range(SERVE_CLIENTS):
        for k, resp in enumerate(got[c]):
            out[c + k * SERVE_CLIENTS] = resp
    return out


def phase_serve(tmp: str, dev, p10: dict) -> dict:
    """Phase 11: 11a the daemon in-process on phase 10's post-update store
    (the resident matrix on the card, 64 queries from concurrent clients,
    verdicts equal to 10c's union-path ones, one upload, one mash_shared
    launch a batch, the resident edges equal to the union edges on one
    batch, the kernel at the resident shape against its plain version and
    bound, the card against the CPU on the prefix index); 11b the CLI
    daemon as a subprocess on an index of the fixture genomes A-C."""
    import threading

    import torch

    from drep_tpu_torch.index import build_from_paths, index_classify, load_resident_index, resident_device
    from drep_tpu_torch.index.classify import SketchedQueries
    from drep_tpu_torch.ops import mash
    from drep_tpu_torch.ops.minhash import pad_packed_rows
    from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig
    from drep_tpu_torch.utils.profiling import counters

    t_phase = time.perf_counter()
    si = p10["serve_inputs"]
    idx_dir, queries = si["idx_dir"], si["queries"]
    paths = list(queries.admitted["location"])
    for p in paths:  # the daemon admits paths that exist; its classify_fn reads the presketched queries
        os.makedirs(os.path.dirname(p), exist_ok=True)
        open(p, "wb").close()

    # 11a: the daemon on the card, traced (phase 16b)
    resident_device.reset_for_tests()
    counters.reset()
    rect_s: list = []
    trace_dir = os.path.join(tmp, "trace_11a")
    with traced(trace_dir):
        t0 = time.perf_counter()
        srv = IndexServer(ServeConfig(index_loc=idx_dir, max_batch=INDEX_QUERIES, batch_window_ms=SERVE_WINDOW_MS,
                                      poll_generation_s=60.0, device=dev),
                          classify_fn=serve_classify_fn(queries, dev, rect_s))
        addr = srv.start()
        t_start = time.perf_counter() - t0
        upload_s = resident_device.STATS["upload_s"]
        loop = threading.Thread(target=srv.serve_batches, daemon=True)
        loop.start()
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resps = serve_clients(addr, paths)
            torch.cuda.synchronize()
            t_serve = time.perf_counter() - t0
            launches = read_launches()
        finally:
            srv.request_drain()
            loop.join(timeout=300)
            srv.close()
    require(not loop.is_alive(), "11a: the batch loop did not drain")
    st = srv.snapshot()
    tc = read_trace(trace_dir, "11a", t_start + t_serve)["counts"]
    require(tc.get("serve_load:B") == tc.get("serve_load:E") == tc.get("serve_start:i") == 1
            and tc.get("serve_batch:E") == st["batches_total"] and tc.get("serve_drain:i") == 1
            and tc.get("serve_stop:i") == 1, f"16b 11a: events {tc}, {st['batches_total']} batches")
    log(f"11a serve: {len(resps)} requests from {SERVE_CLIENTS} clients in {t_serve:.2f} s, "
        f"{st['batches_total']} batches; start {t_start:.2f} s (resident upload {upload_s:.2f} s); per-batch "
        f"rectangle seconds {rect_s}; launches { {k: v for k, v in launches.items() if v} }; latency_ms "
        f"{json.dumps(st['latency_ms'])}")
    bad = [r for r in resps if not (r and r.get("ok"))]
    require(not bad and st["errors_total"] == 0 and st["requests_total"] == INDEX_QUERIES,
            f"11a: {len(bad)} error replies (first {bad[:1]}), snapshot {json.dumps(st)}")
    want = {v["genome"]: v for v in si["separate"]}
    got = {r["verdict"]["genome"]: r["verdict"] for r in resps}
    require(got == want, "11a: daemon verdicts != 10c's separate-mode (union path) verdicts: "
            f"{sorted(g for g in want if got.get(g) != want[g])[:5]}")
    require(resident_device.upload_count() == 1 and resident_device.fallback_count() == 0,
            f"11a: {resident_device.upload_count()} uploads, {resident_device.fallback_count()} fallbacks")
    batches = st["batches_total"]
    require(1 <= batches < INDEX_QUERIES and launches["mash_shared"] == batches and None not in rect_s,
            f"11a: {launches['mash_shared']} mash_shared launches for {batches} batches (rect {rect_s})")
    require(launches["indicator_mm"] > 0, "11a: no indicator_mm launch in the per-query reclusters")
    require(tree_digest(idx_dir) == si["digest"], "11a: the daemon changed the index tree")

    # one batch's resident edges against the union path's, on the card,
    # on the daemon's resident index (its pack already on the card)
    resident = srv._resident
    n_old = resident.n
    sq = SketchedQueries(admitted=queries.admitted, results=queries.results)
    t0 = time.perf_counter()
    ii, jj, dd = resident_device.rect_edges_device(resident, sq, n_old, dev)
    t_resident_rect = time.perf_counter() - t0
    uii, ujj, udd = si["union_edges"]  # 10c's separate classify of the same batch
    sel = uii < n_old
    o = np.lexsort((ujj[sel], uii[sel]))
    require(np.array_equal(ii, uii[sel][o]) and np.array_equal(jj, ujj[sel][o])
            and dd.tobytes() == udd[sel][o].tobytes(),
            f"11a: resident edges ({len(ii)}) != the union path's ({int(sel.sum())})")
    require(resident_device.upload_count() == 1, "11a: the edge check uploaded the resident matrix again")
    log(f"11a: the {len(ii)} resident edges equal the union path's of 10c's separate classify bit for bit "
        f"(resident rectangle {t_resident_rect:.4f} s; 10c's union pack {p10['classify_separate_pack_s']:.2f} s + "
        f"walk {p10['classify_separate_walk_s']:.3f} s)")

    # the kernel at the resident shape: against its plain version on the card, timed, bounded
    pack = resident_device.pack_for(resident, dev)
    q_ids, q_cts = resident_device._map_queries(pack, [np.asarray(sq.results[g]["bottom"])
                                                        for g in sq.admitted["genome"]])
    q_ids, q_cts = pad_packed_rows(q_ids, q_cts, mash.TILE)
    b, nb = torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_cts).to(dev)
    got_sh = mash.mash_shared(pack.ids, pack.counts, b, nb, pack.s)
    want_sh, plain_ms = cuda_timed(lambda: mash.mash_shared_plain(pack.ids, pack.counts, b, nb, pack.s))
    require(torch.equal(got_sh, want_sh), f"11a: mash_shared at the resident shape {tuple(got_sh.shape)} != plain")
    ms = cuda_ms(lambda: mash.mash_shared(pack.ids, pack.counts, b, nb, pack.s), reps=10)
    steps, nbytes = mash_rect_cost(got_sh.cpu().numpy(), pack.cts_host, q_cts, pack.s)
    ops_ms, bytes_ms = steps / SCALAR_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    kernel = {"shape": [int(pack.ids.shape[0]), int(b.shape[0]), pack.s], "ms": ms, "plain_ms": plain_ms,
              "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
              "steps": steps, "bytes": nbytes, "max_abs_err": 0}
    del got_sh, want_sh, b, nb
    log(f"11a: mash_shared at the resident shape equals its plain version: {json.dumps(kernel)}")

    # the card against the CPU: the resident rectangle on the prefix index
    t0 = time.perf_counter()
    pre_g, pre_c = load_resident_index(si["prefix_dir"]), load_resident_index(si["prefix_dir"])
    g = resident_device.rect_edges_device(pre_g, sq, pre_g.n, dev)
    c = resident_device.rect_edges_device(pre_c, sq, pre_c.n, torch.device("cpu"))
    require(g is not None and c is not None and all(np.array_equal(x, y) for x, y in zip(g, c))
            and g[2].tobytes() == c[2].tobytes(),
            "11a: the prefix index's resident rectangle on the card != on the CPU")
    t_prefix = time.perf_counter() - t0
    log(f"11a: the resident rectangle of the {pre_g.n}-genome prefix index x {INDEX_QUERIES} queries is equal on the "
        f"card and the CPU ({len(g[0])} edges, {t_prefix:.2f} s)")

    # 11b: the CLI daemon, a subprocess on the card
    t0 = time.perf_counter()
    cli_idx = os.path.join(tmp, "serve_cli_index")
    fixture = [os.path.join(HERE, "tests", "genomes", f"genome_{x}.fasta") for x in "ABC"]
    build_from_paths(cli_idx, fixture, processes=1, device=dev)
    digest = tree_digest(cli_idx)
    want_v = index_classify(cli_idx, fixture[:1], device=dev)[0]
    sock = os.path.join(tmp, "serve.sock")
    err_path = os.path.join(tmp, "serve_cli.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "drep_tpu_torch", "index", "serve", cli_idx, "--socket", sock],
                                stdout=subprocess.PIPE, stderr=err, text=True, cwd=HERE)

    def err_tail() -> str:
        with open(err_path) as f:
            return f.read()[-3000:]

    try:
        ready_line = proc.stdout.readline()
        require(bool(ready_line), f"11b: the daemon died before its ready line (exit {proc.poll()}): {err_tail()}")
        ready = json.loads(ready_line)
        t_ready = time.perf_counter() - t0
        with ServeClient(sock, timeout_s=300) as cl:
            resp = cl.classify(fixture[0])
        require(resp["ok"] and resp["verdict"] == want_v,
                f"11b: the CLI daemon's verdict {resp} != index classify on the card {want_v}")
        proc.send_signal(15)  # SIGTERM: drain
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    require(rc == 0, f"11b: the CLI daemon exited {rc} after SIGTERM: {err_tail()}")
    require(tree_digest(cli_idx) == digest, "11b: the CLI daemon changed the index tree")
    t_cli = time.perf_counter() - t0
    log(f"11b: `index serve` subprocess ready in {t_ready:.2f} s ({json.dumps(ready)}), its verdict equals index "
        f"classify on the card, SIGTERM drained it to exit 0 with the tree unchanged ({t_cli:.2f} s)")

    out = {"start_s": t_start, "upload_s": upload_s, "serve_s": t_serve, "requests": INDEX_QUERIES,
           "clients": SERVE_CLIENTS, "batches": batches, "rect_s": rect_s, "launches": launches,
           "latency_ms": st["latency_ms"], "resident_rect_s": t_resident_rect,
           "union_pack_s": p10["classify_separate_pack_s"], "union_walk_s": p10["classify_separate_walk_s"],
           "kernel": kernel, "prefix_card_cpu_s": t_prefix, "cli_s": t_cli}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {json.dumps({k: v for k, v in out.items() if k not in ('latency_ms',)})}")
    return out


# phase 12: the federated index (ROADMAP queue 1 item 10b) over phase 5's
# genomes and phase 10's batch and queries, then its maintenance verbs
FED_PARTITIONS = 4
FED_MAINT_QUERIES = 8  # queries re-answered after each maintenance verb
FED_PODS = 4  # a pod a partition, all at once (2 at a time cost a second ~15-18 s round)


def fed_kwargs(params: dict) -> dict:
    """build_federated's keyword arguments that pin `params` (a plain
    index's), so the federation and the plain store share every number."""
    return {"P_ani": params["P_ani"], "S_ani": params["S_ani"], "cov_thresh": params["cov_thresh"],
            "clusterAlg": params["clusterAlg"], "S_algorithm": params["S_algorithm"],
            "MASH_sketch": params["sketch_size"], "scale": params["scale"], "kmer_size": params["kmer_size"],
            "hash": params["hash"], "warn_dist": params["warn_dist"], "length": params["filter_length"],
            "streaming_block": params["streaming_block"], **params["weights"]}


def union_partitions(idx) -> tuple:
    """(primary partition, secondary partition, winner keyed by its
    secondary cluster's member set) of an index, as name sets."""
    prim: dict = {}
    sec: dict = {}
    for g, p, name in zip(idx.names, idx.primary.tolist(), idx.secondary_names()):
        prim.setdefault(p, set()).add(g)
        sec.setdefault(name, set()).add(g)
    winners = {frozenset(sec[c]): g for c, g in zip(idx.winners["cluster"], idx.winners["genome"])}
    return set(map(frozenset, prim.values())), set(map(frozenset, sec.values())), winners


def verdicts_agree(got: list, want: list, what: str, renumbered: bool) -> int:
    """`got` == `want` field by field, but for the generation stamp; with
    `renumbered` (two stores whose union orders differ) the cluster labels
    up to one renumbering, `cluster_members` as sets, `score` at rtol
    1e-12 (its centrality sums the cluster's ANIs in union order) and
    `nearest` up to a tie at `nearest_dist` (the first minimum in union
    order). `nearest_dist` at rtol 1e-6. Returns the number of ties."""
    require(len(got) == len(want), f"{what}: {len(got)} verdicts, expected {len(want)}")
    maps = {"primary_cluster": ({}, {}), "secondary_cluster": ({}, {})}
    ties = 0
    for g, w in zip(got, want):
        require(g.keys() == w.keys(), f"{what}: verdict keys {sorted(g)} != {sorted(w)}")
        for k in g:
            if k == "generation":
                continue
            if k == "nearest_dist" and g[k] is not None and w[k] is not None:
                require(abs(g[k] - w[k]) <= 1e-6 * abs(w[k]), f"{what}: {g['genome']} nearest_dist {g[k]} != {w[k]}")
            elif renumbered and k in maps:
                fwd, back = maps[k]
                require(fwd.setdefault(w[k], g[k]) == g[k] and back.setdefault(g[k], w[k]) == w[k],
                        f"{what}: {g['genome']} {k} {g[k]} is not a renumbering of {w[k]}")
            elif renumbered and k == "cluster_members":
                require(sorted(g[k]) == sorted(w[k]), f"{what}: {g['genome']} cluster members differ")
            elif renumbered and k == "score":
                require(abs(g[k] - w[k]) <= 1e-12 * abs(w[k]), f"{what}: {g['genome']} score {g[k]} != {w[k]}")
            elif renumbered and k == "nearest" and g[k] != w[k]:
                ties += 1
            else:
                require(g[k] == w[k], f"{what}: {g['genome']} {k} {g[k]!r} != {w[k]!r}")
    return ties


def fed_healthy(loc: str, what: str, routed=None, gen=None) -> dict:
    """The federation's meta: no partial stamp, and every routed partition
    at the new generation `gen`."""
    from drep_tpu_torch.index import meta as fedmeta

    m = fedmeta.read_meta(loc)
    require("partial" not in m, f"{what}: the meta carries a partial stamp {m.get('partial')}")
    for e in m["partitions"]:
        if routed is not None and int(e["pid"]) in routed:
            require(int(e["generation"]) == gen, f"{what}: partition {e['pid']} at generation {e['generation']}")
    return m


def fed_update_checked(what: str, stats: dict, launches: dict, summary: dict, p: int) -> dict:
    """A federated update's (or build's) partitions: none failed, each
    routed one's Mash launches and dirty-cluster secondaries counted, and
    the run's launches exactly theirs plus the cross walk's and the union
    recluster's. Returns the per-partition table."""
    parts = stats["partitions"]
    require(not stats["failed"] and summary["partitions_failed"] == [] and not summary.get("unadmitted"),
            f"{what}: failed partitions {stats['failed']}")
    require(sorted(parts) == summary["partitions_updated"] and len(parts) <= p, f"{what}: partitions {sorted(parts)}")
    require(all(v["rect_launches"] > 0 for v in parts.values()), f"{what}: a partition launched no Mash stripe")
    mash_want = sum(v["rect_launches"] for v in parts.values()) + stats["cross_launches"]
    ind_want = sum(v["secondary_calls"] for v in parts.values()) + stats["union_secondary_calls"]
    require(launches["mash_shared"] == mash_want > 0 and launches["indicator_mm"] == ind_want > 0,
            f"{what}: launches {launches}, expected mash_shared {mash_want} and indicator_mm {ind_want}")
    return {int(k): {kk: (round(vv, 3) if isinstance(vv, float) else vv) for kk, vv in v.items()}
            for k, v in parts.items()}


class planted_sketches:
    """Within the block, the federation's front door (``federation.
    sketch_batch``) returns phase 5's and 10's planted sketches in place of
    sketching FASTAs."""

    def __init__(self, real: dict, p10: dict):
        gs = real["gs"]
        stats_cols = ("length", "N50", "contigs", "n_kmers")
        self.registry = {g: {**{c: int(gs.gdb[c].iloc[i]) for c in stats_cols}, "bottom": gs.bottom[i],
                             "scaled": gs.scaled[i]} for i, g in enumerate(gs.names)}
        self.registry.update(p10["serve_inputs"]["results"])

    def sketch_batch(self, idx, genome_paths, processes=1):
        import pandas as pd

        names = [os.path.basename(p) for p in genome_paths]
        return pd.DataFrame({"genome": names, "location": list(genome_paths)}), {g: self.registry[g] for g in names}

    def __enter__(self):
        from drep_tpu_torch.index import federation

        self.real = federation.sketch_batch
        federation.sketch_batch = self.sketch_batch
        return self

    def __exit__(self, *exc):
        from drep_tpu_torch.index import federation

        federation.sketch_batch = self.real


def phase_federation(tmp: str, dev, real: dict, p10: dict) -> dict:
    """Phase 12a-c: build_federated over phase 5's genomes; phase 10's
    update; one-shot classify of phase 10's queries from the union, joint
    and separate (the separate verdicts are phase 13's oracle)."""
    import torch

    from drep_tpu_torch.index import build_federated, classify_batch, index_update, load_index, load_resident_index
    from drep_tpu_torch.index import federation
    from drep_tpu_torch.utils.durableio import read_json_checked

    t_phase = time.perf_counter()
    gs, planted, si = real["gs"], real["planted"], p10["serve_inputs"]
    idx_dir, queries = si["idx_dir"], si["queries"]
    gdir = os.path.join(tmp, "real_genomes")
    paths = [os.path.join(gdir, g) for g in gs.names]
    batch_paths = list(si["batch"]["location"])
    plain_params = read_json_checked(os.path.join(idx_dir, "manifest.json"))["params"]
    out: dict = {"partitions": FED_PARTITIONS, "genomes": len(paths)}
    with planted_sketches(real, p10):
        # 12a: the federated build over phase 5's genomes
        fed_dir = os.path.join(tmp, "federation")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = build_federated(fed_dir, paths, FED_PARTITIONS, processes=1, device=dev, **fed_kwargs(plain_params))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        launches = read_launches()
        st = dict(federation.STATS)
        parts = fed_update_checked("12a", st, launches, built, FED_PARTITIONS)
        m = fed_healthy(fed_dir, "12a", routed=parts, gen=0)
        require(m["params"] == plain_params and built["n_genomes"] == len(paths) and built["generation"] == 0,
                f"12a: {built}")
        t0 = time.perf_counter()
        union = load_index(fed_dir)
        t_load = time.perf_counter() - t0
        by_name = dict(zip(union.names, zip(union.primary.tolist(), union.secondary_names())))
        labels = [by_name[g] for g in gs.names]
        n_planted = len(set(planted.tolist()))
        require(len(set(zip(planted.tolist(), labels))) == n_planted == len({l[0] for l in labels})
                == len({l[1] for l in labels}), "12a: the planted clusters are not the union's primary and "
                "secondary clusters")
        out["build"] = {"s": t_build, "launches": launches, "partitions": parts, "union_load_s": t_load,
                        **{k: st[k] for k in ("load_s", "join_s", "cross_candidates", "walk_s", "cross_pairs",
                                              "cross_launches", "recluster_s", "union_secondary_calls", "publish_s")},
                        "cross_edges": built["cross_edges"], "n_per_partition": [e["n_genomes"] for e in m["partitions"]]}
        log(f"12a federated build: {len(paths)} genomes over {FED_PARTITIONS} partitions in {t_build:.2f} s; "
            f"{json.dumps(out['build'])}; every planted cluster is one primary and one secondary cluster")

        # 12b: phase 10's update, routed over the partitions
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upd = index_update(fed_dir, batch_paths, processes=1, device=dev)
        torch.cuda.synchronize()
        t_update = time.perf_counter() - t0
        launches = read_launches()
        st = dict(federation.STATS)
        parts = fed_update_checked("12b", st, launches, upd, FED_PARTITIONS)
        fed_healthy(fed_dir, "12b", routed=parts, gen=1)
        require(upd["admitted"] == INDEX_NEW and upd["generation"] == 1, f"12b: {upd}")
        union = load_index(fed_dir)
        plain = load_index(idx_dir)
        fed_parts, plain_parts = union_partitions(union), union_partitions(plain)
        require(fed_parts[0] == plain_parts[0] and fed_parts[1] == plain_parts[1],
                "12b: the union's primary or secondary partition != phase 10's plain store after its update")
        require(fed_parts[2] == plain_parts[2], "12b: the union's winners != phase 10's plain store's")
        out["update"] = {"s": t_update, "launches": launches, "partitions": parts,
                         **{k: st[k] for k in ("load_s", "join_s", "cross_candidates", "walk_s", "cross_pairs",
                                               "cross_launches", "recluster_s", "union_secondary_calls",
                                               "publish_s")}, "cross_edges": upd["cross_edges"]}
        log(f"12b federated update: {json.dumps(out['update'])}; the union's partitions and winners equal phase "
            f"10's plain store's")

        # 12c: one-shot classify (load_resident_index(streaming=False) +
        # one joint batch, index_classify's body on presketched queries)
        before = tree_digest(fed_dir)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident = load_resident_index(fed_dir, streaming=False)
        t_res = time.perf_counter() - t0
        got = classify_batch(resident, queries, processes=1, joint=True, device=dev)
        torch.cuda.synchronize()
        t_classify = time.perf_counter() - t0
        launches = read_launches()
        require(tree_digest(fed_dir) == before, "12c: classify changed the federation's tree")
        require(launches["mash_shared"] > 0, f"12c: launches {launches}")
        ties = verdicts_agree(got, si["joint"], "12c", renumbered=True)
        out["classify"] = {"s": t_classify, "load_s": t_res, "launches": launches, "nearest_ties": ties}
        log(f"12c classify: {len(got)} verdicts in {t_classify:.2f} s (load {t_res:.2f} s) equal 10c's joint "
            f"ones (labels up to renumbering, {ties} nearest tie(s)); launches "
            f"{ {k: v for k, v in launches.items() if v} }; the tree unchanged")
        # the separate verdicts of every query: phase 13's oracle
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        separate = classify_batch(resident, queries, processes=1, joint=False, device=dev)
        torch.cuda.synchronize()
        out["classify"]["separate_s"] = time.perf_counter() - t0
        verdicts_agree(separate, si["separate"], "12c separate", renumbered=True)
        log(f"12c separate: {len(separate)} verdicts in {out['classify']['separate_s']:.2f} s equal 10c's separate "
            f"ones (labels up to renumbering)")
        del resident
    out.update(fed_dir=fed_dir, digest=before, separate=separate, fed_parts=fed_parts, plain_parts=plain_parts,
               phase_s=time.perf_counter() - t_phase)
    log(f"phase 12a-c: {out['phase_s']:.1f} s")
    return out


def phase_federation_maint(tmp: str, dev, real: dict, p10: dict, p12: dict) -> dict:
    """Phase 12d-e: compact_store on phase 10's plain store, then split,
    merge and compact of the federation through the CLI; a --fed_pods
    update of a prefix federation against its in-process twin."""
    import torch

    from drep_tpu_torch.controller import main as cli_main
    from drep_tpu_torch.index import (build_federated, classify_batch, compact_store, index_update,
                                      load_resident_index)
    from drep_tpu_torch.index import federation
    from drep_tpu_torch.index import meta as fedmeta
    from drep_tpu_torch.index.classify import SketchedQueries
    from drep_tpu_torch.utils.durableio import load_npz_checked, read_json_checked

    t_phase = time.perf_counter()
    si = p10["serve_inputs"]
    idx_dir, queries = si["idx_dir"], si["queries"]
    fed_dir, fed_parts, plain_parts = p12["fed_dir"], p12["fed_parts"], p12["plain_parts"]
    paths = [os.path.join(tmp, "real_genomes", g) for g in real["gs"].names]
    batch_paths = list(si["batch"]["location"])
    few = SketchedQueries(admitted=queries.admitted.iloc[:FED_MAINT_QUERIES].reset_index(drop=True),
                          results=queries.results)
    base = p12["separate"][:FED_MAINT_QUERIES]
    out: dict = {}
    with planted_sketches(real, p10):
        # 12d: compact_store on phase 10's plain store, then split, merge
        # and compact of the federation, each leaving the union's
        # partitions and the first queries' verdicts as they were
        maint = {}

        def after(loc: str, want_parts, want_verdicts, what: str) -> None:
            # the queries' verdicts are re-checked after the last verb on
            # each store only (cut for the time limit: phase 13 needs it)
            res = load_resident_index(loc, streaming=False)
            require(union_partitions(res) == want_parts, f"{what}: the union's partitions or winners changed")
            if want_verdicts is not None:
                verdicts_agree(classify_batch(res, few, processes=1, joint=False, device=dev), want_verdicts, what,
                               renumbered=False)

        def step(what: str, fn):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            maint[what] = {"s": time.perf_counter() - t0, "launches": {k: v for k, v in read_launches().items() if v}}
            return res

        manifest = read_json_checked(os.path.join(idx_dir, "manifest.json"))
        require(len(manifest["sketch_shards"]) == 2, "12d: phase 10's store is not two generations")
        summary = step("compact_store", lambda: compact_store(idx_dir, device=dev))
        require(summary["generation"] == 2 and summary["compacted"], f"12d compact_store: {summary}")
        require(len(read_json_checked(os.path.join(idx_dir, "manifest.json"))["sketch_shards"]) == 1,
                "12d: the compacted store holds more than one sketch shard")
        after(idx_dir, plain_parts, si["separate"][:FED_MAINT_QUERIES], "12d compact_store")
        m = fedmeta.read_meta(fed_dir)
        big = max(m["partitions"], key=lambda e: e["n_genomes"])
        pid = int(big["pid"])
        step("split", lambda: cli_main(["index", "split", fed_dir, "--pid", str(pid), "-p", "1", "--device", dev.type]))
        m = fed_healthy(fed_dir, "12d split")
        require(m["n_partitions"] == FED_PARTITIONS + 1 and m["generation"] == 2, "12d: split did not commit")
        require(maint["split"]["launches"].get("indicator_mm", 0) > 0, f"12d split: {maint['split']}")
        after(fed_dir, fed_parts, None, "12d split")
        step("merge", lambda: cli_main(["index", "merge", fed_dir, "--pids", str(pid), str(pid + 1), "-p", "1",
                                        "--device", dev.type]))
        m = fed_healthy(fed_dir, "12d merge")
        require(m["n_partitions"] == FED_PARTITIONS and m["generation"] == 3, "12d: merge did not commit")
        require(maint["merge"]["launches"].get("indicator_mm", 0) > 0, f"12d merge: {maint['merge']}")
        after(fed_dir, fed_parts, None, "12d merge")
        step("compact", lambda: cli_main(["index", "compact", fed_dir, "--min_generations", "2", "-p", "1",
                                          "--device", dev.type]))
        m = fed_healthy(fed_dir, "12d compact")
        require(m["generation"] == 4, "12d: compact did not commit")
        for e in m["partitions"]:
            pm = read_json_checked(os.path.join(fed_dir, e["dir"], "manifest.json"))
            require(len(pm["sketch_shards"]) == 1, f"12d: partition {e['pid']} holds several generations")
        after(fed_dir, fed_parts, base, "12d compact")
        out["maintenance"] = maint
        log(f"12d: compact_store, split of partition {pid} ({big['n_genomes']} genomes), merge back and compact; "
            f"the partitions and winners unchanged after each, the first {FED_MAINT_QUERIES} queries' verdicts after "
            f"compact_store and compact; "
            f"{json.dumps(maint)}")

        # 12e: a --fed_pods update of a federation of phase 10's prefix
        # genomes against its in-process twin
        pre_params = si["params"]
        twin_a, twin_b = os.path.join(tmp, "fed_prefix_a"), os.path.join(tmp, "fed_prefix_b")
        t0 = time.perf_counter()
        build_federated(twin_a, paths[:INDEX_PREFIX], FED_PARTITIONS, processes=1, device=dev,
                        **fed_kwargs(pre_params))
        t_pre = time.perf_counter() - t0
        shutil.copytree(twin_a, twin_b)
        reset_launches()
        t0 = time.perf_counter()
        ua = index_update(twin_a, batch_paths, processes=1, device=dev)
        t_in = time.perf_counter() - t0
        launches = read_launches()
        parts = fed_update_checked("12e in process", dict(federation.STATS), launches, ua, FED_PARTITIONS)
        t0 = time.perf_counter()
        ub = index_update(twin_b, batch_paths, processes=1, fed_pods=FED_PODS, device=dev)
        t_pods = time.perf_counter() - t0
        st = dict(federation.STATS)
        rcs = st["pod_rcs"]
        require(not st["failed"] and set(rcs.values()) == {0} and sorted(rcs) == sorted(parts)
                and ub["partitions_failed"] == [] and ub["partitions_updated"] == ua["partitions_updated"],
                f"12e: pods {rcs}, failed {st['failed']}")
        fed_healthy(twin_b, "12e pods", routed=parts, gen=1)
        files_a = sorted(os.path.relpath(os.path.join(d, f), twin_a) for d, _, fs in os.walk(twin_a) for f in fs
                         if "log" not in os.path.relpath(d, twin_a).split(os.sep))
        files_b = sorted(os.path.relpath(os.path.join(d, f), twin_b) for d, _, fs in os.walk(twin_b) for f in fs
                         if "log" not in os.path.relpath(d, twin_b).split(os.sep))
        require(files_a == files_b, f"12e: the pods' store holds other files than the in-process twin's")
        for rel in files_a:
            a, b = os.path.join(twin_a, rel), os.path.join(twin_b, rel)
            if rel.endswith(".json"):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    require(fa.read() == fb.read(), f"12e: {rel} differs between the pods and the in-process twin")
            else:
                za, zb = load_npz_checked(a), load_npz_checked(b)
                require(sorted(za) == sorted(zb) and all(np.array_equal(za[k], zb[k]) for k in za),
                        f"12e: {rel} differs between the pods and the in-process twin")
        out["pods"] = {"prefix_build_s": t_pre, "in_process_s": t_in, "pods_s": t_pods, "pod_rcs": rcs,
                       "pods": FED_PODS, "in_process_launches": launches, "partitions": parts,
                       "files_compared": len(files_a)}
        log(f"12e: a {FED_PODS}-pod update of a {INDEX_PREFIX}-genome {FED_PARTITIONS}-partition federation "
            f"equals its in-process twin ({len(files_a)} files); {json.dumps(out['pods'])}")
    out["maint_s"] = time.perf_counter() - t_phase
    out["phase_s"] = p12["phase_s"] + out["maint_s"]
    log(f"phase 12d-e: {out['maint_s']:.1f} s (phase 12: {out['phase_s']:.1f} s)")
    return out


# phase 13: serving the federated root (ROADMAP queue 1 item 11b) at 12c's
# generation: 13a the daemon on the streaming resident, 13b a router over
# two replicas scoped to FED_SERVE_SCOPES (scatter/gather), then over the
# same replicas unscoped (forward)
FED_SERVE_SCOPES = ("0,1", "2,3")
# the router's batch bound: a classify_part leg is one protocol line
# carrying its queries' bottoms as JSON integers (~17-21 bytes a hash),
# and the line is capped at 1 MiB (protocol.MAX_LINE_BYTES, the JAX
# package's too), so 64 queries of width 1000 overflow it and the replica
# refuses the leg; 32 stay under it. The forward pass sends paths, not
# sketches: its router batches all INDEX_QUERIES, so that each replica
# packs its partitions once
FED_ROUTER_BATCH = 32


def fed_stripes(fed, bottoms: list, block: int) -> int:
    """The Mash launches one streaming batch implies: for each partition
    its queries route to, the row stripes of its [n_p + K_p] rectangle."""
    from drep_tpu_torch.parallel.streaming import _effective_block

    cand = fed.route_candidates(bottoms)
    total = 0
    for pid in set().union(*cand):
        rows = fed._slots[pid].n + sum(pid in c for c in cand)
        total += -(-rows // _effective_block(block, rows))
    return total


def fed_serve_classify_fn(queries, dev, batches: list):
    """serve_classify_fn that also records each batch's query bottoms."""
    inner = serve_classify_fn(queries, dev, [])
    bottom_of = {loc: queries.results[g]["bottom"] for g, loc in zip(queries.admitted["genome"],
                                                                       queries.admitted["location"])}

    def fn(resident, paths):
        batches.append([np.asarray(bottom_of[p], np.uint64) for p in paths])
        return inner(resident, paths)

    return fn


def fed_coverage_full(verdicts: list, fed, what: str) -> None:
    """Every verdict with full coverage, every partition healthy, and no
    suspect, quarantine or recovery: a failed launch on the card would
    show here as a PARTIAL verdict, not as an exception."""
    bad = [v["genome"] for v in verdicts if v.get("partitions_unavailable") or v.get("partial")
           or not v.get("partitions_consulted")]
    require(not bad, f"{what}: verdicts without full coverage: {bad[:5]}")
    hm = fed.health_map()
    states = {p: e["state"] for p, e in hm["partitions"].items()}
    require(set(states.values()) == {"healthy"} and not hm["quarantined"] and not hm["suspect"]
            and hm["recoveries"] == 0 and not any("reason" in e for e in hm["partitions"].values()),
            f"{what}: partition health {json.dumps(hm)}")


def phase_fed_serve(tmp: str, dev, p10: dict, p12: dict) -> dict:
    """Phase 13: 13a IndexServer in-process on the federated root at 12c's
    generation (the streaming resident on the card), 10c's queries from
    concurrent clients: verdicts equal to 12c's separate union verdicts
    once stripped, full coverage, the Mash launches the partitions' stripes
    imply; 13b two replicas behind a RouterServer, scoped (scatter/gather)
    and then unscoped (forward): verdicts equal to 13a's full dicts, the
    legs and each side's launches counted."""
    import threading

    import pandas as pd
    import torch

    from drep_tpu_torch.index.classify import SketchedQueries
    from drep_tpu_torch.serve import IndexServer, ServeConfig
    from drep_tpu_torch.serve.router import RouterConfig, RouterServer

    t_phase = time.perf_counter()
    fed_dir = p12["fed_dir"]
    # 10c's queries under files named as `index classify` would name them
    # (``query:`` + the basename), which the router's sketch cache and its
    # forward path key on; the daemons admit paths that exist
    q10 = p10["serve_inputs"]["queries"]
    qdir = os.path.join(tmp, "fed_serve_queries")
    os.makedirs(qdir)
    names = list(q10.admitted["genome"])
    paths = [os.path.join(qdir, g[len("query:"):]) for g in names]
    for p in paths:
        open(p, "wb").close()
    queries = SketchedQueries(admitted=pd.DataFrame({"genome": names, "location": paths}), results=q10.results)
    strip = ("partitions_consulted", "partitions_unavailable", "partial")
    want = {v["genome"]: v for v in p12["separate"]}
    out: dict = {}

    def serve(cfg_cls, cfg_kw, classify_fn=None, max_batch=INDEX_QUERIES):
        srv = cfg_cls[1](cfg_cls[0](index_loc=fed_dir, device=dev, poll_generation_s=60.0, max_batch=max_batch,
                                    batch_window_ms=SERVE_WINDOW_MS, **cfg_kw), classify_fn=classify_fn)
        t0 = time.perf_counter()
        addr = srv.start()
        t_start = time.perf_counter() - t0
        loop = threading.Thread(target=srv.serve_batches, daemon=True)
        loop.start()
        return srv, addr, loop, t_start

    def stop(srv, loop, what: str) -> None:
        srv.request_drain()
        loop.join(timeout=300)
        srv.close()
        require(not loop.is_alive(), f"{what}: the batch loop did not drain")

    def answered(resps: list, srv, what: str) -> dict:
        st = srv.snapshot()
        bad = [r for r in resps if not (r and r.get("ok"))]
        require(not bad and st["errors_total"] == 0, f"{what}: {len(bad)} error replies (first {bad[:1]})")
        return {r["verdict"]["genome"]: r["verdict"] for r in resps}

    # 13a: the daemon on the streaming resident
    batches: list = []
    reset_launches()
    srv, addr, loop, t_start = serve((ServeConfig, IndexServer), {}, fed_serve_classify_fn(queries, dev, batches))
    fed = srv._resident
    require(fed.health_map()["resident_partitions"] == 0, "13a: the spine load made a partition resident")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resps = serve_clients(addr, paths)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        launches = read_launches()
    finally:
        stop(srv, loop, "13a")
    got_a = answered(resps, srv, "13a")
    fed_coverage_full(list(got_a.values()), fed, "13a")
    stripped = {g: {k: x for k, x in v.items() if k not in strip} for g, v in got_a.items()}
    require(stripped == want, "13a: the streaming verdicts != 12c's separate union verdicts: "
            f"{sorted(g for g in want if stripped.get(g) != want[g])[:5]}")
    block = int(fed.params["streaming_block"])
    stripes_want = sum(fed_stripes(fed, b, block) for b in batches)
    work = dict(fed.work)
    require(launches["mash_shared"] == work["stripes"] == stripes_want > 0,
            f"13a: {launches['mash_shared']} mash_shared launches, the resident counted {work['stripes']}, the "
            f"partitions' stripes imply {stripes_want}")
    require(launches["indicator_mm"] == work["secondary_calls"] > 0,
            f"13a: {launches['indicator_mm']} indicator_mm launches, the reclusters ran {work['secondary_calls']} "
            f"secondaries")
    require(tree_digest(fed_dir) == p12["digest"], "13a: the daemon changed the federation's tree")
    st = srv.snapshot()
    out["a"] = {"start_s": t_start, "serve_s": t_serve, "batches": st["batches_total"],
                "batch_sizes": [len(b) for b in batches], "launches": launches, "work": work,
                "latency_ms": st["latency_ms"], "health": {k: st["partitions"][k] for k in (
                    "loads", "evictions", "resident_partitions", "resident_bytes", "peak_resident_partitions")}}
    log(f"13a federated serve: {len(resps)} requests from {SERVE_CLIENTS} clients in {t_serve:.2f} s, "
        f"{st['batches_total']} batch(es) of {out['a']['batch_sizes']}; start (the spine) {t_start:.2f} s; "
        f"{json.dumps({k: v for k, v in out['a'].items() if k != 'latency_ms'})}; verdicts equal 12c's separate "
        f"ones once stripped, full coverage, every partition healthy, the tree unchanged")

    # 13b: two replicas behind a router, scoped then unscoped
    reps = [serve((ServeConfig, IndexServer), {}, fed_serve_classify_fn(queries, dev, [])) for _ in range(2)]
    # no hedging: a forward group hedges on its first pass whenever the
    # batch's budget exceeds the hedge delay (both packages; ROADMAP queue
    # 3, F8), so the delay is set past SERVE_DEADLINE_MS
    router_kw = {"leg_timeout_s": 120.0, "hedge_delay_s": 2 * SERVE_DEADLINE_MS / 1000.0, "probe_interval_s": 1.0}
    try:
        for mode, specs, batch in (
                ("scatter", [f"{reps[i][1]}={FED_SERVE_SCOPES[i]}" for i in range(2)], FED_ROUTER_BATCH),
                ("forward", [reps[0][1], reps[1][1]], INDEX_QUERIES)):
            before = [(dict(r[0]._resident.work), r[0].stats.legs_total) for r in reps]
            reset_launches()
            # phase 16b: the scatter run traced (the router and its replicas
            # share this process's event log); 16c: one recommend-only
            # autoscale tick against the live router
            trace_dir = os.path.join(tmp, f"trace_13b_{mode}")
            with traced(trace_dir) if mode == "scatter" else contextlib.nullcontext():
                rt, raddr, rloop, r_start = serve((RouterConfig, RouterServer), {"replicas": specs, **router_kw},
                                                  max_batch=batch)
                for p in paths:  # the router's sketch cache holds 10c's planted sketches
                    rt._sketch_cache[rt._sketch_key(p)] = queries.results[f"query:{os.path.basename(p)}"]
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    resps = serve_clients(raddr, paths)
                    torch.cuda.synchronize()
                    t_route = time.perf_counter() - t0
                    launches = read_launches()
                    if mode == "scatter":
                        out["autoscale"] = autoscale_tick(tmp, raddr, specs)
                finally:
                    stop(rt, rloop, f"13b {mode}")
            got = answered(resps, rt, f"13b {mode}")
            partial = sorted(g for g, v in got.items() if v.get("partial") or v.get("partitions_unavailable"))
            require(not partial, f"13b {mode}: budget expired: {len(partial)} PARTIAL (first {partial[:5]}; "
                    f"router {json.dumps(rt.snapshot()['router'])})")
            differ = sorted(g for g in got_a if got.get(g) != got_a[g])
            if differ:  # the first difference in full, for the diagnosis
                log(f"13b {mode}: {differ[0]}: 13a {json.dumps(got_a[differ[0]], default=str)}; routed "
                    f"{json.dumps(got.get(differ[0]), default=str)}; router {json.dumps(rt.snapshot()['router'])}")
            require(not differ, f"13b {mode}: routed verdicts != 13a's: {differ[:5]}")
            rs = rt.snapshot()["router"]
            rep_work = [{k: r[0]._resident.work[k] - b[0][k] for k in ("stripes", "secondary_calls")}
                        for r, b in zip(reps, before)]
            legs = [r[0].stats.legs_total - b[1] for r, b in zip(reps, before)]
            router_work = rt._resident.work
            n_q = len(paths)
            if mode == "scatter":
                require(rs["scattered"] == n_q and rs["forwarded"] == 0, f"13b scatter: {rs}")
                require(sum(legs) == rs["legs_total"] > 0 and all(legs), f"13b scatter: legs {legs}, router {rs}")
                tc = read_trace(trace_dir, "13b", r_start + t_route)["counts"]
                require(tc.get("route_start:i") == 1 and tc.get("partition_classify:E") == sum(legs)
                        and tc.get("fleet_autoscale_decision:i") == len(FED_SERVE_SCOPES)
                        and not any(k.startswith(("replica_", "fault:")) for k in tc),
                        f"16b 13b: events {tc}, {sum(legs)} legs")
            else:
                require(rs["forwarded"] == n_q and rs["scattered"] == 0 and rs["legs_total"] == 0,
                        f"13b forward: {rs}")
            require(rs["leg_failures"] == rs["hedges"] == rs["partial_verdicts"] == rs["reroutes"] == 0,
                    f"13b {mode}: {rs}")
            require(router_work["stripes"] == 0 and launches["mash_shared"] == sum(w["stripes"] for w in rep_work) > 0,
                    f"13b {mode}: mash_shared {launches['mash_shared']}, replicas {rep_work}, router {router_work}")
            require(launches["indicator_mm"] == router_work["secondary_calls"]
                    + sum(w["secondary_calls"] for w in rep_work) > 0,
                    f"13b {mode}: indicator_mm {launches['indicator_mm']}, replicas {rep_work}, router {router_work}")
            for i, r in enumerate(reps):
                fed_coverage_full([], r[0]._resident, f"13b {mode} replica {i}")
            fed_coverage_full([], rt._resident, f"13b {mode} router")
            out[mode] = {"router_start_s": r_start, "serve_s": t_route, "launches": launches, "router": rs,
                         "replica_legs": legs, "replica_work": rep_work,
                         "router_work": {k: router_work[k] for k in ("reclusters", "secondary_calls", "recluster_s")},
                         "batches": rt.snapshot()["batches_total"], "latency_ms": rt.snapshot()["latency_ms"]}
            log(f"13b {mode}: {n_q} requests through the router in {t_route:.2f} s (router start {r_start:.2f} s); "
                f"{json.dumps({k: v for k, v in out[mode].items() if k != 'latency_ms'})}; verdicts equal 13a's "
                f"full dicts")
    finally:
        for srv, _addr, loop, _t in reps:
            stop(srv, loop, "13b replica")
    require(tree_digest(fed_dir) == p12["digest"], "13b: the fleet changed the federation's tree")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: {out['phase_s']:.1f} s")
    return out


# stand-ins for the external binaries of the subprocess engines (mash,
# fastANI, nucmer, prodigal, ANIcalculator, nsimscan, centrifuge), for
# machines without them: phase 15 puts them first on $PATH; the CPU tests
# of both packages run the same ones
FAKE_TOOL_SOURCE = r'''"""A stand-in for one external binary of dRep's subprocess engines: mash,
fastANI, nucmer, prodigal, ANIcalculator, nsimscan or centrifuge, chosen
by the name it is called under. It writes its tool's own output format,
with numbers computed deterministically from the FASTA files it is given
(shared 16-mers), logs each call to calls.log beside itself, and fails
the calls fail.json asks it to fail."""
import os
import sys
import zlib

K = 16
HERE = os.path.dirname(os.path.abspath(__file__))
TOOL = os.path.basename(sys.argv[0])
VERSIONS = {"mash": "2.3", "fastANI": "version 1.33", "nucmer": "4.0.0rc1",
            "prodigal": "Prodigal V2.6.3: February, 2016", "centrifuge": "centrifuge-class version 1.0.4"}
TAXA = (("Escherichia coli", 562), ("Salmonella enterica", 28901), ("Bacillus subtilis", 1423))


def log_call(fields):
    fd = os.open(os.path.join(HERE, "calls.log"), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, ("\t".join([TOOL] + fields) + "\n").encode())
    finally:
        os.close(fd)


def maybe_fail(text):
    """fail.json {"tool": t, "match": s, "times": n}: the next n calls of
    tool t whose argv or list files mention s exit 3."""
    path = os.path.join(HERE, "fail.json")
    if not os.path.exists(path):
        return
    import json  # only here and in mash: a call's start is most of its time

    with open(path) as f:
        plan = json.load(f)
    if plan["tool"] != TOOL or plan["match"] not in text or plan["times"] <= 0:
        return
    plan["times"] -= 1
    with open(path + ".tmp", "w") as f:
        json.dump(plan, f)
    os.replace(path + ".tmp", path)
    sys.stderr.write(f"{TOOL}: injected failure\n")
    sys.exit(3)


def read_fasta(path):
    out, name, parts = [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts).upper()))
                name, parts = line[1:].split()[0], []
            elif line:
                parts.append(line)
    if name is not None:
        out.append((name, "".join(parts).upper()))
    return out


def kmers(seq):
    return {seq[i:i + K] for i in range(len(seq) - K + 1)}


def genome_kmers(path):
    out = set()
    for _, seq in read_fasta(path):
        out |= kmers(seq)
    return out


def identity(c):
    """Containment of one k-mer set in another -> an identity (ANI ~ 1 - p
    for point mutations at rate p)."""
    return c ** (1.0 / K) if c > 0 else 0.0


def arg(args, flag):
    return args[args.index(flag) + 1]


def mash(args):
    import json
    import math

    if args[0] == "sketch":
        with open(arg(args, "-o") + ".msh", "w") as f:
            json.dump({"s": int(arg(args, "-s")), "paths": args[args.index("-o") + 2:]}, f)
        return
    with open(args[-2]) as f:
        ref = json.load(f)
    with open(args[-1]) as f:
        qry = json.load(f)
    s = ref["s"]
    bottom = {p: sorted({zlib.crc32(km.encode()) for km in genome_kmers(p)})[:s]
              for p in dict.fromkeys(ref["paths"] + qry["paths"])}
    holders = {}  # hash -> the sketches holding it: only pairs sharing one are merged
    for p, hashes in bottom.items():
        for h in hashes:
            holders.setdefault(h, set()).add(p)
    lines = []
    for q in qry["paths"]:
        near = set()
        for h in bottom[q]:
            near |= holders[h]
        for r in ref["paths"]:
            shared = 0
            if r in near:
                a, b = set(bottom[r]), set(bottom[q])
                shared = sum(1 for h in sorted(a | b)[:s] if h in a and h in b)
            j = shared / s
            d = 1.0 if j == 0 else min(1.0, -math.log(2 * j / (1 + j)) / K)
            lines.append(f"{r}\t{q}\t{d:.6g}\t0\t{shared}/{s}\n")
    sys.stdout.write("".join(lines))


def fastani(args):
    with open(arg(args, "--ql")) as f:
        ql = [ln.strip() for ln in f if ln.strip()]
    with open(arg(args, "--rl")) as f:
        rl = [ln.strip() for ln in f if ln.strip()]
    km = {p: genome_kmers(p) for p in dict.fromkeys(ql + rl)}
    size = {p: sum(len(s) for _, s in read_fasta(p)) for p in ql}
    with open(arg(args, "-o"), "w") as out:
        for q in ql:
            for r in rl:
                c = len(km[q] & km[r]) / max(len(km[q]), 1)
                ani = 100.0 * identity(c)
                if ani < 80.0:
                    continue  # fastANI reports no pair below ~80%
                total = max(1, size[q] // 3000)
                out.write(f"{q}\t{r}\t{ani:.4f}\t{round(total * c ** 0.25)}\t{total}\n")


def nucmer(args):
    prefix, ref, qry = arg(args, "-p"), args[-2], args[-1]
    lines = [f"{ref} {qry}\n", "NUCMER\n"]
    window = 2000
    for rname, rseq in read_fasta(ref):
        pos = {}
        for i in range(len(rseq) - K + 1):
            pos.setdefault(rseq[i:i + K], i + 1)
        for qname, qseq in read_fasta(qry):
            alns = []
            for s in range(0, max(len(qseq) - K + 1, 0), window):
                win = qseq[s:s + window]
                hits = [(i, pos[win[i:i + K]]) for i in range(len(win) - K + 1) if win[i:i + K] in pos]
                frac = len(hits) / max(len(win) - K + 1, 1)
                if frac < 0.2:
                    continue
                rs = max(1, hits[0][1] - hits[0][0])
                re_ = min(len(rseq), rs + len(win) - 1)
                err = round(len(win) * (1.0 - identity(frac)))
                alns.append(f"{rs} {re_} {s + 1} {s + len(win)} {err} {err} 0\n1\n0\n")
                if frac > 0.5:  # a repeat over the window's last three quarters: ANImf drops it
                    alns.append(f"{rs} {re_} {s + len(win) // 4 + 1} {s + len(win)} {err + 5} {err + 5} 0\n0\n")
            if alns:
                lines.append(f">{rname} {qname} {len(rseq)} {len(qseq)}\n")
                lines += alns
    with open(prefix + ".delta", "w") as f:
        f.write("".join(lines))


def prodigal(args):
    out = []
    for name, seq in read_fasta(arg(args, "-i")):
        for n, s in enumerate(range(0, len(seq) - 900 + 1, 1000)):
            out.append(f">{name}_{n + 1} # {s + 1} # {s + 900} # 1 # ID={name}_{n + 1}\n{seq[s:s + 900]}\n")
    with open(arg(args, "-d"), "w") as f:
        f.write("".join(out))
    with open(arg(args, "-o"), "w") as f:
        f.write("##gff-version 3\n")


def gene_direction(genes_a, genes_b):
    """(ANI %, AF) of a's genes against b's: a gene aligns where >= 30% of
    its k-mers are b's."""
    kb = set()
    for _, seq in genes_b:
        kb |= kmers(seq)
    aligned = ident = total = 0
    for _, seq in genes_a:
        ka = kmers(seq)
        total += len(seq)
        c = len(ka & kb) / max(len(ka), 1)
        if c >= 0.3:
            aligned += len(seq)
            ident += len(seq) * identity(c)
    return (100.0 * ident / aligned if aligned else 0.0), (aligned / total if total else 0.0)


def anicalculator(args):
    g1, g2 = arg(args, "-genome1fna"), arg(args, "-genome2fna")
    a, b = read_fasta(g1), read_fasta(g2)
    ani12, af12 = gene_direction(a, b)
    ani21, af21 = gene_direction(b, a)
    out_dir = arg(args, "-outdir")
    os.makedirs(out_dir, exist_ok=True)
    n1, n2 = (os.path.basename(g).rsplit(".fna", 1)[0] for g in (g1, g2))
    with open(os.path.join(out_dir, arg(args, "-outfile")), "w") as f:
        f.write("GENOME1\tGENOME2\tANI(1->2)\tANI(2->1)\tAF(1->2)\tAF(2->1)\n")
        f.write(f"{n1}\t{n2}\t{ani12:.4f}\t{ani21:.4f}\t{af12:.4f}\t{af21:.4f}\n")


def nsimscan(args):
    qry, sbj, out_path = args[-3], args[-2], args[-1]
    owner = {}
    for sname, seq in read_fasta(sbj):
        for km in kmers(seq):
            owner.setdefault(km, []).append(sname)
    rows = ["Q_id\tS_id\tAL_LEN\tP_INDEN\n"]
    for qname, seq in read_fasta(qry):
        ka = kmers(seq)
        hits = {}
        for km in ka:
            for sname in owner.get(km, ()):
                hits[sname] = hits.get(sname, 0) + 1
        for sname in sorted(hits):
            c = hits[sname] / max(len(ka), 1)
            if c >= 0.2:
                rows.append(f"{qname}\t{sname}\t{round(len(seq) * c ** 0.25)}\t{100.0 * identity(c):.3f}\n")
    rows.append("# end of hits\n")
    with open(out_path, "w") as f:
        f.write("".join(rows))


def centrifuge(args):
    counts = [[0, 0] for _ in TAXA]
    for _, seq in read_fasta(arg(args, "-U")):
        for s in range(0, len(seq), 1000):
            h = zlib.crc32(seq[s:s + 32].encode())
            t = 0 if h % 8 < 5 else 1 + h % 2
            counts[t][0] += 1
            counts[t][1] += h % 7 != 0
    with open(arg(args, "-S"), "w") as f:
        f.write("readID\tseqID\ttaxID\n")
    with open(arg(args, "--report-file"), "w") as f:
        f.write("name\ttaxID\ttaxRank\tgenomeSize\tnumReads\tnumUniqueReads\tabundance\n")
        total = max(sum(c[0] for c in counts), 1)
        for (name, taxid), (reads, unique) in zip(TAXA, counts):
            f.write(f"{name}\t{taxid}\tspecies\t0\t{reads}\t{unique}\t{reads / total:.4f}\n")


def main():
    args = sys.argv[1:]
    if args in (["--version"], ["-v"]):
        (sys.stderr if TOOL == "prodigal" else sys.stdout).write(VERSIONS.get(TOOL, TOOL) + "\n")
        return
    listed = []  # the genomes of fastANI's list files
    for flag in ("--ql", "--rl"):
        if flag in args:
            with open(arg(args, flag)) as f:
                listed += [ln.strip() for ln in f if ln.strip()]
    log_call(args + ([",".join(listed)] if listed else []))
    maybe_fail(" ".join(args + listed))
    {"mash": mash, "fastANI": fastani, "nucmer": nucmer, "prodigal": prodigal, "ANIcalculator": anicalculator,
     "nsimscan": nsimscan, "centrifuge": centrifuge}[TOOL](args)
'''

FAKE_TOOLS = ("mash", "fastANI", "nucmer", "prodigal", "ANIcalculator", "nsimscan", "centrifuge")


def write_fake_tools(directory: str) -> str:
    """Write the stand-in binaries into `directory`: the module
    ``_fake_tool.py``, compiled here once, and one executable a tool that
    runs it under this interpreter. Returns `directory`, for
    the head of $PATH."""
    import py_compile

    os.makedirs(directory, exist_ok=True)
    module = os.path.join(directory, "_fake_tool.py")
    with open(module, "w") as f:
        f.write(FAKE_TOOL_SOURCE)
    py_compile.compile(module, doraise=True)  # read by every call, where bytecode writing may be off
    for tool in FAKE_TOOLS:
        path = os.path.join(directory, tool)
        with open(path, "w") as f:
            f.write(f"#!{sys.executable} -S\nimport sys\nsys.path.insert(0, {directory!r})\n"
                    "import _fake_tool\n_fake_tool.main()\n")
        os.chmod(path, 0o755)
    return directory


def fake_calls(directory: str) -> list[list[str]]:
    """The calls the stand-ins logged, each [tool, *argv], fastANI's with
    the paths of its list files joined by commas last."""
    path = os.path.join(directory, "calls.log")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]


# phase 14: the main path survives failures (ROADMAP queue 1 item 5):
# faults injected through utils/faults.py on phase 9's prefix of phase 5's
# genomes, then a resume of phase 4's workdir. The counters the fault
# layer books; none may move before phase 14
FAULT_COUNTERS = ("retries", "watchdog_trips", "io_retries", "io_unrecoverable",
                  "corrupt_shards_healed")


def require_no_faults(what: str) -> None:
    """No launch was retried or stopped by the watchdog, no I/O retried
    and nothing injected: a retry must not hide a kernel that fails."""
    from drep_tpu_torch.utils.profiling import counters

    acted = {k: v for k, v in counters.faults.items() if k in FAULT_COUNTERS or k.startswith("injected_")}
    require(not acted, f"{what}: the fault layer acted: {acted}")
    log(f"{what}: the fault counters are empty")


def secondary_calls(cdb) -> list[list[int]]:
    """The primary clusters of each secondary engine call of a run, in
    order, from its Cdb: each large cluster alone, then the small ones in
    the controller's row-bounded batches."""
    from drep_tpu_torch.cluster import controller

    sizes = cdb.groupby("primary_cluster").size()
    multi = [(int(pc), int(m)) for pc, m in sizes.items() if m > 1]
    large = [[pc] for pc, m in multi if m > controller.SMALL_CLUSTER_MAX]
    small = [(pc, list(range(m))) for pc, m in multi if m <= controller.SMALL_CLUSTER_MAX]
    return large + [[pc for pc, _ in batch] for batch in controller.batch_small_clusters(small)]


def phase_resilience_secondary(tmp: str, dev, real: dict) -> dict:
    """Phase 14a: the secondary stage under injected failures, on phase
    5's first PREFIX_OPTION_GENOMES genomes."""
    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.parallel.faulttol import FaultTolError
    from drep_tpu_torch.utils import faults
    from drep_tpu_torch.utils.profiling import counters

    m = PREFIX_OPTION_GENOMES
    t_phase = time.perf_counter()
    want_cdb = real["cdb"].iloc[:m].to_csv(index=False)

    # one injected failure of the first engine call, retried
    wd1, bdb = prefix_workdir(tmp, "p14a_retry_wd", real, m)
    counters.reset()
    faults.configure("secondary_batch:raise:max=1")
    trace_dir = os.path.join(tmp, "trace_14a")
    try:
        with traced(trace_dir):  # phase 16b
            cdb1, launches1, _, _, dt1 = run_option(wd1, bdb, dev, "14a one injected secondary failure")
    finally:
        faults.reset()
    recs = read_trace(trace_dir, "14a", dt1)["records"]
    require(fault_events(recs, "retries") == fault_events(recs, "injected_secondary_batch_raise") == 1,
            f"16b 14a: fault instants {[r['args'] for r in recs if r['ev'] == 'fault']}")
    calls = secondary_calls(cdb1)
    n_calls = len(calls)
    require(counters.faults.get("retries") == 1 and counters.faults.get("injected_secondary_batch_raise") == 1,
            f"14a: fault counters {counters.faults}, expected one injected raise and one retry")
    require(cdb1.to_csv(index=False) == want_cdb, f"14a: Cdb of the retried run != phase 5's first {m} rows")
    require(launches1["indicator_mm"] == n_calls >= 3,
            f"14a: {launches1['indicator_mm']} indicator_mm launches for {n_calls} secondary calls")
    log(f"14a: one injected failure retried; {n_calls} secondary calls, {launches1['indicator_mm']} indicator_mm "
        f"launches, Cdb equal to phase 5's first {m} rows")

    # the third engine call fails past --fault_retries 1: the run raises
    wd2, _ = prefix_workdir(tmp, "p14a_kill_wd", real, m)
    counters.reset()
    reset_launches()
    faults.configure("secondary_batch:raise:skip=2")
    raised = None
    t0 = time.perf_counter()
    try:
        controller.d_cluster_wrapper(wd2, bdb, device=dev, mesh_shape=1, fault_retries=1)
    except FaultTolError as e:  # the expected outcome, required below
        raised = e
    finally:
        faults.reset()
    dt2 = time.perf_counter() - t0
    killed_launches = read_launches()
    require(raised is not None, "14a: the run with its third secondary call failing did not raise FaultTolError")
    ckpt_dir = os.path.join(wd2.location, "data", "secondary_checkpoints")
    saved = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    want_saved = sorted(f"pc_{pc:06d}.npz" for call in calls[:2] for pc in call)
    require(saved == want_saved, f"14a: {len(saved)} checkpoints after the failure, expected the first two "
            f"calls' {len(want_saved)} clusters")
    require(killed_launches["indicator_mm"] == 2 and counters.faults.get("retries") == 1,
            f"14a: the failing run launched {killed_launches['indicator_mm']} indicator_mm, counters {counters.faults}")
    log(f"14a: FaultTolError after the first two secondary calls ({raised}); {len(saved)} clusters checkpointed "
        f"in {dt2:.2f} s")

    # a clean rerun resumes exactly those clusters
    counters.reset()
    cdb3, launches3, _, _, dt3 = run_option(wd2, bdb, dev, "14a rerun after the failure")
    resumed = dict(controller.SECONDARY_RESUMED)
    require(resumed["resumed"] == len(want_saved), f"14a: the rerun resumed {resumed}, expected {len(want_saved)}")
    require(launches3["indicator_mm"] == n_calls - 2,
            f"14a: the rerun launched {launches3['indicator_mm']} indicator_mm for {n_calls - 2} calls left")
    for table in ("Cdb", "Ndb"):
        with open(os.path.join(wd1.location, "data_tables", f"{table}.csv"), "rb") as f, \
                open(os.path.join(wd2.location, "data_tables", f"{table}.csv"), "rb") as g:
            require(f.read() == g.read(), f"14a: the resumed {table} != the first run's")
    require_no_faults("14a rerun")
    log(f"14a: the rerun resumed {resumed['resumed']} of {resumed['clusters']} multi-member clusters, "
        f"{launches3['indicator_mm']} indicator_mm launches, Cdb and Ndb byte-identical to the first run")
    return {"secondary_calls": n_calls, "launches_retried": launches1["indicator_mm"],
            "launches_killed": killed_launches["indicator_mm"], "launches_resumed": launches3["indicator_mm"],
            "checkpointed": len(saved), "resumed": resumed, "retried_s": dt1, "killed_s": dt2, "resumed_s": dt3,
            "phase_s": time.perf_counter() - t_phase}


def phase_resilience_streaming(dev, real: dict, edges_8b: tuple, keep: float) -> dict:
    """Phase 14b: streaming_mash_edges on phase 5's first
    PREFIX_OPTION_GENOMES genomes, once with the second stripe's launch
    failing once, once with the first stripe hanging past the watchdog."""
    from drep_tpu_torch.ops.minhash import pack_sketches
    from drep_tpu_torch.parallel import streaming
    from drep_tpu_torch.parallel.faulttol import FaultTolConfig
    from drep_tpu_torch.utils import faults
    from drep_tpu_torch.utils.profiling import counters

    m = PREFIX_OPTION_GENOMES
    t_phase = time.perf_counter()
    gs = real["gs"]
    packed = pack_sketches(gs.bottom[:m], gs.names[:m], gs.sketch_size)
    ii, jj, dd = edges_8b
    sel = jj < m  # i < j: the pairs inside the prefix
    order = np.lexsort((jj[sel], ii[sel]))
    want = [x[sel][order].tobytes() for x in (ii, jj, dd)]
    out = {}
    for name, spec, cfg, counter in (
        ("raise", "streaming_tile:raise:skip=1:max=1", FaultTolConfig(), "retries"),
        ("hang", "streaming_tile:hang:secs=20:max=1", FaultTolConfig(dispatch_timeout_s=5.0), "watchdog_trips"),
    ):
        counters.reset()
        reset_launches()
        faults.configure(spec)
        t0 = time.perf_counter()
        try:
            got = streaming.streaming_mash_edges(packed, real["k"], keep, device=dev, ft_config=cfg)
        finally:
            faults.reset()
        dt = time.perf_counter() - t0
        st = dict(streaming.STATS)
        launches = read_launches()["mash_shared"]
        require(launches == st["launches"] == st["stripes"] + 1,
                f"14b {name}: {launches} mash_shared launches for {st['stripes']} stripes, expected one more")
        require(counters.faults.get(counter) == 1 and counters.faults.get("retries") == 1,
                f"14b {name}: fault counters {counters.faults}")
        o = np.lexsort((got[1], got[0]))
        require([x[o].tobytes() for x in got[:3]] == want,
                f"14b {name}: the edges != phase 8b's edges inside the first {m} genomes")
        log(f"14b {name}: {spec}: {launches} mash_shared launches for {st['stripes']} stripes, "
            f"{counter} {counters.faults[counter]}, {len(got[0])} edges identical to 8b's in {dt:.2f} s")
        out[name] = {"launches": launches, "stripes": st["stripes"], "s": dt, "edges": len(got[0])}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_resilience_resume(cli: dict) -> dict:
    """Phase 14c: phase 4's dereplicate again on its own workdir with Cdb
    and Ndb removed: the secondary resumes from its checkpoints."""
    import pandas as pd

    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.controller import main as cli_main
    from drep_tpu_torch.utils.profiling import counters

    t0 = time.perf_counter()
    counters.reset()
    for table in ("Cdb", "Ndb"):
        os.remove(os.path.join(cli["wd"], "data_tables", f"{table}.csv"))
    reset_launches()
    cli_main(cli["argv"])
    launches = read_launches()
    resumed = dict(controller.SECONDARY_RESUMED)
    winners = sorted(pd.read_csv(os.path.join(cli["wd"], "data_tables", "Wdb.csv"))["genome"])
    require(resumed == {"resumed": 2, "clusters": 2}, f"14c: resumed {resumed}, expected both multi-member clusters")
    require(launches["indicator_mm"] == 0 and launches["mash_shared"] > 0, f"14c: launches {launches}")
    require(winners == cli["winners"], f"14c: winners {winners} != phase 4's {cli['winners']}")
    dt = time.perf_counter() - t0
    require_no_faults("14c")
    log(f"14c: dereplicate resumed {resumed['resumed']} multi-member clusters from checkpoints, 0 indicator_mm "
        f"launches, winners {winners} in {dt:.2f} s")
    return {"launches": launches, "resumed": resumed, "s": dt}


# phase 15: the subprocess engines and the taxonomy (ROADMAP queue 1 item
# 9b) with the stand-ins first on $PATH: SUB_BASES random genomes of
# SUB_LENGTH bases in two contigs, each with copies at SUB_RATES point
# mutations (the stand-ins' ANI ~ 1 - rate straddles S_ani 0.95; every
# pair stays within P_ani 0.9), so SUB_BASES primary clusters of
# 1 + len(SUB_RATES) members
SUB_BASES = 25
SUB_LENGTH = 6_000
SUB_RATES = (0.01, 0.025, 0.05)
SUB_ENGINES = ("fastANI", "ANImf", "ANIn", "gANI", "goANI")
SUB_THREADS = 8


def write_sub_genomes(gdir: str, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    os.makedirs(gdir)
    paths = []
    for b in range(SUB_BASES):
        seq = bases[rng.integers(0, 4, SUB_LENGTH)]
        for r, rate in enumerate((0.0, *SUB_RATES)):
            s = seq.copy()
            pos = np.nonzero(rng.random(len(s)) < rate)[0]
            s[pos] = bases[(np.searchsorted(bases, s[pos]) + rng.integers(1, 4, len(pos))) % 4]
            cut = SUB_LENGTH * 3 // 5
            path = os.path.join(gdir, f"sub{b:02d}_{r}.fasta")
            with open(path, "w") as f:
                f.write(f">sub{b:02d}_{r}_c1\n{s[:cut].tobytes().decode()}\n"
                        f">sub{b:02d}_{r}_c2\n{s[cut:].tobytes().decode()}\n")
            paths.append(path)
    return paths


def sub_implied_calls(engine: str, sizes: list[int]) -> dict:
    """The binary calls an engine's code makes for multi-member primary
    clusters of these sizes (fastANI one a cluster, ANImf and goANI both
    directions of each pair, ANIn and gANI one a pair, gANI and goANI a
    prodigal a genome)."""
    pairs = sum(m * (m - 1) for m in sizes)
    out = {"fastANI": {"fastANI": len(sizes)}, "ANImf": {"nucmer": pairs}, "ANIn": {"nucmer": pairs // 2},
           "gANI": {"ANIcalculator": pairs // 2}, "goANI": {"nsimscan": pairs}}[engine]
    if engine in ("gANI", "goANI"):
        out["prodigal"] = sum(sizes)
    return out


def calls_by_tool(fakes: str, since: int, until: int | None = None) -> dict:
    """The stand-ins' calls [since:until] of their log, counted by tool."""
    out: dict = {}
    for call in fake_calls(fakes)[since:until]:
        out[call[0]] = out.get(call[0], 0) + 1
    return out


def sub_runs() -> list[tuple[str, dict]]:
    """Phase 15's d_cluster_wrapper runs: (name, arguments)."""
    return [(e, {"S_algorithm": e}) for e in SUB_ENGINES] + [
        ("mash", {"primary_algorithm": "mash", "S_algorithm": "fastANI"})]


def _sub_cpu_twins(root: str, paths: list[str], fakes: str) -> None:
    """Phase 15's twin runs with the CPU device, in a spawned process while
    the card's run (the runs are host work, mostly the stand-ins' starts):
    each of sub_runs() and the dereplicate --run_tax, in workdirs that
    already hold the sketch cache, with their own stand-ins; the calls
    each run made and its seconds to ``cpu_twins.json`` under `root`."""
    import torch

    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.ingest import make_bdb
    from drep_tpu_torch.workdir import WorkDirectory
    from drep_tpu_torch.workflows import dereplicate_wrapper

    os.environ["PATH"] = fakes + os.pathsep + os.environ["PATH"]
    cpu = torch.device("cpu")
    bdb = make_bdb(paths)
    out = {}
    for name, kw in sub_runs():
        n0, t0 = len(fake_calls(fakes)), time.perf_counter()
        controller.d_cluster_wrapper(WorkDirectory(os.path.join(root, f"{name}_cpu")), bdb, device=cpu,
                                     mesh_shape=1, processes=SUB_THREADS, **kw)
        out[name] = {"calls": calls_by_tool(fakes, n0), "s": time.perf_counter() - t0}
    n0, t0 = len(fake_calls(fakes)), time.perf_counter()
    dereplicate_wrapper(os.path.join(root, "tax_cpu"), paths, device=cpu, length=0, skip_plots=True,
                        processes=SUB_THREADS, run_tax=True, cent_index=os.path.join(root, "cent_idx"))
    out["run_tax"] = {"calls": calls_by_tool(fakes, n0), "s": time.perf_counter() - t0}
    path = os.path.join(root, "cpu_twins.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


# processes a phase starts ahead of itself, stopped by main on the way out
CHILDREN: list = []


def start_subprocess_phase(tmp: str) -> dict:
    """Phase 15's genomes, stand-ins and sketch caches, and its CPU twins
    started in a spawned process: called after phase 8, once the plantings'
    processes are done, so that the twins' host work runs beside phases
    9-14 rather than in phase 15's time."""
    import multiprocessing

    from drep_tpu_torch.ingest import make_bdb, save_sketch_cache, sketch_genomes
    from drep_tpu_torch.workdir import WorkDirectory

    t0 = time.perf_counter()
    root = os.path.join(tmp, "subprocess")
    paths = write_sub_genomes(os.path.join(root, "genomes"), seed=15)
    fakes = write_fake_tools(os.path.join(root, "bin"))
    bdb = make_bdb(paths)
    gs = sketch_genomes(bdb)
    for name in [n for n, _ in sub_runs()] + ["tax"]:  # every workdir's ingest loads the cache
        save_sketch_cache(WorkDirectory(os.path.join(root, f"{name}_cpu")), gs)
        save_sketch_cache(WorkDirectory(os.path.join(root, f"{name}_card")), gs)
    twins = multiprocessing.get_context("spawn").Process(
        target=_sub_cpu_twins, args=(root, paths, write_fake_tools(os.path.join(root, "bin_cpu"))),
        name="phase15-cpu-twins")
    twins.start()
    CHILDREN.append(twins)
    return {"root": root, "paths": paths, "fakes": fakes, "bdb": bdb, "gs": gs, "twins": twins,
            "prep_s": time.perf_counter() - t0}


def phase_subprocess(dev, prep: dict) -> dict:
    """Phase 15: d_cluster_wrapper on the card with each subprocess
    secondary under the jax_mash primary and with the mash primary, and a
    dereplicate --run_tax, each against its twin with --device cpu (Cdb,
    Ndb, Mdb / Wdb, Tdb byte-identical; the twins were started by
    start_subprocess_phase); the primary's mash_shared launches only where
    jax_mash runs it, no indicator_mm launch under a subprocess secondary,
    the stand-ins' calls as the engines imply; a fastANI call that fails
    once is retried, one that fails past --fault_retries stops the run,
    whose rerun calls fastANI for the unfinished clusters only."""
    import pandas as pd
    import torch

    from drep_tpu_torch.cluster import controller, engines
    from drep_tpu_torch.ingest import save_sketch_cache
    from drep_tpu_torch.parallel.faulttol import FaultTolError
    from drep_tpu_torch.utils.profiling import counters
    from drep_tpu_torch.workdir import WorkDirectory
    from drep_tpu_torch.workflows import dereplicate_wrapper

    t_phase = time.perf_counter()
    root, paths, fakes, bdb, gs, twins = (prep[k] for k in ("root", "paths", "fakes", "bdb", "gs", "twins"))
    old_path = os.environ["PATH"]
    os.environ["PATH"] = fakes + os.pathsep + old_path
    out: dict = {"genomes": len(paths), "runs": {}}

    def tables(wd, names) -> dict:
        got = {}
        for t in names:
            with open(os.path.join(wd.location, "data_tables", f"{t}.csv"), "rb") as f:
                got[t] = f.read()
        return got

    def run(name: str, **kw):
        """d_cluster_wrapper on the card in `name`'s workdir: (workdir,
        Cdb, launches, the stand-ins' calls by tool, seconds)."""
        wd = WorkDirectory(os.path.join(root, name))
        if not wd.has_arrays("sketches"):
            save_sketch_cache(wd, gs)
        n0 = len(fake_calls(fakes))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cdb = controller.d_cluster_wrapper(wd, bdb, device=dev, mesh_shape=1, processes=SUB_THREADS, **kw)
        torch.cuda.synchronize()
        return wd, cdb, read_launches(), calls_by_tool(fakes, n0), time.perf_counter() - t0

    try:
        # the primary's launches alone, on the card
        reset_launches()
        engines.primary_jax_mash(gs, device=dev, mesh_shape=1)
        torch.cuda.synchronize()
        primary_launches = read_launches()["mash_shared"]
        require(primary_launches > 0, "15: the jax_mash primary launched no mash_shared")

        card = {}
        for engine, kw in sub_runs():
            wd, cdb, launches, calls, dt = run(f"{engine}_card", **kw)
            stages = {k: round(v, 3) for k, v in controller.STAGE_SECONDS.items()}
            sizes = [int(m) for m in cdb.groupby("primary_cluster").size() if m > 1]
            require(len(sizes) == SUB_BASES and set(sizes) == {1 + len(SUB_RATES)},
                    f"15 {engine}: primary clusters of sizes {sizes}")
            n_sec = cdb["secondary_cluster"].nunique()
            require(SUB_BASES < n_sec < len(paths), f"15 {engine}: {n_sec} secondary clusters do not split "
                    f"the {SUB_BASES} primary ones")
            want = sub_implied_calls(kw["S_algorithm"], sizes)
            if engine == "mash":
                want["mash"] = 2
            require(calls == want, f"15 {engine}: the stand-ins logged {calls}, the engine implies {want}")
            want_mash = 0 if engine == "mash" else primary_launches
            require(launches["mash_shared"] == want_mash and launches["indicator_mm"] == 0
                    and sum(launches.values()) == want_mash,
                    f"15 {engine}: launches {launches}, expected {want_mash} mash_shared and nothing else")
            card[engine] = wd
            out["runs"][engine] = {"s": dt, "launches": {k: v for k, v in launches.items() if v},
                                   "calls": calls, "secondary_clusters": n_sec, "stages": stages}
            log(f"15 {engine}: d_cluster_wrapper {dt:.2f} s on the card (stages {json.dumps(stages)}); "
                f"{n_sec} secondary clusters; calls {calls}; launches {out['runs'][engine]['launches']}")

        # dereplicate --run_tax with a stand-in centrifuge index
        n0 = len(fake_calls(fakes))
        reset_launches()
        t0 = time.perf_counter()
        dereplicate_wrapper(os.path.join(root, "tax_card"), paths, device=dev, length=0, skip_plots=True,
                            processes=SUB_THREADS, run_tax=True, cent_index=os.path.join(root, "cent_idx"))
        l_g, c_g, dt_g = read_launches(), calls_by_tool(fakes, n0), time.perf_counter() - t0
        wd_g = WorkDirectory(os.path.join(root, "tax_card"))
        tdb = pd.read_csv(os.path.join(wd_g.location, "data_tables", "Tdb.csv"))
        require(len(tdb) == len(paths) and c_g == {"centrifuge": len(paths)},
                f"15 --run_tax: Tdb of {len(tdb)} rows, centrifuge calls {c_g}")
        require(l_g["mash_shared"] == primary_launches and l_g["indicator_mm"] > 0,
                f"15 --run_tax: launches {l_g}")
        out["run_tax"] = {"s": dt_g, "launches": {k: v for k, v in l_g.items() if v},
                          "taxa": tdb["taxonomy"].value_counts().to_dict()}
        log(f"15 --run_tax: dereplicate {dt_g:.2f} s on the card; Tdb {out['run_tax']['taxa']}; launches "
            f"{out['run_tax']['launches']}")

        # the twins with the CPU device: the same tables and calls
        t0 = time.perf_counter()
        twins.join()
        t_wait = time.perf_counter() - t0
        require(twins.exitcode == 0, f"15: the CPU twins' process exited with {twins.exitcode}")
        with open(os.path.join(root, "cpu_twins.json")) as f:  # written by this run's own process
            cpu_runs = json.load(f)
        for engine, _kw in sub_runs():
            wd_cpu = WorkDirectory(os.path.join(root, f"{engine}_cpu"))
            require(tables(card[engine], ("Cdb", "Ndb", "Mdb")) == tables(wd_cpu, ("Cdb", "Ndb", "Mdb")),
                    f"15 {engine}: Cdb, Ndb or Mdb on the card != with --device cpu")
            require(cpu_runs[engine]["calls"] == out["runs"][engine]["calls"],
                    f"15 {engine}: the CPU run's calls {cpu_runs[engine]['calls']} != the card run's")
            out["runs"][engine]["cpu_s"] = cpu_runs[engine]["s"]
        got = tables(wd_g, ("Cdb", "Ndb", "Wdb", "Tdb"))
        require(got == tables(WorkDirectory(os.path.join(root, "tax_cpu")), got)
                and cpu_runs["run_tax"]["calls"] == c_g, "15 --run_tax: the card's tables or calls != the CPU run's")
        out["run_tax"]["cpu_s"] = cpu_runs["run_tax"]["s"]
        log(f"15: every run's Cdb, Ndb, Mdb (Wdb, Tdb) and calls equal its twin's with the CPU device (waited "
            f"{t_wait:.2f} s for them; CPU seconds {json.dumps({k: round(v['s'], 2) for k, v in cpu_runs.items()})})")

        # a fastANI call failing once is retried; failing twice with
        # --fault_retries 1 stops the run; the rerun resumes
        ref = tables(card["fastANI"], ("Cdb", "Ndb"))
        cdb = pd.read_csv(os.path.join(card["fastANI"].location, "data_tables", "Cdb.csv"))
        clusters = [sorted(g["genome"]) for _pc, g in cdb.groupby("primary_cluster") if len(g) > 1]
        k = len(clusters) // 2
        plan = os.path.join(fakes, "fail.json")

        def fail(times: int) -> None:
            with open(plan, "w") as f:
                json.dump({"tool": "fastANI", "match": clusters[k][0], "times": times}, f)

        fail(1)
        counters.reset()
        wd1, _cdb, launches1, calls1, dt1 = run("retry", S_algorithm="fastANI")
        require(counters.faults.get("retries") == 1 and calls1 == {"fastANI": len(clusters) + 1},
                f"15 retry: counters {counters.faults}, calls {calls1}")
        require(tables(wd1, ("Cdb", "Ndb")) == ref, "15 retry: tables != the clean fastANI run's")
        fail(2)
        counters.reset()
        n0 = len(fake_calls(fakes))
        wd2 = WorkDirectory(os.path.join(root, "killed"))
        save_sketch_cache(wd2, gs)
        raised = None
        try:
            controller.d_cluster_wrapper(wd2, bdb, device=dev, mesh_shape=1, processes=SUB_THREADS,
                                         S_algorithm="fastANI", fault_retries=1)
        except FaultTolError as e:  # the expected outcome, required below
            raised = e
        killed_calls = calls_by_tool(fakes, n0)
        ckpt_dir = os.path.join(wd2.location, "data", "secondary_checkpoints")
        saved = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
        require(raised is not None and len(saved) == k and killed_calls == {"fastANI": k + 2},
                f"15 killed: raised {raised!r}, {len(saved)} clusters checkpointed (want {k}), calls {killed_calls}")
        n0 = len(fake_calls(fakes))
        counters.reset()
        controller.d_cluster_wrapper(wd2, bdb, device=dev, mesh_shape=1, processes=SUB_THREADS,
                                     S_algorithm="fastANI", fault_retries=1)
        rerun = fake_calls(fakes)[n0:]
        resumed = dict(controller.SECONDARY_RESUMED)
        invoked = sorted(sorted({os.path.basename(p) for p in call[-1].split(",")}) for call in rerun)
        require(resumed == {"resumed": k, "clusters": len(clusters)} and invoked == sorted(clusters[k:]),
                f"15 resumed: {resumed}, the rerun invoked fastANI on {len(invoked)} clusters, want the "
                f"{len(clusters) - k} unfinished")
        require(tables(wd2, ("Cdb", "Ndb")) == ref, "15 resumed: tables != the clean fastANI run's")
        require_no_faults("15 rerun")
        out["faults"] = {"retried_s": dt1, "retried_calls": calls1["fastANI"], "checkpointed": len(saved),
                         "killed_calls": killed_calls["fastANI"], "resumed": resumed,
                         "rerun_calls": len(rerun), "launches_retried": launches1["mash_shared"]}
        log(f"15 faults: fastANI retried once ({calls1['fastANI']} calls); FaultTolError after {k} clusters "
            f"checkpointed ({killed_calls['fastANI']} calls); the rerun resumed {k} and called fastANI on the "
            f"{len(rerun)} unfinished clusters; Cdb and Ndb equal the clean run's")
    finally:
        os.environ["PATH"] = old_path
        if twins.is_alive():
            twins.terminate()
        twins.join()
    out["primary_launches"] = primary_launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["prep_s"] = prep["prep_s"]
    log(f"phase 15: {out['phase_s']:.1f} s (and {prep['prep_s']:.1f} s of set-up after phase 8)")
    return out


# phase 16: event tracing and --profile (ROADMAP queue 1 item 13). The
# stage spans of a dereplicate in the JAX package's order (first "B" of
# each), and the CUDA kernels the Chrome trace must hold, by the launch
# counter each must equal
TRACE_STAGES = ("stage:filter", "stage:cluster", "stage:ingest_or_cache", "stage:primary_compare",
                "stage:secondary_compare", "stage:secondary_postprocess", "stage:assembly_io", "stage:choose",
                "stage:evaluate")
PROFILED_KERNELS = {"mash_shared": "mash_shared_kernel", "indicator_mm": "indicator_mm_kernel",
                    "indicator_mm_rect": "indicator_mm_rect_kernel"}
TRACES: dict = {}  # phase 16b's event counts and seconds, by the run traced


@contextlib.contextmanager
def traced(log_dir: str):
    """Event tracing on into `log_dir` around a block (phase 16b), off after."""
    from drep_tpu_torch.utils import telemetry

    require(telemetry.configure(log_dir=log_dir, enabled=True), f"tracing into {log_dir} did not turn on")
    try:
        yield
    finally:
        telemetry.configure()


def read_trace(log_dir: str, what: str, seconds: float) -> dict:
    """The event log of `log_dir` through the port's reader: every line
    parses, every span closed; returns the counts by (ev, ph) and keeps
    them, with the traced run's seconds, for the phase 16 line."""
    from drep_tpu_torch.utils import telemetry

    recs = telemetry.read_events(log_dir)
    with open(os.path.join(log_dir, "events.p0.jsonl")) as f:
        lines = sum(1 for _ in f)
    require(recs and len(recs) == lines, f"16 {what}: {len(recs)} records parsed of {lines} lines")
    unclosed = telemetry.open_spans(recs)
    require(not unclosed, f"16 {what}: unclosed or unopened spans {unclosed}")
    counts: dict = {}
    for r in recs:
        key = f"{r['ev']}:{r['ph']}"
        counts[key] = counts.get(key, 0) + 1
    TRACES[what] = {"events": len(recs), "s": seconds, "counts": counts}
    return {"records": recs, "counts": counts}


def fault_events(recs: list, kind: str) -> int:
    return sum(int(r["args"]["n"]) for r in recs if r["ev"] == "fault" and r["args"]["kind"] == kind)


def profiled_kernels(trace_path: str) -> dict:
    """The CUDA kernel events of a torch.profiler Chrome trace, counted by
    PROFILED_KERNELS' names (a name is matched as a whole word, so
    indicator_mm_kernel does not count the _rect_ kernel's)."""
    import re

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {}
    for counter, name in PROFILED_KERNELS.items():
        word = re.compile(rf"(^|[^A-Za-z0-9_]){name}([^A-Za-z0-9_]|$)")
        out[counter] = sum(1 for e in kernels if word.search(e.get("name", "")))
    out["all_kernels"] = len(kernels)
    return out


def autoscale_tick(tmp: str, raddr: str, specs: list[str]) -> dict:
    """Phase 16c: one recommend-only FleetAutoscaleController tick against
    phase 13b's live router: one decision record a partition range, with
    the JAX package's keys, and nothing placed or drained."""
    from drep_tpu_torch.autoscale import FleetAutoscaleController, Targets
    from drep_tpu_torch.serve import ServeClient

    log_path = os.path.join(tmp, "autoscale.jsonl")
    t0 = time.perf_counter()
    with ServeClient(raddr, timeout_s=120) as client:
        ctl = FleetAutoscaleController(client, Targets(max_procs=4), queue_deadline_s=5.0, svc_s=0.2,
                                       decision_log=log_path)
        ctl.poll_once()
    dt = time.perf_counter() - t0
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    ranges = sorted(spec.split("=", 1)[1] for spec in specs)
    keys = {"at", "range", "verdict", "delta", "reason", "inputs", "actuation"}
    require(sorted(r["range"] for r in records) == ranges and all(set(r) == keys for r in records)
            and all(r["actuation"] == "" or r["actuation"].startswith("skipped") for r in records)
            and not ctl.history, f"16c: decision records {records}")
    out = {"s": dt, "decisions": [{k: r[k] for k in ("range", "verdict", "reason")} for r in records]}
    log(f"16c: one recommend-only autoscale tick in {dt:.3f} s: {out['decisions']}")
    return out


def phase_trace(tmp: str, cli: dict) -> dict:
    """Phase 16a: phase 4's fixture dereplicate again, in a new workdir,
    with ``--events on --profile``: the event log parses line by line, its
    spans close, the stage spans come in the JAX package's order and
    ``run_finished`` ends it; the Chrome trace under
    ``<wd>/log/torch_trace`` holds the hand-written kernels, each as many
    times as its launch counter says."""
    from drep_tpu_torch.controller import main as cli_main

    wd = os.path.join(tmp, "fixture_traced_wd")
    argv = [cli["argv"][0], wd, *cli["argv"][2:], "--events", "on", "--profile"]
    reset_launches()
    t0 = time.perf_counter()
    cli_main(argv)
    dt = time.perf_counter() - t0
    launches = read_launches()
    import pandas as pd

    winners = sorted(pd.read_csv(os.path.join(wd, "data_tables", "Wdb.csv"))["genome"])
    require(winners == cli["winners"], f"16a: winners {winners} != phase 4's {cli['winners']}")
    tr = read_trace(os.path.join(wd, "log"), "16a", dt)
    recs = tr["records"]
    order = []
    for r in recs:
        if r["ph"] == "B" and r["ev"].startswith("stage:") and r["ev"] not in order:
            order.append(r["ev"])
    require(tuple(order) == TRACE_STAGES, f"16a: stage spans in the order {order}, expected {TRACE_STAGES}")
    require(tr["counts"].get("stage_open:i") == tr["counts"].get("stage_close:i") == 1,
            f"16a: secondary stage_open/stage_close {tr['counts']}")
    require(recs[-1]["ev"] == "run_finished", f"16a: the log ends with {recs[-1]['ev']}, not run_finished")
    trace_path = os.path.join(wd, "log", "torch_trace", "trace.json")
    seen = profiled_kernels(trace_path)
    want = {k: launches[k] for k in PROFILED_KERNELS}
    require({k: seen[k] for k in PROFILED_KERNELS} == want and want["mash_shared"] > 0 and want["indicator_mm"] > 0,
            f"16a: the Chrome trace holds kernels {seen}, the launch counters say {want}")
    out = {"s": dt, "launches": want, "profiled": seen, "events": len(recs),
           "trace_bytes": os.path.getsize(trace_path)}
    log(f"16a: traced and profiled dereplicate in {dt:.2f} s: {len(recs)} events, stage spans in the JAX order, "
        f"the Chrome trace's kernels {seen} equal the launch counters {want}")
    return out


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

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    plants = [Planting(tmp, "beyond", None),
              Planting(tmp, "real", REAL_GENOMES, 2, REAL_SCALED_DEPTH),
              Planting(tmp, "stream", STREAM_GENOMES, 21, STREAM_SCALED_DEPTH)]
    try:
        return run_phases(dev, card, tmp, *plants)
    finally:
        for p in plants:
            p.stop()
        for proc in CHILDREN:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(tmp, ignore_errors=True)


def run_phases(dev, card: str, tmp: str, plant_beyond_: Planting, plant_real: Planting,
               plant_stream: Planting) -> int:
    """Phases 2-18 (main has printed phase 1 and started the plantings)."""
    import torch

    from drep_tpu_torch.native import get_library
    from drep_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    native_ok = get_library() is not None
    log(f"build: CUDA kernels {list(_build.SOURCES)} and native ingest (ok={native_ok}) "
        f"in {time.perf_counter() - t0:.2f} s")
    for name, out in _build.BUILD_LOG.items():  # ptxas: registers, static shared memory, spills per kernel
        log(f"build {name}: " + " | ".join(ln.strip() for ln in out.splitlines()
                                           if "ptxas info" in ln and ("Used" in ln or "spill" in ln)))

    (gs_beyond, planted_beyond), t_plant, t_wait = plant_beyond_.result()
    log(f"beyond budget: planted {len(gs_beyond.names)} genomes in {t_plant:.1f} s (in its own process beside the "
        f"build; waited {t_wait:.1f} s for it)")
    kernels = [phase_mash(dev), phase_indicator(dev, gs_beyond, planted_beyond),
               *phase_intersect(dev, gs_beyond, planted_beyond)]
    cli = phase_cli(tmp, dev)
    real = phase_real_size(tmp, dev, plant_real)
    beyond = phase_beyond(tmp, dev, gs_beyond, planted_beyond)
    ring_kernel = phase_ring_kernel(dev, real["packed"], gs_beyond, planted_beyond)
    ring_primary = phase_ring_primary(dev, real["packed"], real["k"])
    ring_path = phase_ring_path(tmp, dev, gs_beyond, planted_beyond, beyond)
    ring_mm = phase_ring_matmul(dev, gs_beyond, planted_beyond, beyond)
    stream = phase_streaming_auto(tmp, dev, plant_stream)
    stream_edges = phase_streaming_edges(tmp, dev, real["packed"], real["k"])
    edges_8b = stream_edges.pop("edge_arrays")
    sub_prep = start_subprocess_phase(tmp)
    t9 = time.perf_counter()
    p9a = phase_matmul_estimator(tmp, dev, real)
    p9b = phase_multiround(tmp, dev, real)
    p9c = phase_greedy(tmp, dev, real, gs_beyond, planted_beyond, beyond)
    p9d = phase_tertiary(tmp, dev, real)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    p10 = phase_index(tmp, dev, real)
    require_no_faults("phases 1-10")  # phase 11 restarts the counters
    p11 = phase_serve(tmp, dev, p10)
    p12 = phase_federation(tmp, dev, real, p10)
    p13 = phase_fed_serve(tmp, dev, p10, p12)
    require_no_faults("phases 11-13")  # the maintenance verbs' CLI restarts the counters
    p12.update(phase_federation_maint(tmp, dev, real, p10, p12))
    require_no_faults("12d-e")
    t14 = time.perf_counter()
    p14 = {"a": phase_resilience_secondary(tmp, dev, real),
           "b": phase_resilience_streaming(dev, real, edges_8b, stream_edges["keep"]),
           "c": phase_resilience_resume(cli)}
    p14["phase_s"] = time.perf_counter() - t14
    log(f"phase 14: {p14['phase_s']:.1f} s")
    p15 = phase_subprocess(dev, sub_prep)
    t16 = time.perf_counter()
    p16 = phase_trace(tmp, cli)
    p16["phase_s"] = time.perf_counter() - t16
    log(f"phase 16: {json.dumps({'16a': p16, '16b': TRACES})}")
    mash_entry = ring_kernel["mash"]
    kernels.append({
        "name": "ring_step", "route": "cuda", "source": "drep_tpu_torch/csrc/ring_step.cu",
        "replaces": "drep_tpu/ops/pallas_ring.py:258", "equal": True, "max_abs_err": 0,
        **{key: mash_entry[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "unfused_ms", "shape")},
        "library_ms": None, "containment": ring_kernel["containment"],
        "containment_wide": ring_kernel["containment_wide"],
        "ring_primary": ring_primary, "ring_path_d_cluster_s": ring_path["d_cluster_s"],
        "ring_path_mdb_max_abs_err": ring_path["mdb_max_abs_err"],
    })
    mm_main = ring_mm["shapes"]["B"]
    kernels.append({
        "name": "ring_step_mm", "route": "cuda", "source": "drep_tpu_torch/csrc/ring_step_mm.cu",
        "replaces": "drep_tpu/ops/pallas_ring.py:305", "equal": True, "max_abs_err": 0,
        **{key: mm_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "tensor_core_bound_ms",
                                         "library_ms", "merge_step_ms", "shape", "v_pad")},
        "shapes": ring_mm["shapes"], "rings": ring_mm["rings"],
    })
    rect = p9c["rect"]
    rect_main = rect["B"]
    kernels.append({
        "name": "indicator_mm_rect", "route": "cuda", "source": "drep_tpu_torch/csrc/indicator_mm.cu",
        "replaces": "drep_tpu/ops/pallas_indicator.py:50", "site": "drep_tpu/ops/containment.py:508",
        "equal": True, "max_abs_err": 0,
        **{key: rect_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "tensor_core_bound_ms",
                                           "library_ms", "shape", "walk", "walks_ms")},
        "clusters": rect, "greedy_timings": p9c["timings"],
    })
    for k in kernels:
        path = real if k["name"] in PRIMARY_PATH_KERNELS else ring_path if k["name"].startswith("ring_step") \
            else p9c if k["name"] == "indicator_mm_rect" else beyond
        k["launches"] = path["launches"][k["name"]]
    kernels[1]["main_path"] = real["secondary"]
    kernels[1]["chunked_launches"] = beyond["launches"]["indicator_mm"]
    kernels[0]["main_path_ms"] = real["mash_ms"]
    kernels[0]["main_path_rows"] = real["mash_rows"]
    kernels[0]["main_path_bound_ms"] = real["mash_bound_ms"]
    kernels[0]["streaming"] = {**{k: v for k, v in stream.items() if k != "stages"}, "edges_10k": stream_edges}
    kernels[0]["multiround_launches"] = p9b["launches"]["mash_shared"]
    kernels[1]["matmul_estimator"] = {**p9a["chunk0"], "launches": p9a["launches"]["indicator_mm"]}
    kernels[1]["tertiary_launches"] = p9d["launches"]["indicator_mm"]
    # phase 10, the genome index: the tail rectangle's stripes and the
    # dirty clusters' secondary launches, each at the index's own shapes
    index_common = {k: p10[k] for k in ("build_s", "update_s", "update_parts", "rect_pairs", "rect_pairs_per_s",
                                         "load_resident_s", "classify_joint_s", "classify_separate_s", "prefix")}
    for k, name, part in ((kernels[0], "mash_shared", "stripe"), (kernels[1], "indicator_mm", "largest_cluster")):
        k["index"] = {**p10[part], **index_common}
        k["index_launches"] = {"update": p10["launches_update"][name],
                               **{f"classify_{m}": p10["launches_classify"][m][name] for m in ("joint", "separate")}}
        k["serve_launches"] = p11["launches"][name]
        # phase 12, the federated index and its maintenance verbs
        k["federation_launches"] = {
            **{part: p12[part]["launches"][name] for part in ("build", "update", "classify")},
            **{f"maintenance_{v}": p12["maintenance"][v]["launches"].get(name, 0) for v in p12["maintenance"]},
            "prefix_in_process": p12["pods"]["in_process_launches"][name]}
    kernels[0]["federation"] = {
        **{f"{part}_s": p12[part]["s"] for part in ("build", "update", "classify")},
        **{f"{part}_{k}": p12[part][k] for part in ("build", "update") for k in (
            "join_s", "cross_candidates", "walk_s", "cross_pairs", "cross_launches")},
        "pods_s": p12["pods"]["pods_s"], "in_process_s": p12["pods"]["in_process_s"], "phase_s": p12["phase_s"]}
    # phase 13, serving the federated root: the daemon (13a) and the router
    # over two replicas (13b), each side's launches and the batch's parts
    for k, name, work in ((kernels[0], "mash_shared", "stripes"), (kernels[1], "indicator_mm", "secondary_calls")):
        k["federated_serve"] = {
            "daemon": {"launches": p13["a"]["launches"][name], "serve_s": p13["a"]["serve_s"],
                       "start_s": p13["a"]["start_s"], "batches": p13["a"]["batches"],
                       **{key: p13["a"]["work"][key] for key in ("pack_s", "walk_s", "recluster_s")}},
            **{mode: {"launches": p13[mode]["launches"][name], "serve_s": p13[mode]["serve_s"],
                      "replica_launches": [w[work] for w in p13[mode]["replica_work"]],
                      "router_launches": p13[mode]["router_work"].get(work, 0),
                      "legs": p13[mode]["replica_legs"], "traced": mode == "scatter"}
               for mode in ("scatter", "forward")},
            "phase_s": p13["phase_s"]}
    # phase 14, resilience: the launches of each faulted or resumed run
    kernels[0]["resilience_launches"] = {"14b_raise": p14["b"]["raise"]["launches"],
                                         "14b_hang": p14["b"]["hang"]["launches"],
                                         "14b_stripes": p14["b"]["raise"]["stripes"],
                                         "14c": p14["c"]["launches"]["mash_shared"]}
    kernels[1]["resilience_launches"] = {
        "14a_retried": p14["a"]["launches_retried"], "14a_killed": p14["a"]["launches_killed"],
        "14a_resumed": p14["a"]["launches_resumed"], "14a_calls": p14["a"]["secondary_calls"],
        "14c": p14["c"]["launches"]["indicator_mm"]}
    kernels[0]["resilience"] = {"14a_s": p14["a"]["phase_s"], "14a_traced": True, "14b_s": p14["b"]["phase_s"], "14c_s": p14["c"]["s"],
                                "phase_s": p14["phase_s"]}
    # phase 15, the subprocess engines: each run's launches (the jax_mash
    # primary's alone, none under the mash primary or a subprocess secondary)
    for k in kernels[:2]:
        k["subprocess_launches"] = {**{e: r["launches"].get(k["name"], 0) for e, r in p15["runs"].items()},
                                    "run_tax": p15["run_tax"]["launches"].get(k["name"], 0)}
    # phase 16, tracing: 16a's profiled run (its launches and the Chrome
    # trace's kernel events), 16b's traced runs, 16c's autoscale tick
    for k in kernels[:2]:
        k["profiled"] = {"launches": p16["launches"][k["name"]], "trace_events": p16["profiled"][k["name"]]}
    # 16b traces runs made anyway, so 11a's, 13b scatter's and 14a's
    # seconds and latencies above are taken with tracing on ("traced")
    kernels[0]["trace"] = {"16a_s": p16["s"], "16a_events": p16["events"], "16a_trace_bytes": p16["trace_bytes"],
                           "phase_s": p16["phase_s"], "16b": {w: {"events": t["events"], "s": t["s"]}
                                                             for w, t in TRACES.items()},
                           "16c": p13["autoscale"]}
    kernels[0]["subprocess"] = {"primary_launches": p15["primary_launches"], "phase_s": p15["phase_s"],
                                "prep_s": p15["prep_s"], "runs_s": {e: r["s"] for e, r in p15["runs"].items()},
                                "faults": p15["faults"]}
    # phase 11, the serve daemon: the Mash kernel at the resident shape
    # ([N_pad resident rows x the batch's query rows], one launch a batch)
    kernels[0]["serve"] = {**p11["kernel"], **{k: p11[k] for k in (
        "batches", "requests", "upload_s", "rect_s", "resident_rect_s", "union_pack_s", "union_walk_s", "serve_s",
        "start_s")}, "traced": True}
    # the merge kernels on the operands their route built in phase 6 (B:
    # width 2048, A: stacked buckets), and the other route on the same pack
    # in place of a library call
    for k, key in ((kernels[2], "B"), (kernels[3], "A")):
        part = beyond["parts"][key]
        require(part["kernel"] == k["name"], f"cluster {key} ran {part['kernel']}, expected {k['name']}")
        k.update(main_path_ms=part["ms"], main_path_plain_ms=part["plain_ms"],
                 main_path_bound_ms=part["bound_ms"], main_path_shape=part["shape"],
                 main_path_dtype=part["dtype"],
                 pallas_range_s=beyond["routes"][key]["pallas_range_s"],
                 matmul_chunked_s=beyond["routes"][key]["matmul_chunked_s"])
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
