"""Genome ingest: FASTA files -> per-genome stats + MinHash/scaled sketches.

Counterpart of drep_tpu/ingest.py. The host side of the sketching
pipeline: a process pool over genomes runs sketch_worker.sketch_one (the
C++ ingest when g++ is available, numpy otherwise). Results are cached in
the work directory (``data/arrays/sketches.npz`` + the Gdb table + the
``sketch`` argument snapshot) in the SAME format the JAX package writes,
so either package resumes from the other's cache. :func:`sketch_paths`
runs the same sketcher with no workdir, for the genome index.

The JAX package's mid-run ingest shard store and its multi-host barrier
are not ported yet: a killed ingest restarts from the first genome.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.ops import kmers
from drep_tpu_torch.sketch_worker import sketch_one as _sketch_one
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.workdir import WorkDirectory

DEFAULT_SKETCH_SIZE = 1000  # reference: --MASH_sketch default 1000
DEFAULT_SCALE = 200  # FracMinHash scale for the jax_ani secondary


@dataclass
class GenomeSketches:
    names: list[str]
    # genome, length, N50, contigs, n_kmers. NB: n_kmers is the EXACT distinct
    # count for small genomes but the FracMinHash estimate |scaled|*scale on
    # the fast path
    gdb: pd.DataFrame
    bottom: list[np.ndarray]  # uint64 bottom-k sketches (sorted)
    scaled: list[np.ndarray]  # uint64 scaled sketches (sorted, ragged)
    k: int
    sketch_size: int
    scale: int


def sketches_from_arrays(
    names, bottom, scaled, gdb: pd.DataFrame, k: int, sketch_size: int, scale: int
) -> GenomeSketches:
    """The JAX package's GenomeSketches fields, as numpy, -> the port's."""
    return GenomeSketches(
        names=[str(n) for n in names],
        gdb=gdb.copy(),
        bottom=[np.asarray(b, dtype=np.uint64) for b in bottom],
        scaled=[np.asarray(s, dtype=np.uint64) for s in scaled],
        k=int(k),
        sketch_size=int(sketch_size),
        scale=int(scale),
    )


def sketch_args_snapshot(genomes, k: int, sketch_size: int, scale: int, hash_name: str) -> dict:
    """THE sketch-cache compatibility key (identical to the JAX package's)."""
    return {
        "k": k, "sketch_size": sketch_size, "scale": scale,
        "hash": hash_name, "genomes": sorted(genomes),
    }


def _pack_ragged(arrs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Ragged uint64 arrays -> (flat concat, int64 offsets)."""
    flat = np.concatenate(arrs) if arrs else np.empty(0, np.uint64)
    return flat, np.cumsum([0] + [len(a) for a in arrs]).astype(np.int64)


def _unpack_ragged(flat: np.ndarray, offs: np.ndarray, n: int) -> list[np.ndarray]:
    return [flat[offs[i] : offs[i + 1]] for i in range(n)]


# the index store and the federation's params handoff serialize sketches
# in this one ragged layout
pack_ragged = _pack_ragged
unpack_ragged = _unpack_ragged


def _sketch_jobs(jobs: list[tuple], processes: int) -> dict[str, dict]:
    """sketch_worker.sketch_one over `jobs`, in a spawn pool when asked."""
    results: dict[str, dict] = {}
    if processes > 1 and len(jobs) > 1:
        # spawn, not fork: the parent may hold CUDA and threads
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=processes, mp_context=ctx) as pool:
            for name, res in pool.map(_sketch_one, jobs):
                results[name] = res
    else:
        for job in jobs:
            name, res = _sketch_one(job)
            results[name] = res
    return results


def _refuse_unparsed(names, results: dict[str, dict], k: int) -> None:
    unparsed = [g for g in names if results[g]["n_kmers"] == 0]
    if unparsed:
        shown = ", ".join(unparsed[:10]) + (" ..." if len(unparsed) > 10 else "")
        raise UserInputError(
            f"no FASTA records with valid nucleotide {k}-mers in {len(unparsed)} "
            f"input file(s) (not FASTA, empty, or shorter than k): {shown}"
        )


def sketch_paths(
    bdb: pd.DataFrame,
    k: int,
    sketch_size: int,
    scale: int,
    hash_name: str,
    processes: int = 1,
) -> dict[str, dict]:
    """Sketch a Bdb's genomes with no workdir or cache: the genome
    index's ingest (index/update.py, index/classify.py), whose durability
    is the index store. Returns {name: {length, N50, contigs, n_kmers,
    bottom, scaled}} from the per-genome sketcher the pipeline runs, so
    an update's sketches are those a from-scratch run would ingest.
    Raises UserInputError on unparseable inputs."""
    jobs = [(row.genome, row.location, k, sketch_size, scale, hash_name) for row in bdb.itertuples()]
    results = _sketch_jobs(jobs, processes)
    _refuse_unparsed(sorted(results), results, k)
    return results


def sketch_genomes(
    bdb: pd.DataFrame,
    k: int = kmers.DEFAULT_K,
    sketch_size: int = DEFAULT_SKETCH_SIZE,
    scale: int = DEFAULT_SCALE,
    processes: int = 1,
    wd: WorkDirectory | None = None,
    hash_name: str = "splitmix64",
) -> GenomeSketches:
    """Sketch every genome in Bdb; cache/restore via the work directory."""
    logger = get_logger()
    args_snapshot = sketch_args_snapshot(bdb["genome"], k, sketch_size, scale, hash_name)

    if wd is not None and wd.has_arrays("sketches") and wd.arguments_match("sketch", args_snapshot):
        cached = _load(wd, k, sketch_size, scale)
        if not (cached.gdb["n_kmers"] == 0).any():
            logger.info("loading cached sketches from workdir")
            return cached
        logger.warning("ingest: cached sketches contain zero-kmer genomes — recomputing")

    jobs = [(row.genome, row.location, k, sketch_size, scale, hash_name) for row in bdb.itertuples()]
    results = _sketch_jobs(jobs, processes)
    names = list(bdb["genome"])
    _refuse_unparsed(names, results, k)
    gdb = pd.DataFrame(
        {
            "genome": names,
            "length": [results[g]["length"] for g in names],
            "N50": [results[g]["N50"] for g in names],
            "contigs": [results[g]["contigs"] for g in names],
            "n_kmers": [results[g]["n_kmers"] for g in names],
        }
    )
    out = GenomeSketches(
        names=names,
        gdb=gdb,
        bottom=[results[g]["bottom"] for g in names],
        scaled=[results[g]["scaled"] for g in names],
        k=k,
        sketch_size=sketch_size,
        scale=scale,
    )
    if wd is not None:
        save_sketch_cache(wd, out, hash_name)
    return out


def save_sketch_cache(wd: WorkDirectory, gs: GenomeSketches, hash_name: str = "splitmix64") -> None:
    """Store `gs` as the workdir's sketch cache plus its argument snapshot,
    so the next sketch_genomes over the same genomes and arguments loads it."""
    _save(wd, gs)
    wd.store_arguments(
        "sketch", sketch_args_snapshot(gs.names, gs.k, gs.sketch_size, gs.scale, hash_name)
    )


def _save(wd: WorkDirectory, gs: GenomeSketches) -> None:
    bottom, bottom_offsets = _pack_ragged(gs.bottom)
    scaled, scaled_offsets = _pack_ragged(gs.scaled)
    wd.store_arrays(
        "sketches",
        # uniform 64-bit hashes are incompressible
        compressed=False,
        bottom=bottom,
        bottom_offsets=bottom_offsets,
        scaled=scaled,
        scaled_offsets=scaled_offsets,
        names=np.array(gs.names, dtype=object).astype(str),
    )
    wd.store_db(gs.gdb, "Gdb")


def _load(wd: WorkDirectory, k: int, sketch_size: int, scale: int) -> GenomeSketches:
    arrs = wd.get_arrays("sketches")
    names = [str(x) for x in arrs["names"]]
    bottom = _unpack_ragged(arrs["bottom"], arrs["bottom_offsets"], len(names))
    scaled = _unpack_ragged(arrs["scaled"], arrs["scaled_offsets"], len(names))
    return GenomeSketches(
        names=names,
        gdb=wd.get_db("Gdb"),
        bottom=bottom,
        scaled=scaled,
        k=k,
        sketch_size=sketch_size,
        scale=scale,
    )


def make_bdb(genome_paths: list[str]) -> pd.DataFrame:
    """Genome list -> Bdb (genome name = basename, reference convention).
    Fails fast on unreadable paths, naming them."""
    names = [os.path.basename(p) for p in genome_paths]
    if len(set(names)) != len(names):
        raise UserInputError("duplicate genome basenames in input list")
    missing = [p for p in genome_paths if not os.path.isfile(p)]
    if missing:
        shown = ", ".join(missing[:10]) + (" ..." if len(missing) > 10 else "")
        raise UserInputError(
            f"{len(missing)} genome file(s) do not exist or are not files: {shown}"
        )
    return pd.DataFrame({"genome": names, "location": [os.path.abspath(p) for p in genome_paths]})
