"""Genome ingest: FASTA files -> per-genome stats + MinHash/scaled sketches.

Counterpart of drep_tpu/ingest.py. The host side of the sketching
pipeline: a process pool over genomes runs sketch_worker.sketch_one (the
C++ ingest when g++ is available, numpy otherwise). Results are cached in
the work directory (``data/arrays/sketches.npz`` + the Gdb table + the
``sketch`` argument snapshot) in the SAME format the JAX package writes,
so either package resumes from the other's cache. :func:`sketch_paths`
runs the same sketcher with no workdir, for the genome index.

Mid-run, finished genomes flush every INGEST_SHARD genomes to sketch
shards under ``data/sketch_shards/`` (the JAX package's shard and meta
format), so a killed ingest resumes where it stopped, from either
package's shards; the shards are removed once the whole-run cache is
written.

On a pod (parallel/mesh.py) the ingest is sharded, as in the JAX
package: each member sketches its stripe of the genomes (job i to member
i mod N) into the shared shard store, then assembles the whole set by
reading its peers' shards until every genome is covered. The barrier is
data completeness, bounded by ``DREP_TORCH_INGEST_BARRIER_S`` of no new
shard; a member with unparseable inputs leaves a poison note that fails
its peers at once. Every member ends with the same sketch set; member 0
writes the whole-run cache once its peers signal ``assembled_<id>.done``
and removes the shards.
"""

from __future__ import annotations

import contextlib
import glob
import multiprocessing
import os
import shutil
import time
import uuid
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import pandas as pd

from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.ops import kmers
from drep_tpu_torch.sketch_worker import sketch_one as _sketch_one
from drep_tpu_torch.utils.durableio import atomic_write_bytes
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


# genomes per ingest shard: a killed ingest of hours of host sketching
# resumes from the shards flushed so far
INGEST_SHARD = 512

_SKETCH_SHARD_SUBDIR = os.path.join("data", "sketch_shards")
_SHARD_SCALARS = ("length", "N50", "contigs", "n_kmers")


def _sketch_shard_meta(args_snapshot: dict) -> dict:
    """The shard store's meta for an args snapshot (the JAX package's),
    shared by sketch_genomes and sketch_cache_will_hit so the two agree."""
    from drep_tpu_torch.utils.ckptmeta import content_fingerprint

    return {
        "kind": "sketch_shards",
        "k": args_snapshot["k"], "sketch_size": args_snapshot["sketch_size"],
        "scale": args_snapshot["scale"], "hash": args_snapshot["hash"],
        "genomes": content_fingerprint(args_snapshot["genomes"]),
    }


def sketch_cache_will_hit(wd: WorkDirectory | None, genomes, k: int, sketch_size: int, scale: int,
                          hash_name: str) -> bool:
    """Will :func:`sketch_genomes` return without sketching a genome? True
    when the whole-run cache matches (and holds no zero-kmer genome), or
    when a matching shard store already covers every genome (a run killed
    after its last flush). Reads only; sketch_genomes checks everything
    again itself, so a wrong answer costs only the warmup overlap."""
    from drep_tpu_torch.utils.ckptmeta import checkpoint_meta_matches

    if wd is None:
        return False
    snapshot = sketch_args_snapshot(genomes, k, sketch_size, scale, hash_name)
    if wd.has_arrays("sketches") and wd.arguments_match("sketch", snapshot):
        # sketch_genomes drops a cache that holds a zero-kmer genome
        try:
            if not (wd.get_db("Gdb")["n_kmers"] == 0).any():
                return True
        except Exception:  # noqa: BLE001 — an unreadable Gdb: the shard probe decides
            pass
    shard_dir = os.path.join(wd.location, _SKETCH_SHARD_SUBDIR)
    try:
        if not checkpoint_meta_matches(shard_dir, _sketch_shard_meta(snapshot)):
            return False
    except OSError:
        return False  # advisory: sketch_genomes' own open reports it
    covered: set[str] = set()
    for f in glob.glob(os.path.join(shard_dir, "*.npz")):
        try:
            with np.load(f, allow_pickle=False) as z:  # reads only these two members
                names = [str(x) for x in z["names"]]
                n_kmers = z["n_kmers"]
        except Exception:  # noqa: BLE001 — a corrupt shard's genomes are sketched again
            return False
        covered.update(g for g, n in zip(names, n_kmers) if int(n) > 0)
    return covered >= set(snapshot["genomes"])


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


def _iter_sketches(jobs: list[tuple], processes: int) -> Iterator[tuple[str, dict]]:
    """(name, result) of sketch_worker.sketch_one over `jobs` in order, in
    a spawn pool when asked."""
    if processes > 1 and len(jobs) > 1:
        # spawn, not fork: the parent may hold CUDA and threads
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=processes, mp_context=ctx) as pool:
            yield from pool.map(_sketch_one, jobs)
    else:
        for job in jobs:
            yield _sketch_one(job)


def _save_sketch_shard(path: str, batch: dict[str, dict]) -> None:
    from drep_tpu_torch.utils.durableio import atomic_savez

    names = list(batch)
    payload: dict[str, np.ndarray] = {"names": np.array(names, dtype=object).astype(str)}
    for key in _SHARD_SCALARS:
        payload[key] = np.array([batch[g][key] for g in names], dtype=np.int64)
    for key in ("bottom", "scaled"):
        payload[key], payload[f"{key}_offsets"] = _pack_ragged([batch[g][key] for g in names])
    atomic_savez(path, **payload)


def _load_sketch_shard(path: str) -> dict[str, dict]:
    from drep_tpu_torch.utils.durableio import load_npz_checked

    z = load_npz_checked(path, what="sketch shard")
    names = [str(x) for x in z["names"]]
    bottom = _unpack_ragged(z["bottom"], z["bottom_offsets"], len(names))
    scaled = _unpack_ragged(z["scaled"], z["scaled_offsets"], len(names))
    return {
        g: {**{key: int(z[key][i]) for key in _SHARD_SCALARS}, "bottom": bottom[i].copy(), "scaled": scaled[i].copy()}
        for i, g in enumerate(names)
    }


def _resume_shards(shard_dir: str) -> dict[str, dict]:
    """The genomes a shard store holds, zero-kmer entries dropped (a
    genome resumed by name would raise the input error again after the
    user fixed its file). A shard the retries could not read is left in
    place, its genomes sketched again; a corrupt one is counted and
    removed (durableio.quarantine_corrupt); one removed since the glob is
    skipped."""
    from drep_tpu_torch.utils.durableio import quarantine_corrupt

    logger = get_logger()
    results: dict[str, dict] = {}
    for f in sorted(glob.glob(os.path.join(shard_dir, "*.npz"))):
        try:
            shard = _load_sketch_shard(f)
        except FileNotFoundError:
            continue
        except OSError:
            logger.warning("ingest: unreadable sketch shard %s — recomputing its genomes", f)
            continue
        except Exception:  # noqa: BLE001 — any corrupt shard: its genomes are sketched again
            logger.warning("ingest: corrupt sketch shard %s — recomputing its genomes", f)
            quarantine_corrupt(f)
            continue
        results.update({g: r for g, r in shard.items() if r["n_kmers"] > 0})
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
    results = dict(_iter_sketches(jobs, processes))
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
    """Sketch every genome in Bdb; cache/restore via the work directory
    (the whole-run cache, and shards every INGEST_SHARD genomes while it
    runs, so a killed ingest resumes where it stopped)."""
    from drep_tpu_torch.utils.ckptmeta import open_checkpoint_dir

    logger = get_logger()
    args_snapshot = sketch_args_snapshot(bdb["genome"], k, sketch_size, scale, hash_name)

    if wd is not None and wd.has_arrays("sketches") and wd.arguments_match("sketch", args_snapshot):
        cached = _load(wd, k, sketch_size, scale)
        if not (cached.gdb["n_kmers"] == 0).any():
            logger.info("loading cached sketches from workdir")
            from drep_tpu_torch.parallel.mesh import process_count, process_index

            if process_count() > 1:
                logger.info("ingest: pod member %d of %d loaded %d genomes from the cache, digest %s",
                            process_index(), process_count(), len(cached.names), sketch_digest(cached))
            return cached
        logger.warning("ingest: cached sketches contain zero-kmer genomes — recomputing")

    jobs = [(row.genome, row.location, k, sketch_size, scale, hash_name) for row in bdb.itertuples()]
    results: dict[str, dict] = {}
    shard_dir = None
    if wd is not None:
        shard_dir = wd.get_dir(_SKETCH_SHARD_SUBDIR)
        if open_checkpoint_dir(shard_dir, _sketch_shard_meta(args_snapshot), clear_suffixes=(".npz",)):
            results = _resume_shards(shard_dir)
            if results:
                logger.info("ingest: resumed %d/%d sketched genomes from shards", len(results), len(jobs))

    resume_seen = set(glob.glob(os.path.join(shard_dir, "*.npz"))) if results else set()
    from drep_tpu_torch.parallel.mesh import process_count, process_index

    nproc, pid = (process_count(), process_index()) if shard_dir is not None else (1, 0)
    if nproc > 1:
        # ownership keys on the global job index, never on what this
        # member's resume saw: members that saw different shard sets would
        # otherwise leave some genome in nobody's stripe
        todo = [j for i, j in enumerate(jobs) if i % nproc == pid and j[0] not in results]
        if pid == 0:
            # a killed run's assembly and poison notes must not satisfy or
            # fail this run's waits (right after the synchronized open)
            for pat in ("assembled_*.done", "ingest_error_*.json"):
                for f in glob.glob(os.path.join(shard_dir, pat)):
                    with contextlib.suppress(OSError):
                        os.remove(f)
    else:
        todo = [j for j in jobs if j[0] not in results]
    my_shards: set[str] = set()
    pending: dict[str, dict] = {}

    def flush() -> None:
        if shard_dir is not None and pending:
            path = os.path.join(shard_dir, f"shard_{uuid.uuid4().hex}.npz")
            _save_sketch_shard(path, pending)
            my_shards.add(path)
            pending.clear()

    for name, res in _iter_sketches(todo, processes):
        results[name] = res
        # never checkpoint an unparseable result: resumed by name, it would
        # raise the input error again after the user fixed the file
        if res["n_kmers"] > 0:
            pending[name] = res
            if len(pending) >= INGEST_SHARD:
                flush()
    flush()
    if nproc > 1:
        cached = _assemble_pod_shards(wd, shard_dir, jobs, results, my_shards | resume_seen, pid,
                                      args_snapshot, k, sketch_size, scale)
        if cached is not None:
            return cached

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
    if nproc > 1:
        logger.info("ingest: pod member %d of %d assembled %d genomes, digest %s", pid, nproc, len(names),
                    sketch_digest(out))
    if wd is not None:
        if nproc > 1 and pid != 0:
            # member 0 writes the cache and reclaims the shards once every
            # peer has assembled (a peer still reading them would stall)
            with contextlib.suppress(OSError):
                atomic_write_bytes(os.path.join(shard_dir, f"assembled_{pid}.done"), b"")
            return out
        peers_done = True
        if nproc > 1:
            deadline = _barrier_deadline()
            marks = [os.path.join(shard_dir, f"assembled_{p}.done") for p in range(1, nproc)]
            peers_done = all(os.path.exists(f) for f in marks)
            while not peers_done and time.monotonic() < deadline:
                time.sleep(_INGEST_BARRIER_POLL_S)
                peers_done = all(os.path.exists(f) for f in marks)
        save_sketch_cache(wd, out, hash_name)
        # the whole-run cache supersedes the shards
        if peers_done:
            shutil.rmtree(shard_dir, ignore_errors=True)
    return out


def sketch_digest(gs: GenomeSketches) -> str:
    """SHA-1 over the names and both sketches of every genome, in order:
    the members of a pod log it, and must agree."""
    import hashlib

    h = hashlib.sha1()
    for name, bottom, scaled in zip(gs.names, gs.bottom, gs.scaled):
        h.update(name.encode() + b"\0")
        h.update(np.ascontiguousarray(bottom).tobytes() + b"\1")
        h.update(np.ascontiguousarray(scaled).tobytes() + b"\2")
    return h.hexdigest()


_INGEST_BARRIER_ENV = "DREP_TORCH_INGEST_BARRIER_S"
_INGEST_BARRIER_POLL_S = 0.2


def _barrier_deadline() -> float:
    """Monotonic deadline of the sharded ingest's waits (the assembly and
    member 0's wait for the assembled notes)."""
    from drep_tpu_torch.utils import envknobs

    return time.monotonic() + envknobs.env_float(_INGEST_BARRIER_ENV)


def _assemble_pod_shards(wd, shard_dir: str, jobs, results: dict, seen: set, pid: int, args_snapshot: dict,
                         k: int, sketch_size: int, scale: int) -> GenomeSketches | None:
    """A pod member's assembly of its peers' stripes into `results` (the
    JAX package's barrier): poll the shard store until every genome is
    covered. The timeout is progress-based (each new shard resets it). A
    poison note from a peer raises its error; a whole-run cache a peer
    already wrote is returned instead (None: `results` is complete).
    Unparseable genomes of this member's own stripe publish the poison
    note and raise."""
    bad = sorted(g for g, r in results.items() if r["n_kmers"] == 0)
    if bad:
        from drep_tpu_torch.utils.durableio import atomic_write_json

        with contextlib.suppress(OSError):
            atomic_write_json(os.path.join(shard_dir, f"ingest_error_{pid}.json"),
                              {"pid": pid, "genomes": bad[:10], "n": len(bad)})
        _refuse_unparsed(bad, results, k)
    logger = get_logger()
    deadline = _barrier_deadline()
    seen = set(seen)
    need = {j[0] for j in jobs}
    while need - set(results):
        progressed = False
        for f in sorted(glob.glob(os.path.join(shard_dir, "*.npz"))):
            if f in seen:
                continue
            try:
                shard = _load_sketch_shard(f)
            except Exception:  # noqa: BLE001 — a peer's write in flight: next pass
                continue
            seen.add(f)
            progressed = True
            results.update({g: r for g, r in shard.items() if r["n_kmers"] > 0})
        if progressed:
            deadline = _barrier_deadline()
        if not (need - set(results)):
            break
        for f in glob.glob(os.path.join(shard_dir, "ingest_error_*.json")):
            from drep_tpu_torch.utils.durableio import read_json_checked

            try:
                info = read_json_checked(f, what="ingest poison marker")
            except Exception:  # noqa: BLE001 — a torn note: the data barrier decides
                continue
            raise UserInputError(
                f"ingest peer process {info.get('pid')} reported {info.get('n')} unparseable input "
                f"file(s) (not FASTA, empty, or shorter than k): {', '.join(info.get('genomes', []))}"
            )
        if wd.has_arrays("sketches") and wd.arguments_match("sketch", args_snapshot):
            cached = _load(wd, k, sketch_size, scale)
            if not (cached.gdb["n_kmers"] == 0).any():
                logger.info("ingest: a peer assembled the whole-run cache first — using it")
                if pid != 0:
                    with contextlib.suppress(OSError):
                        atomic_write_bytes(os.path.join(shard_dir, f"assembled_{pid}.done"), b"")
                return cached
        if time.monotonic() > deadline:
            from drep_tpu_torch.utils import envknobs

            left = sorted(need - set(results))
            raise RuntimeError(
                f"sharded ingest barrier timed out: {len(left)} genomes never appeared in {shard_dir} for "
                f"{envknobs.env_float(_INGEST_BARRIER_ENV):.0f}s with no new shards (first missing: "
                f"{left[:10]}). A peer process likely died; raise the window via "
                f"DREP_TORCH_INGEST_BARRIER_S if its gaps between shards are legitimately longer."
            )
        time.sleep(_INGEST_BARRIER_POLL_S)
    return None


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
