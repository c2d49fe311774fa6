"""Device-resident serve pack: the classify rectangle without the
per-batch union repack.

Counterpart of drep_tpu/index/resident_device.py. The union path of
:func:`~drep_tpu_torch.index.classify.classify_batch` re-packs the whole
union (N resident + K query sketches) on every batch and ships the N-row
id matrix to the card again; for an index that has not changed since the
last generation swap that is O(N) host work and transfer a batch. This
module uploads the resident sketch matrix once per generation and maps
each query batch into the resident id space on the host (K rows, not
N + K):

- resident hash at vocab rank ``r`` -> anchor id ``(r+1)*S`` with
  ``S = (2^31-2)//(R+1)``: anchors rise with rank and leave S-1 spare ids
  below each one, and all ids stay below PAD_ID;
- a query hash equal to rank ``r``'s maps to the same anchor;
- a query hash that matches nothing, with insertion position ``p``, maps
  into the gap: ``p*S + 1 + off`` (``off`` = its place among the row's
  misses in that gap). Gap ids never collide with anchors and keep every
  strict order a dense repack would give, so every row stays strictly
  ascending (what ``csrc/mash_shared.cu``'s merge-path lanes assume).

The Mash count depends only on the order and equality of ids, and the
keep test and distances read the table the union walk reads
(``parallel/streaming.py``, the packed width), so the edges equal the
union path's bit for bit. A row with more than ``S-2`` misses in one gap
cannot be represented; that batch takes the union path, counted in
:func:`fallback_count`, with the same verdicts. So do an empty index and
one whose vocabulary leaves ``S < 2``. Nothing else falls back: a kernel
error raises.

Only the separate-mode (``joint=False``) classify uses this module, the
daemon's mode: the query-query edges, which the anchored id space does
not preserve across query rows, are exactly the edges it never reads.
``DREP_TORCH_SERVE_DEVICE_RESIDENT=0`` pins every batch to the union
path, as the JAX package's knob does; each such batch is counted in
:func:`fallback_count`, so a check that wants the device path sees it.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from drep_tpu_torch.ops.mash import TILE, distance_table, rect_survivors
from drep_tpu_torch.ops.minhash import PAD_ID, pad_packed_rows
from drep_tpu_torch.utils import envknobs
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters

RESIDENT_ENV = "DREP_TORCH_SERVE_DEVICE_RESIDENT"

# module counters: tests and chip_smoke.py hold the daemon to one upload
# per generation
_uploads = 0
_fallbacks = 0
_lock = threading.Lock()
_UNSUPPORTED = "unsupported"  # attribute sentinel: don't retry every batch

# the ids below PAD_ID that anchors and gaps share out (tests narrow it
# to force a gap overflow)
ID_SPAN = 2**31 - 2

# the last upload's and the last rectangle's seconds (chip_smoke.py)
STATS: dict = {}


class DeviceResidentPack:
    """One generation's resident compare state on one device."""

    __slots__ = (
        "generation", "device", "vocab", "stride", "s", "n",
        "ids", "counts", "cts_host", "keep_table", "dist_table",
    )


def upload_count() -> int:
    return _uploads


def fallback_count() -> int:
    return _fallbacks


def reset_for_tests() -> None:
    global _uploads, _fallbacks
    _uploads = 0
    _fallbacks = 0


def _count_fallback(why: str) -> None:
    global _fallbacks
    _fallbacks += 1
    counters.set_gauge("serve_resident_fallbacks", float(_fallbacks))
    get_logger().info("serve device-resident path unavailable: %s", why)


def _build_pack(resident, device: torch.device) -> DeviceResidentPack | None:
    from drep_tpu_torch.index.update import _retention

    global _uploads
    t0 = time.perf_counter()
    p = resident.params
    s = int(p["sketch_size"])
    trimmed = [np.asarray(b)[:s] for b in resident.bottom]
    n = len(trimmed)
    if n == 0:
        return None
    flat = np.concatenate(trimmed)
    # one sort gives the vocabulary and each hash's rank (a searchsorted of
    # ~10 M hashes into it misses the cache: 3-4x the time)
    vocab, rank = np.unique(flat, return_inverse=True)
    stride = ID_SPAN // (int(vocab.size) + 1)
    if stride < 2:
        return None  # id space too dense to anchor queries between ranks
    lens = np.array([len(t) for t in trimmed], dtype=np.int64)
    ids = np.full((n, s), PAD_ID, dtype=np.int32)
    rows = np.repeat(np.arange(n), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(len(flat)) - np.repeat(offs, lens)
    ids[rows, cols] = ((rank.reshape(-1).astype(np.int64) + 1) * stride).astype(np.int32)
    ids_p, cts_p = pad_packed_rows(ids, lens.astype(np.int32), TILE)
    # the union walk's table and keep test: its packed width is sketch_size
    dist_tbl = distance_table(s, int(p["kmer_size"]))

    pack = DeviceResidentPack()
    pack.generation = int(resident.generation)
    pack.device = device
    pack.vocab = vocab
    pack.stride = stride
    pack.s = s
    pack.n = n
    pack.cts_host = cts_p
    pack.dist_table = dist_tbl
    pack.ids = torch.from_numpy(ids_p).to(device)
    pack.counts = torch.from_numpy(cts_p).to(device)
    pack.keep_table = torch.from_numpy(dist_tbl <= _retention(p)[1]).to(device)
    if device.type == "cuda":
        # the poller thread builds the next generation's pack while the
        # batch thread launches on this one: it is whole on the card
        # before the swap hands it over
        torch.cuda.synchronize(device)
    _uploads += 1
    STATS["upload_s"] = time.perf_counter() - t0
    counters.set_gauge("serve_resident_uploads", float(_uploads))
    get_logger().info(
        "serve: resident sketch matrix on %s (gen %d, %d genomes, %d-wide, vocab %d, "
        "upload #%d, %.2f s)", device, pack.generation, n, s, int(vocab.size), _uploads,
        STATS["upload_s"],
    )
    return pack


def pack_for(resident, device: torch.device) -> DeviceResidentPack | None:
    """The cached pack of this resident object on `device`, built (and
    uploaded) once per generation. A hot swap installs a fresh resident
    object, so the cache expires with the old generation."""
    cached = getattr(resident, "_serve_device_pack", None)
    if cached is _UNSUPPORTED:
        return None
    if cached is not None and cached.generation == int(resident.generation) and cached.device == device:
        return cached
    with _lock:
        cached = getattr(resident, "_serve_device_pack", None)  # re-check
        if cached is _UNSUPPORTED:
            return None
        if cached is not None and cached.generation == int(resident.generation) and cached.device == device:
            return cached
        pack = _build_pack(resident, device)
        resident._serve_device_pack = pack if pack is not None else _UNSUPPORTED
        return pack


def prewarm_resident(resident, device: torch.device) -> bool:
    """Build and upload the pack ahead of the first batch (daemon start
    and generation hot swap). Returns True when the path is armed; False
    for a streaming federated resident, which manages its own partitions,
    and where ``DREP_TORCH_SERVE_DEVICE_RESIDENT`` is off."""
    from drep_tpu_torch.index.federation import FederatedResident

    if not envknobs.env_bool(RESIDENT_ENV):
        return False
    if isinstance(resident, FederatedResident):
        return False
    return pack_for(resident, device) is not None


def _map_queries(pack: DeviceResidentPack, bots: list[np.ndarray]):
    """Anchor a query batch into the resident id space. Returns
    (q_ids [K, s] int32, q_cts [K] int32), or (None, None) when a row
    overflows a gap's S-2 spare ids (the caller falls back, counted)."""
    s, stride, vocab = pack.s, pack.stride, pack.vocab
    q_ids = np.full((len(bots), s), PAD_ID, dtype=np.int32)
    q_cts = np.zeros(len(bots), dtype=np.int32)
    for r, b in enumerate(bots):
        q = np.asarray(b)[:s]
        m = len(q)
        q_cts[r] = m
        if m == 0:
            continue
        pos = np.searchsorted(vocab, q)
        inb = pos < vocab.size
        match = np.zeros(m, dtype=bool)
        match[inb] = vocab[pos[inb]] == q[inb]
        out = (pos.astype(np.int64) + 1) * stride
        nm = ~match
        if nm.any():
            pn = pos[nm]
            first = np.ones(len(pn), dtype=bool)
            first[1:] = pn[1:] != pn[:-1]
            starts = np.flatnonzero(first)
            run = np.cumsum(first) - 1
            off = np.arange(len(pn)) - starts[run]
            if int(off.max()) > stride - 2:
                return None, None
            out[nm] = pn.astype(np.int64) * stride + 1 + off
        q_ids[r, :m] = out.astype(np.int32)
    return q_ids, q_cts


def rect_edges_device(resident, queries, n_old: int, device: torch.device):
    """Retained (ii, jj, dd) edges of the query batch against the resident
    matrix — the edges the union path's ``_rect_edges`` emits with
    ``ii < n_old`` — from one ``mash_shared`` launch, without re-packing
    or re-uploading the N resident rows. Returns None when the batch must
    take the union path (counted in :func:`fallback_count`, also where
    ``DREP_TORCH_SERVE_DEVICE_RESIDENT`` is off)."""
    if not envknobs.env_bool(RESIDENT_ENV):
        _count_fallback(f"{RESIDENT_ENV} is off")
        return None
    pack = pack_for(resident, device)
    if pack is None:
        _count_fallback("resident pack unsupported (empty index or id space too dense)")
        return None
    bots = [np.asarray(queries.results[g]["bottom"]) for g in queries.admitted["genome"]]
    q_ids, q_cts = _map_queries(pack, bots)
    if q_ids is None:
        _count_fallback("query gap occupancy past the anchor stride")
        return None
    t0 = time.perf_counter()
    q_ids, q_cts_p = pad_packed_rows(q_ids, q_cts, TILE)
    with counters.stage("serve_rect_compare", pairs=pack.n * len(bots)):
        surv = rect_survivors(
            pack.ids, pack.counts, torch.from_numpy(q_ids).to(device),
            torch.from_numpy(q_cts_p).to(device), pack.s, pack.keep_table,
        )
    ii = surv[:, 0]
    s_use = np.minimum(np.minimum(pack.cts_host[ii], q_cts[surv[:, 1]]), pack.s)
    dd = pack.dist_table[s_use, surv[:, 2]].astype(np.float32)
    STATS["rect_s"] = time.perf_counter() - t0
    return ii, surv[:, 1] + n_old, dd
