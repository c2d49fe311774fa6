"""Packed MinHash sketches: the host-side id space every kernel reads.

Counterpart of drep_tpu/ops/minhash.py (plus ``next_pow2`` from
drep_tpu/ops/merge.py). uint64 hash sketches map to a dense **int32 id
space** through one global ``np.unique`` vocabulary: only equality and
order of hashes matter, so the monotone uint64 -> int32 rank map is exact.
Rows are ascending and padded with PAD_ID, which sorts after every real id.

Distance: ``d = -ln(2j / (1+j)) / k`` (the Mash distance), clipped to [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PAD_ID = np.int32(2**31 - 1)  # sorts after every real id; never counted
U16_PAD = np.uint16(0xFFFF)  # pad sentinel of link-compressed uint16 id packs


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def pad_sentinel(dtype):
    """THE pad value for an id matrix of `dtype` (int32/PAD_ID is the
    kernel contract; uint16/U16_PAD is the link-compressed layout that
    :func:`widen_ids` turns into it on the device)."""
    return U16_PAD if np.dtype(dtype) == np.uint16 else PAD_ID


def ids_to_device(ids: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host id rows (int32, or a uint16 pack at half the bytes) -> device."""
    if ids.dtype not in (np.int32, np.uint16):
        raise TypeError(f"id rows must be int32 or uint16, got {ids.dtype}")
    return torch.from_numpy(np.ascontiguousarray(ids)).to(device)


def widen_ids(x: torch.Tensor) -> torch.Tensor:
    """uint16 id rows -> the int32/PAD_ID contract, on the tensor's device:
    0xFFFF becomes PAD_ID. int32 passes through."""
    if x.dtype == torch.uint16:
        w = x.to(torch.int32)
        return torch.where(w == int(U16_PAD), torch.full_like(w, int(PAD_ID)), w)
    if x.dtype != torch.int32:
        raise TypeError(f"id rows must be int32 or uint16, got {x.dtype}")
    return x


def require_int32_ids(ids: np.ndarray, where: str) -> None:
    """Raise unless a host id matrix is int32 with PAD_ID padding (the
    callers that take a uint16 pack say so and widen it themselves)."""
    if ids.dtype != np.int32:
        raise TypeError(f"{where}: id rows must be int32 with PAD_ID padding, got {ids.dtype}")


def dense_ranks(flat: np.ndarray) -> tuple[int, np.ndarray]:
    """(vocabulary size, int32 rank of each uint64 hash among the distinct
    hashes) — the monotone rank map, from one sort with its inverse. A
    searchsorted of every hash into the sorted vocabulary gives the same
    ranks, but into a vocabulary of tens of millions of hashes (a cluster
    past the one-shot budget) its random probes miss the cache."""
    vocab, inverse = np.unique(flat, return_inverse=True)
    if vocab.size >= np.iinfo(np.int32).max:
        raise ValueError("id space overflow: >2^31 distinct sketch hashes")
    return int(vocab.size), inverse.reshape(-1).astype(np.int32)


@dataclass
class PackedSketches:
    """Fixed-shape device-ready sketch pack.

    ids:    [N, s] int32 (or uint16), each row ascending, padded with the sentinel
    counts: [N]    int32, number of valid entries per row
    names:  list of N genome names (host-side bookkeeping)
    """

    ids: np.ndarray
    counts: np.ndarray
    names: list[str]

    @property
    def n(self) -> int:
        return self.ids.shape[0]

    @property
    def sketch_size(self) -> int:
        return self.ids.shape[1]


def pack_sketches(sketches: list[np.ndarray], names: list[str], sketch_size: int) -> PackedSketches:
    """uint64 bottom-k sketches (sorted unique) -> padded int32 id matrix."""
    if len(sketches) != len(names):
        raise ValueError("sketches and names length mismatch")
    trimmed = [s[:sketch_size] for s in sketches]
    n = len(trimmed)
    ids = np.full((n, sketch_size), PAD_ID, dtype=np.int32)
    lens = np.array([len(s) for s in trimmed], dtype=np.int64)
    if n:
        # the monotone rank map from one sort (dense_ranks); each row's
        # valid prefix takes its ranks in row-major order
        _, ranks = dense_ranks(np.concatenate(trimmed))
        ids[np.arange(sketch_size)[None, :] < lens[:, None]] = ranks
    return PackedSketches(ids=ids, counts=lens.astype(np.int32), names=list(names))


def pad_packed_rows(ids: np.ndarray, counts: np.ndarray, multiple: int):
    """Pad a packed sketch matrix to a row multiple: sentinel rows, zero counts."""
    n = ids.shape[0]
    nt = -(-n // multiple) * multiple
    if nt == n:
        return ids, counts
    pad_ids = np.full((nt, ids.shape[1]), pad_sentinel(ids.dtype), dtype=ids.dtype)
    pad_ids[:n] = ids
    pad_counts = np.zeros(nt, dtype=counts.dtype)
    pad_counts[:n] = counts
    return pad_ids, pad_counts


def mash_distance_from_jaccard(j: np.ndarray, k: int) -> np.ndarray:
    """d = -ln(2j / (1+j)) / k, clipped to [0, 1]; j == 0 -> 1 (numpy)."""
    jj = np.maximum(j, 1e-30)  # keep log() off 0 even where the branch loses
    d = np.where(j > 0.0, -np.log(2.0 * jj / (1.0 + jj)) / k, 1.0)
    return np.clip(d, 0.0, 1.0)
