"""Canonical k-mer extraction and 64-bit hashing (host ingest).

This replaces the role of Mash's C++ sketching stage (reference:
drep/d_cluster/external.py::sketch_genome shells out to `mash sketch`;
SURVEY.md §2b — reference mount empty). Design per SURVEY.md §7 step 2:
FASTA -> canonical k-mer stream -> uint64 hashes, computed with vectorized
numpy (a C++ fast path can slot in behind the same function signatures).

Encoding: A=0 C=1 G=2 T=3, k<=31 packed into a uint64 (2 bits/base).
Canonical k-mer = min(forward, reverse-complement) of the packed value,
hashed with one of two 64-bit hashes (``--hash``):

- ``splitmix64`` (default): the splitmix64 finalizer applied to the packed
  value — fastest, validated against internal numpy oracles.
- ``murmur3``: MurmurHash3_x64_128 (h1, seed 42) over the ASCII k-mer
  bytes — Mash's exact hash for k > 16, so sketches are directly
  comparable to `mash info` output for validation.

Windows containing any non-ACGT byte are masked out, which also prevents
k-mers from spanning contigs when sequences are joined with 'N'.
"""

from __future__ import annotations

import numpy as np

DEFAULT_K = 21

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i  # lowercase


def encode_sequence(seq: bytes) -> np.ndarray:
    """Bytes -> 2-bit codes (uint8), 255 for non-ACGT."""
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (public-domain mixer) on uint64."""
    z = x.astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


_ASCII_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)
MASH_SEED = 42  # Mash's MurmurHash3 seed (mash/src/mash/Sketch.cpp upstream)


def kmer_ascii_bytes(canon: np.ndarray, k: int) -> np.ndarray:
    """2-bit-packed canonical k-mers [n] -> ASCII sequence bytes [n, k].

    The packed value stores the first base in the highest 2 bits, so
    unpacking high-to-low reproduces the k-mer string left-to-right —
    exactly the bytes Mash feeds MurmurHash3 (packed-min canonicalization
    equals lexicographic-min because A<C<G<T maps to 0<1<2<3)."""
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    codes = (canon[:, None] >> shifts[None, :]) & np.uint64(3)
    return _ASCII_BASE[codes.astype(np.uint8)]


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix64(z: np.ndarray) -> np.ndarray:
    z = z.copy()
    z ^= z >> np.uint64(33)
    z *= np.uint64(0xFF51AFD7ED558CCD)
    z ^= z >> np.uint64(33)
    z *= np.uint64(0xC4CEB9FE1A85EC53)
    z ^= z >> np.uint64(33)
    return z


def murmur3_x64_128_h1(data: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized MurmurHash3_x64_128 over equal-length byte rows; returns
    h1 (the first 8 little-endian bytes of the 128-bit digest — the value
    Mash stores as its 64-bit hash for k > 16).

    `data` is [n, L] uint8. Straight port of Austin Appleby's public-domain
    reference, batched over rows; every constant is np.uint64 because a
    stray Python int would silently promote the whole array to float64.
    """
    if data.ndim != 2:
        raise ValueError("data must be [n, L] bytes")
    n, length = data.shape
    c1 = np.uint64(0x87C37B91114253D5)
    c2 = np.uint64(0x4CF5AB172766A3B1)
    h1 = np.full(n, np.uint64(seed), np.uint64)
    h2 = h1.copy()
    pw = np.uint64(256) ** np.arange(8, dtype=np.uint64)  # little-endian

    nblocks = length // 16
    for b in range(nblocks):
        blk = data[:, 16 * b : 16 * b + 16].astype(np.uint64)
        k1 = blk[:, :8] @ pw
        k2 = blk[:, 8:] @ pw
        k1 *= c1
        k1 = _rotl64(k1, 31)
        k1 *= c2
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 += h2
        h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
        k2 *= c2
        k2 = _rotl64(k2, 33)
        k2 *= c1
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 += h1
        h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

    tail = data[:, 16 * nblocks :]
    t = tail.shape[1]
    if t > 8:
        k2 = tail[:, 8:].astype(np.uint64) @ pw[: t - 8]
        k2 *= c2
        k2 = _rotl64(k2, 33)
        k2 *= c1
        h2 ^= k2
    if t > 0:
        k1 = tail[:, : min(t, 8)].astype(np.uint64) @ pw[: min(t, 8)]
        k1 *= c1
        k1 = _rotl64(k1, 31)
        k1 *= c2
        h1 ^= k1

    h1 ^= np.uint64(length)
    h2 ^= np.uint64(length)
    h1 += h2
    h2 += h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 += h2
    # h2 += h1 would complete the 128-bit digest; only h1 is consumed
    return h1


HASH_NAMES = ("splitmix64", "murmur3")


def hash_kmers(canon: np.ndarray, k: int, hash_name: str = "splitmix64") -> np.ndarray:
    """Hash packed canonical k-mers with the selected 64-bit hash.

    'splitmix64' (default): fastest, hashes the packed value directly.
    'murmur3': MurmurHash3_x64_128 h1 over the ASCII k-mer bytes with
    Mash's seed — sketch values comparable against `mash info` dumps for
    k > 16 (Mash stores 32-bit hashes for k <= 16; that regime still gets
    64-bit values here, documented in PARITY.md).
    """
    if hash_name == "splitmix64":
        return splitmix64(canon)
    if hash_name == "murmur3":
        if canon.size == 0:
            return canon.astype(np.uint64)
        # chunked like packed_kmers: the ASCII + block temporaries are
        # O(n*k) uint64 — unchunked, a 4 Mb contig would peak >1 GB/worker
        out = np.empty(canon.shape, np.uint64)
        chunk = 1 << 18
        for c0 in range(0, canon.size, chunk):
            out[c0 : c0 + chunk] = murmur3_x64_128_h1(
                kmer_ascii_bytes(canon[c0 : c0 + chunk], k), seed=MASH_SEED
            )
        return out
    raise ValueError(f"unknown hash {hash_name!r}; expected one of {HASH_NAMES}")


def packed_kmers(seq: bytes, k: int = DEFAULT_K) -> np.ndarray:
    """All valid canonical k-mers of `seq`, packed into uint64 (unsorted,
    in sequence order, duplicates retained)."""
    if k > 31:
        raise ValueError("k must be <= 31 to pack into uint64 (2 bits/base)")
    codes = encode_sequence(seq)
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint64)

    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    # valid windows: no 255 anywhere. cumsum trick avoids an [n, k] reduction.
    invalid = (codes == 255).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(invalid)])
    valid = (cs[k:] - cs[:-k]) == 0

    pow_f = (np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64))
    pow_r = (np.uint64(4) ** np.arange(k, dtype=np.uint64))
    # chunk the [n, k] uint64 window matmul: bounds transient memory to
    # ~CHUNK*k*8 bytes instead of ~n*k*8 (~1 GB for a 5 Mb contig at k=21)
    CHUNK = 1 << 18
    canon = np.empty(n, dtype=np.uint64)
    for c0 in range(0, n, CHUNK):
        w = windows[c0 : c0 + CHUNK].astype(np.uint64)
        fwd = w @ pow_f
        rev = (np.uint64(3) - w) @ pow_r
        canon[c0 : c0 + CHUNK] = np.minimum(fwd, rev)
    return canon[valid]


def kmer_hashes(seq: bytes, k: int = DEFAULT_K, hash_name: str = "splitmix64") -> np.ndarray:
    """Sorted unique hashes of the canonical k-mer *set* of `seq`."""
    canon = packed_kmers(seq, k)
    if canon.size == 0:
        return canon
    return np.unique(hash_kmers(canon, k, hash_name))


def bottom_k_sketch(hashes: np.ndarray, sketch_size: int) -> np.ndarray:
    """Bottom-s MinHash sketch: the `sketch_size` smallest unique hashes,
    ascending. (`hashes` must already be sorted unique, as from
    :func:`kmer_hashes`.)"""
    return hashes[:sketch_size]


def max_scaled_hash(scale: int) -> int:
    """FracMinHash threshold: hashes <= this value are in the scaled sketch.
    THE single definition — the numpy paths and the native-ingest binding
    (drep_tpu_torch/native) must all use it so the sketches stay byte-equal."""
    if scale <= 0:
        raise ValueError("scale must be positive")
    return (1 << 64) // scale - 1 if scale > 1 else (1 << 64) - 1


def scaled_sketch(hashes: np.ndarray, scale: int) -> np.ndarray:
    """FracMinHash ("scaled") sketch: all unique hashes below 2^64/scale.

    Sketch size tracks genome size (|kmers|/scale in expectation), which
    makes containment — and hence ANI — estimable from sketches alone.
    """
    return hashes[hashes <= np.uint64(max_scaled_hash(scale))]


def sketches_from_raw(raw: np.ndarray, sketch_size: int, scale: int):
    """(bottom, scaled, n_kmers) from RAW canonical k-mer hashes (duplicates
    retained, unsorted) — the FracMinHash-first fast path.

    When the scaled (<= 2^64/scale) distinct set already holds >= sketch_size
    hashes, the bottom-s sketch is exactly its first s entries, so the full
    multi-million-hash sort/dedup is skipped entirely and `n_kmers` is the
    standard FracMinHash cardinality estimate |scaled| * scale (used only for
    representative-ordering heuristics). Small genomes fall back to the exact
    full dedup. The native C++ ingest (drep_tpu_torch/native/ingest.cc) implements
    the IDENTICAL rule — the two paths must stay byte-equal.
    """
    small_u = np.unique(raw[raw <= np.uint64(max_scaled_hash(scale))])
    if small_u.size >= sketch_size > 0:
        return small_u[:sketch_size], small_u, int(small_u.size) * scale
    full = np.unique(raw)
    return full[:sketch_size], small_u, int(full.size)
