"""The per-genome sketch job — deliberately a LEAN module.

Ingest pool workers (ingest.py::sketch_genomes) import the module that
defines their job function; keeping this one's import chain to numpy +
the native bindings + the k-mer kernels (~0.7 s cold vs ~2.7 s for
drep_tpu_torch.ingest with its pandas dependency) is what makes a process pool
pay off at small batch counts — worker startup was measured to exceed the
sketching itself at <100 genomes otherwise.
"""

from __future__ import annotations

import numpy as np

from drep_tpu_torch.ops import kmers
from drep_tpu_torch.utils.fasta import n50, read_fasta_contigs


def sketch_one(args) -> tuple[str, dict]:
    """(name, path, k, sketch_size, scale, hash_name) -> (name, result
    dict with length/N50/contigs/n_kmers/bottom/scaled)."""
    name, path, k, sketch_size, scale, hash_name = args

    from drep_tpu_torch.native import sketch_fasta_native

    native = sketch_fasta_native(path, k, sketch_size, scale, hash_name)
    if native is not None:
        return name, native

    contigs = read_fasta_contigs(path)
    lengths = np.array([len(c) for c in contigs], dtype=np.int64)
    raw = np.concatenate(
        [kmers.hash_kmers(kmers.packed_kmers(c, k), k, hash_name) for c in contigs]
        or [np.empty(0, np.uint64)]
    )
    bottom, scaled, n_kmers = kmers.sketches_from_raw(raw, sketch_size, scale)
    return name, {
        "length": int(lengths.sum()) if len(lengths) else 0,
        "N50": n50(lengths),
        "contigs": len(contigs),
        "n_kmers": n_kmers,
        "bottom": bottom,
        "scaled": scaled,
    }
