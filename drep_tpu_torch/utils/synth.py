"""Planted GenomeSketches with cluster structure, made from a seed.

Modelled on the JAX package's bench planter (bench.py::_plant_sketches):
genomes come in planted clusters of geometric size (p = 0.35, at most 20);
each member keeps ~90% of its cluster's bottom-sketch hashes (Mash
distance well inside 1-P_ani) and ~97% of its scaled-sketch hashes
(ANI ~0.9985 > S_ani), plus a few private hashes. Planted clusters share
no hashes with each other. The widths are parameters: `s_bottom` is the
bottom-k width (MASH_sketch), `s_scaled` the scaled-sketch depth (20 000
is a 4 Mb genome at scale 200).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from drep_tpu_torch.ingest import DEFAULT_SCALE, GenomeSketches
from drep_tpu_torch.ops.kmers import DEFAULT_K


def planted_sketches(
    n: int,
    seed: int,
    s_bottom: int = 1000,
    s_scaled: int = 1200,
    k: int = DEFAULT_K,
    scale: int = DEFAULT_SCALE,
    cluster_size: int | None = None,
) -> tuple[GenomeSketches, np.ndarray]:
    """(sketches, planted cluster id per genome) for `n` genomes.
    `cluster_size` fixes every planted cluster's size (the last one takes
    the remainder) in place of the geometric draw."""
    rng = np.random.default_rng(seed)
    names: list[str] = []
    bottoms: list[np.ndarray] = []
    scaleds: list[np.ndarray] = []
    planted: list[int] = []
    gi = 0
    cluster = 0
    while gi < n:
        size = min(cluster_size or min(int(rng.geometric(0.35)), 20), n - gi)
        c_bottom = np.unique(rng.integers(0, 2**63, size=int(s_bottom * 1.6), dtype=np.uint64))
        c_scaled = np.unique(rng.integers(0, 2**63, size=int(s_scaled * 1.3), dtype=np.uint64))
        for _ in range(size):
            keep_b = rng.random(len(c_bottom)) < 0.90
            own_b = rng.integers(0, 2**63, size=max(1, s_bottom // 6), dtype=np.uint64)
            bottoms.append(np.unique(np.concatenate([c_bottom[keep_b], own_b]))[:s_bottom])
            keep_s = rng.random(len(c_scaled)) < 0.97
            own_s = rng.integers(0, 2**63, size=max(1, s_scaled // 25), dtype=np.uint64)
            scaleds.append(np.unique(np.concatenate([c_scaled[keep_s], own_s])))
            names.append(f"synth_{gi}.fasta")
            planted.append(cluster)
            gi += 1
        cluster += 1
    gdb = pd.DataFrame(
        {
            "genome": names,
            "length": np.full(n, 4_000_000, np.int64),
            "N50": np.full(n, 50_000, np.int64),
            "contigs": np.full(n, 100, np.int64),
            "n_kmers": np.full(n, 3_900_000, np.int64),
        }
    )
    gs = GenomeSketches(
        names=names, gdb=gdb, bottom=bottoms, scaled=scaleds,
        k=k, sketch_size=s_bottom, scale=scale,
    )
    return gs, np.array(planted, dtype=np.int64)
