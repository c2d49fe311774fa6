"""Planted GenomeSketches with cluster structure, made from a seed.

Modelled on the JAX package's bench planter (bench.py::_plant_sketches):
genomes come in planted clusters of geometric size (p = 0.35, at most 20);
each member keeps ~90% of its cluster's bottom-sketch hashes (Mash
distance well inside 1-P_ani) and ~97% of its scaled-sketch hashes
(ANI ~0.9985 > S_ani), plus a few private hashes. Planted clusters share
no hashes with each other. The widths are parameters: `s_bottom` is the
bottom-k width (MASH_sketch), `s_scaled` the scaled-sketch depth (20 000
is a 4 Mb genome at scale 200).

`core` plants diverse clusters instead, after the JAX bench's
adversarial-vocabulary pack (bench.py::_production_pack): members keep
their cluster's bottom sketch as above, so the cluster is one primary
cluster, but each scaled sketch is ~95% of a small `core`-hash cluster
pool plus s_scaled - core private hashes. Such a cluster's vocabulary
grows with its size (a genus-level primary cluster whose members share
little), which sends it past the one-shot indicator budget.
:func:`join_planted` concatenates differently planted sets into one.
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
    core: int | None = None,
) -> tuple[GenomeSketches, np.ndarray]:
    """(sketches, planted cluster id per genome) for `n` genomes.
    `cluster_size` fixes every planted cluster's size (the last one takes
    the remainder) in place of the geometric draw; `core` plants diverse
    clusters (module docstring)."""
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
        if core is None:
            c_scaled = np.unique(rng.integers(0, 2**63, size=int(s_scaled * 1.3), dtype=np.uint64))
            keep_frac, n_own = 0.97, max(1, s_scaled // 25)
        else:
            c_scaled = np.unique(rng.integers(0, 2**63, size=int(core * 1.05), dtype=np.uint64))
            keep_frac, n_own = 0.95, s_scaled - core
        for _ in range(size):
            keep_b = rng.random(len(c_bottom)) < 0.90
            own_b = rng.integers(0, 2**63, size=max(1, s_bottom // 6), dtype=np.uint64)
            bottoms.append(np.unique(np.concatenate([c_bottom[keep_b], own_b]))[:s_bottom])
            keep_s = rng.random(len(c_scaled)) < keep_frac
            own_s = rng.integers(0, 2**63, size=n_own, dtype=np.uint64)
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


def join_planted(parts: list[tuple[GenomeSketches, np.ndarray]]) -> tuple[GenomeSketches, np.ndarray]:
    """One planted set from several (same k, bottom width and scale):
    genomes renamed synth_0.. in order, planted cluster ids made disjoint."""
    gss = [gs for gs, _ in parts]
    n = sum(len(gs.names) for gs in gss)
    names = [f"synth_{i}.fasta" for i in range(n)]
    gdb = pd.concat([gs.gdb for gs in gss], ignore_index=True)
    gdb["genome"] = names
    planted, offset = [], 0
    for _, p in parts:
        planted.append(p + offset)
        offset += int(p.max()) + 1 if len(p) else 0
    first = gss[0]
    gs = GenomeSketches(
        names=names, gdb=gdb,
        bottom=[b for g in gss for b in g.bottom], scaled=[s for g in gss for s in g.scaled],
        k=first.k, sketch_size=first.sketch_size, scale=first.scale,
    )
    return gs, np.concatenate(planted)
