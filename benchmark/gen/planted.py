"""Planted bottom sketches with graded relatedness, made on the device from a seed.

A vectorised, graded form of the port's planter (drep_tpu_torch/utils/
synth.py::planted_sketches), for the bottom sketches only. Genomes come in
species, and species in genera:

- each genus draws ``genus_hashes`` random hashes; each species of it keeps
  a share ``genus_keep`` of them (one share per species, log-uniform on
  [low, high]), each of its genomes each of those hashes with that
  probability;
- each species draws ``species_hashes`` random hashes; each of its genomes
  keeps each with its own probability ``species_keep`` (uniform on
  [low, high], one a genome);
- each genome adds ``own_hashes`` private ones, and its bottom sketch is the
  ``sketch`` smallest of the whole set.

So two genomes of one species share most of their sketch, two species of one
genus share more or less of it by their two ``genus_keep`` shares (the Mash
distances spread over the primary cutoff and the retention bound), and two
genera share nothing (63-bit random values).

The structure (the species sizes, the genera, every share) is drawn once
from the configuration's ``size_seed``, so every run seed gives the same
work; the run seed draws the hashes, the genomes' keeps and the order in
which the genomes come, so a cluster's members are scattered through the
genome list as they are in a real one. The same seed on the same kind of
device gives the same bytes (a CUDA generator and a CPU generator give
different streams).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# rows planted per chunk: a fixed number, so the random streams do not
# depend on the device's memory
CHUNK_ROWS = 8192
# hashes are drawn in [0, 2**63 - 1); the dropped slots sort last
HASH_HIGH = 2**63 - 1
DROPPED = 2**63 - 1


@dataclass
class Planted:
    """hashes: [n, sketch] uint64, each row ascending, the first counts[i]
    valid (the rest DROPPED); counts: [n] int32; species, genus: [n] int64,
    the planted species and genus of each genome in output order."""

    hashes: np.ndarray
    counts: np.ndarray
    species: np.ndarray
    genus: np.ndarray

    @property
    def n(self) -> int:
        return self.hashes.shape[0]

    def bottoms(self) -> list[np.ndarray]:
        """The per-genome uint64 bottom sketches (views), as a sketch cache holds them."""
        return [self.hashes[i, : self.counts[i]] for i in range(self.n)]


@dataclass
class Structure:
    """The fixed part of a planting, in planted order (before the run
    seed's shuffle): per genome its species; per species its genus and
    genus share; per genome its species share."""

    species_of: np.ndarray  # [n] int64
    genus_of_species: np.ndarray  # [n_species] int64
    genus_keep: np.ndarray  # [n_species] float64
    species_keep: np.ndarray  # [n] float64

    @property
    def n_species(self) -> int:
        return self.genus_of_species.shape[0]

    @property
    def n_genera(self) -> int:
        return int(self.genus_of_species.max()) + 1 if self.n_species else 0


def draw_sizes(rng: np.random.Generator, law: dict, total: int) -> np.ndarray:
    """Sizes drawn from `law` until they cover `total`, the last one cut to
    fit.

    ``{"law": "one"}``: every size 1.
    ``{"law": "geometric", "p": .., "max": ..}``: min(Geometric(p), max).
    ``{"law": "power", "alpha": .., "max": ..}``: P(s) proportional to
    s**-alpha on 1..max."""
    kind = law["law"]
    if kind == "one":
        return np.ones(total, dtype=np.int64)
    cap = int(law["max"])
    if kind == "geometric":
        def draw(m):
            return np.minimum(rng.geometric(float(law["p"]), size=m), cap)
    elif kind == "power":
        s = np.arange(1, cap + 1, dtype=np.float64)
        cdf = np.cumsum(s ** -float(law["alpha"]))
        cdf /= cdf[-1]

        def draw(m):
            return np.searchsorted(cdf, rng.random(m), side="right") + 1
    else:
        raise ValueError(f"unknown size law {kind!r}")
    sizes: list[np.ndarray] = []
    covered = 0
    while covered < total:
        got = draw(max(1024, total // 4)).astype(np.int64)
        sizes.append(got)
        covered += int(got.sum())
    out = np.concatenate(sizes)
    cut = int(np.searchsorted(np.cumsum(out), total))
    out = out[: cut + 1].copy()
    out[-1] -= int(out.sum()) - total
    return out


def structure(planting: dict, n: int) -> Structure:
    """The planting's fixed structure for `n` genomes, drawn from its
    ``size_seed``: species sizes, then genera over the species, then the
    shares."""
    rng = np.random.default_rng(int(planting["size_seed"]))
    species_sizes = draw_sizes(rng, planting["species_sizes"], n)
    genus_sizes = draw_sizes(rng, planting["genus_sizes"], species_sizes.shape[0])
    n_species = species_sizes.shape[0]
    lo, hi = (float(x) for x in planting["genus_keep"])
    genus_keep = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n_species))
    lo, hi = (float(x) for x in planting["species_keep"])
    species_keep = rng.uniform(lo, hi, size=n)
    return Structure(
        species_of=np.repeat(np.arange(n_species, dtype=np.int64), species_sizes),
        genus_of_species=np.repeat(np.arange(genus_sizes.shape[0], dtype=np.int64), genus_sizes),
        genus_keep=genus_keep,
        species_keep=species_keep,
    )


def _pool(gen: torch.Generator, table: torch.Tensor, owner: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each row's draw from its owner's pool: a hash kept with the row's
    probability, else DROPPED."""
    if table.shape[1] == 0:
        return table.new_empty((owner.shape[0], 0))
    mask = torch.rand((owner.shape[0], table.shape[1]), generator=gen, device=table.device) < keep[:, None]
    return torch.where(mask, table[owner], DROPPED)


def plant(n: int, st: Structure, seed: int, sketch: int, genus_hashes: int, species_hashes: int,
          own_hashes: int, device: torch.device) -> Planted:
    """`n` planted bottom sketches of width `sketch` (module docstring)."""
    if st.species_of.shape[0] != n:
        raise ValueError(f"the structure covers {st.species_of.shape[0]} genomes, not {n}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**64 - 1))

    def table(rows: int, width: int):
        return torch.randint(0, HASH_HIGH, (rows, width), generator=gen, dtype=torch.int64, device=device)

    genus_table = table(st.n_genera, genus_hashes)
    species_table = table(st.n_species, species_hashes)
    order = torch.randperm(n, generator=gen, device=device)
    species = torch.as_tensor(st.species_of, device=device)[order]
    genus_of = torch.as_tensor(st.genus_of_species, device=device)
    r_species = torch.as_tensor(st.genus_keep, dtype=torch.float32, device=device)
    q = torch.as_tensor(st.species_keep, dtype=torch.float32, device=device)[order]
    hashes = np.empty((n, sketch), dtype=np.uint64)
    counts = np.empty(n, dtype=np.int32)
    for lo in range(0, n, CHUNK_ROWS):
        sp = species[lo : lo + CHUNK_ROWS]
        rows = sp.shape[0]
        parts = [
            _pool(gen, genus_table, genus_of[sp], r_species[sp]),
            _pool(gen, species_table, sp, q[lo : lo + rows]),
            table(rows, own_hashes),
        ]
        full = torch.cat(parts, dim=1)
        bottom = torch.sort(full, dim=1).values
        valid = torch.clamp((bottom != DROPPED).sum(dim=1), max=sketch)
        hashes[lo : lo + rows] = bottom[:, :sketch].cpu().numpy().view(np.uint64)
        counts[lo : lo + rows] = valid.to(torch.int32).cpu().numpy()
    species = species.cpu().numpy().astype(np.int64)
    return Planted(hashes=hashes, counts=counts, species=species, genus=st.genus_of_species[species])


def plant_config(config: dict, n: int, seed: int, device: torch.device) -> Planted:
    """The configuration's planting (its ``planting`` group) for `n` genomes."""
    p = config["planting"]
    return plant(n, structure(p, n), seed, int(config["MASH_sketch"]), int(p["genus_hashes"]),
                 int(p["species_hashes"]), int(p["own_hashes"]), device)
