"""The planted inputs: determinism, the fixed structure, the graded
relatedness, scattering."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.gen.planted import draw_sizes, plant, plant_config, structure
from benchmark.harness import load_cell
from benchmark.reference.primary import primary_reference

CPU = torch.device("cpu")
REPS = {"size_seed": 3, "species_sizes": {"law": "one"}, "genus_sizes": {"law": "geometric", "p": 0.35, "max": 20},
        "genus_keep": [0.04, 0.6], "species_keep": [1.0, 1.0]}
SPECIES = {"size_seed": 4644, "species_sizes": {"law": "power", "alpha": 1.5, "max": 3300},
           "genus_sizes": {"law": "geometric", "p": 0.5, "max": 8}, "genus_keep": [0.05, 0.9],
           "species_keep": [0.55, 0.95]}


def _plant(seed, n=400, planting=REPS):
    # sketch 64: genus pool 128, species pool 104 where there is one, 64 own
    return plant(n, structure(planting, n), seed, 64, 128, 0 if planting is REPS else 104, 64, CPU)


def test_same_seed_same_bytes_other_seed_other_bytes():
    a, b, c = _plant(2**33 + 1), _plant(2**33 + 1), _plant(2**33 + 2)
    assert a.hashes.tobytes() == b.hashes.tobytes()
    assert np.array_equal(a.counts, b.counts) and np.array_equal(a.species, b.species)
    assert a.hashes.tobytes() != c.hashes.tobytes()
    assert not np.array_equal(a.species, c.species)


@pytest.mark.parametrize("planting", [REPS, SPECIES], ids=["reps", "species"])
def test_structure_is_one_for_every_seed(planting):
    n = 2000
    st = structure(planting, n)
    sizes = np.bincount(st.species_of)
    assert sizes.sum() == n and sizes.min() >= 1
    assert np.array_equal(st.species_of, structure(planting, n).species_of)
    assert np.all(np.diff(st.genus_of_species) >= 0) and st.genus_of_species[0] == 0
    assert np.bincount(st.genus_of_species).max() <= planting["genus_sizes"]["max"]
    lo, hi = planting["genus_keep"]
    assert lo <= st.genus_keep.min() and st.genus_keep.max() <= hi
    for seed in (1, 99):
        p = _plant(seed, n, planting)
        assert np.array_equal(np.sort(np.bincount(p.species)), np.sort(sizes))
        assert np.array_equal(p.genus, st.genus_of_species[p.species])


def test_power_law_mean_matches_uhgg():
    sizes = draw_sizes(np.random.default_rng(4), {"law": "power", "alpha": 1.5, "max": 3300}, 2_000_000)
    assert 40.0 < sizes.mean() < 48.0  # 204 938 / 4 644 = 44.1
    assert np.all(draw_sizes(np.random.default_rng(1), {"law": "one"}, 7) == 1)


def test_rows_are_bottom_sketches_and_genera_share_nothing():
    p = _plant(7, planting=SPECIES)
    w = p.hashes.shape[1]
    for i in range(p.n):
        row = p.hashes[i, : p.counts[i]]
        assert p.counts[i] == w
        assert np.all(np.diff(row.astype(np.float64)) >= 0) and len(np.unique(row)) == len(row)
    owner = {}
    for i in range(p.n):
        for h in p.hashes[i, : p.counts[i]].tolist():
            assert owner.setdefault(h, p.genus[i]) == p.genus[i]
    # two genomes of the largest species share much of their sketch
    mates = np.flatnonzero(p.species == np.bincount(p.species).argmax())
    assert np.intersect1d(p.hashes[mates[0]], p.hashes[mates[1]]).size > w // 4


# the species level as a UHGG-like deployment would plant it (sketch 1000)
SPECIES_FULL = dict(SPECIES, genus_hashes=1200, species_hashes=1600, own_hashes=200)


@pytest.mark.parametrize("planting", ["gtdb207_reps", SPECIES_FULL], ids=["reps", "species"])
def test_distances_straddle_the_cutoff_and_the_retention_bound(planting):
    """Pairs of one genus spread over both sides of 1 - P_ani and of
    warn_dist, so the keep test and the linkage meet real decisions."""
    cfg = load_cell("gtdb207_reps.primary").config
    if planting != "gtdb207_reps":
        cfg = dict(cfg, planting=planting)
    n = 1500
    p = plant_config(dict(cfg, genomes=n), n, 3, CPU)
    ref = primary_reference(p.hashes, p.counts, cfg["MASH_sketch"], cfg["mash_k"], 0.1, 0.25, CPU)
    ii, jj = ref.keys // n, ref.keys % n
    cross = p.species[ii] != p.species[jj]
    d = ref.dist
    assert (d[cross] <= 0.1).sum() > 10 and ((d > 0.1) & (d <= 0.25)).sum() > 100
    # and genus mates the retention bound drops: fewer edges than pairs in genera
    in_genus = sum(int(c) * (int(c) - 1) // 2 for c in np.bincount(p.genus))
    assert ref.keys.shape[0] < in_genus
    # primary clusters that are neither single genomes nor whole genera
    sizes = ref.canon[:, 1]
    assert (sizes > 1).sum() > 10 and len(np.unique(ref.canon[:, 0])) > len(np.unique(p.genus))


def test_members_are_scattered():
    p = _plant(11, n=2000)
    same_as_next = np.mean(p.genus[1:] == p.genus[:-1])
    assert same_as_next < 0.05


def test_config_planting_reads_the_config():
    cfg = load_cell("gtdb207_reps.primary").config
    p = plant_config(dict(cfg, genomes=500), 500, 5, CPU)
    assert p.hashes.shape == (500, cfg["MASH_sketch"])
    st = structure(cfg["planting"], 500)
    assert np.array_equal(np.sort(np.bincount(p.genus)), np.sort(np.bincount(st.genus_of_species)))


@pytest.mark.card
def test_planter_on_the_card_repeats(cuda_device):
    a = plant(3000, structure(REPS, 3000), 5, 1000, 2000, 0, 1000, cuda_device)
    b = plant(3000, structure(REPS, 3000), 5, 1000, 2000, 0, 1000, cuda_device)
    assert a.hashes.tobytes() == b.hashes.tobytes()
