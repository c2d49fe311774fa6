"""Tests of the benchmark itself (run: python -m pytest benchmark/tests).

Cases that need a CUDA card carry the ``card`` marker and take the
``cuda_device`` fixture, which skips them where there is none; the rest
rehearse the harness on the CPU at a tiny size."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the CPU rehearsal's size: 300 genomes in 128-row stripes
TINY_GENOMES = 300
TINY_PARAMS = {"block": 128, "warm_genomes": 128}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny(cell, genomes: int = TINY_GENOMES):
    """`cell` cut to the CPU rehearsal's size (a copy)."""
    cell = copy.copy(cell)
    cell.config = dict(cell.config, genomes=genomes)
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["params"].update(TINY_PARAMS)
    return cell


@pytest.fixture
def tiny_params():
    return dict(TINY_PARAMS)


@pytest.fixture
def tiny_cell():
    from benchmark import harness

    return lambda name, root=ROOT, genomes=TINY_GENOMES: tiny(harness.load_cell(name, root), genomes)
