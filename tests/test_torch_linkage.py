"""The port's linkage (drep_tpu_torch/ops/linkage.py) against the JAX
package's: flat labels equal exactly, first-appearance order included."""

import numpy as np
import pytest
import torch

from drep_tpu.ops import linkage as jl
from drep_tpu_torch.ops import linkage as tl

CPU = torch.device("cpu")


def _clustered_dist(rng, n, groups):
    """Symmetric float32 distances: tight within planted groups, far across."""
    g = rng.integers(0, groups, size=n)
    d = np.where(g[:, None] == g[None, :], rng.uniform(0.0, 0.08, (n, n)), rng.uniform(0.2, 1.0, (n, n)))
    d = np.minimum(d, d.T).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("method", ["average", "single", "complete", "weighted"])
def test_cluster_hierarchical_equals_jax(method):
    rng = np.random.default_rng(1)
    dist = _clustered_dist(rng, 60, 7)
    want, want_link = jl.cluster_hierarchical(dist, 0.1, method=method)
    got, got_link = tl.cluster_hierarchical(dist, 0.1, method=method)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_link, want_link)


@pytest.mark.parametrize("n,cutoff", [(100, 0.1), (150, 0.3), (90, 0.0)])
def test_single_linkage_device_equals_jax(n, cutoff):
    rng = np.random.default_rng(n)
    dist = _clustered_dist(rng, n, 11)
    want = jl.single_linkage_device(dist, cutoff)
    got = tl.single_linkage_device(dist, cutoff, CPU)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1 and set(got) == set(range(1, got.max() + 1))


def test_components_of_a_chain_need_many_sweeps():
    """A long path graph: labels must propagate end to end."""
    n = 70
    adj = torch.zeros((n, n), dtype=torch.bool)
    idx = torch.arange(n - 1)
    adj[idx, idx + 1] = True
    adj[idx + 1, idx] = True
    labels = tl.connected_components_labels(adj)
    assert labels.tolist() == [0] * n
