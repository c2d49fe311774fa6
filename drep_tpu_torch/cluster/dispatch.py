"""Comparison-algorithm dispatch (the reference's `--primary_algorithm` /
`--S_algorithm` registry; counterpart of drep_tpu/cluster/dispatch.py).

The port registers the JAX package's engine names, so that an argv runs
unchanged: the device engines `jax_mash` and `jax_ani`
(cluster/engines.py, on the CUDA kernels), and the subprocess engines
around external binaries, `mash` and `fastANI` (cluster/external.py),
`ANImf`, `ANIn`, `gANI` and `goANI` (cluster/anim.py). engines.py imports
the last two modules, so importing it fills the registry; they load only
the standard library beside numpy and pandas.

A primary algorithm maps a GenomeSketches + kwargs to a full [N, N] distance
matrix. A secondary algorithm maps a subset of genomes to directional
(ani, cov) matrices.
"""

from __future__ import annotations

from typing import Callable

PRIMARY_ALGORITHMS: dict[str, Callable] = {}
SECONDARY_ALGORITHMS: dict[str, Callable] = {}
# optional batched variants: one device call for MANY small clusters
# (fn(gs, clusters, **kw) -> list of (ani, cov) in cluster order)
SECONDARY_BATCHED: dict[str, Callable] = {}


def register_primary(name: str):
    def deco(fn):
        PRIMARY_ALGORITHMS[name] = fn
        return fn

    return deco


def register_secondary(name: str):
    def deco(fn):
        SECONDARY_ALGORITHMS[name] = fn
        return fn

    return deco


def get_primary(name: str) -> Callable:
    if name not in PRIMARY_ALGORITHMS:
        raise KeyError(
            f"unknown primary_algorithm {name!r}; available: {sorted(PRIMARY_ALGORITHMS)}"
        )
    return PRIMARY_ALGORITHMS[name]


def register_secondary_batched(name: str):
    def deco(fn):
        SECONDARY_BATCHED[name] = fn
        return fn

    return deco


def get_secondary(name: str) -> Callable:
    if name not in SECONDARY_ALGORITHMS:
        raise KeyError(f"unknown S_algorithm {name!r}; available: {sorted(SECONDARY_ALGORITHMS)}")
    return SECONDARY_ALGORITHMS[name]


def get_secondary_batched(name: str) -> Callable | None:
    """Batched variant when the engine has one; None -> per-cluster calls."""
    return SECONDARY_BATCHED.get(name)
