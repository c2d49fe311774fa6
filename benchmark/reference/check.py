"""The comparison that decides ``correct`` for the streaming primary.

The numbers compared, each with its limit (PERF.md gives the readings
they were set from). Each is the worst over the window's jobs.

- ``pairs_off``: the most any job's ``pairs_computed`` departs from
  N(N-1)/2 (dense cells: a walk that resumed, skipped or repeated work);
  exact, limit 0;
- ``edges_missing``: pairs the reference retains that the program did not
  emit; exact, limit 0;
- ``edges_extra``: edges the program emitted that the reference does not
  retain, emitted twice, or not of the form i < j < N; exact, limit 0;
- ``dist_gap_max``: the widest gap between the program's float32 distance
  of an edge and the reference's. Sound runs read 0 (the same float32
  formula); one shared count altered reads 4.3e-5, the control (bfloat16
  distances) 1.2e-3. The limit, 1e-5, is some 300 float32 steps at
  d = 0.25;
- ``labels_wrong``: genomes whose primary cluster, as a set of genomes,
  is not the reference's (average linkage, ties taken in the order
  reference/primary.py states); exact, limit 0.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.primary import PrimaryReference, canonical

LIMITS = {
    "pairs_off": 0,
    "edges_missing": 0,
    "edges_extra": 0,
    "dist_gap_max": 1e-5,
    "labels_wrong": 0,
}


def compare_outputs(ref: PrimaryReference, ii: np.ndarray, jj: np.ndarray, dd: np.ndarray,
                    labels: np.ndarray) -> dict[str, float]:
    """edges_missing, edges_extra, dist_gap_max and labels_wrong of one
    job's outputs (module docstring)."""
    n = ref.n
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    dd = np.asarray(dd, dtype=np.float32)
    if not (ii.shape == jj.shape == dd.shape and ii.ndim == 1):
        return {"edges_missing": len(ref.keys), "edges_extra": max(ii.size, jj.size, dd.size),
                "dist_gap_max": float("inf"), "labels_wrong": n}
    good = (ii >= 0) & (ii < jj) & (jj < n)
    malformed = int((~good).sum())
    keys = ii[good] * n + jj[good]
    order = np.argsort(keys, kind="stable")
    keys, dd = keys[order], dd[good][order]
    first = np.ones(keys.shape[0], dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    repeated = int((~first).sum())
    keys, dd = keys[first], dd[first]
    at = np.searchsorted(ref.keys, keys)
    found = at < ref.keys.shape[0]
    found[found] = ref.keys[at[found]] == keys[found]
    matched = int(found.sum())
    gap = np.abs(dd[found].astype(np.float64) - ref.dist[at[found]].astype(np.float64))
    labels = np.asarray(labels)
    if labels.shape != (n,):
        wrong = n
    else:
        wrong = int(np.any(canonical(labels) != ref.canon, axis=1).sum())
    return {
        "edges_missing": ref.keys.shape[0] - matched,
        "edges_extra": keys.shape[0] - matched + repeated + malformed,
        "dist_gap_max": float(gap.max()) if gap.size else 0.0,
        "labels_wrong": wrong,
    }


def verdict(values: dict[str, float]) -> tuple[bool, dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}}) over the
    numbers given, in LIMITS' order."""
    out = {name: {"value": values[name], "limit": LIMITS[name]} for name in LIMITS if name in values}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
