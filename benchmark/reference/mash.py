"""The plain Mash estimator on raw uint64 bottom sketches.

For two sketches A and B (ascending, distinct hashes), with
s_use = min(|A|, |B|, s), ``shared`` is the number of hashes present in
both among the s_use smallest distinct hashes of their union, the
Jaccard estimate is shared / s_use, and the Mash distance is
d = -ln(2j / (1 + j)) / k, clipped to [0, 1] (d = 1 where j = 0).

Plain PyTorch and NumPy; nothing here comes from the program under test.
The distance is computed in float32 (the precision the configuration
states) or, for the control, in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

PAD = torch.iinfo(torch.int64).max


def signed_rows(hashes: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """uint64 rows -> int64 rows in the same order (the top bit flipped),
    each row's tail past its count set to PAD."""
    out = (hashes ^ np.uint64(1 << 63)).view(np.int64).copy()
    out[np.arange(hashes.shape[1])[None, :] >= counts[:, None]] = np.iinfo(np.int64).max
    return out


def shared_counts(a: torch.Tensor, na: torch.Tensor, b: torch.Tensor, nb: torch.Tensor, s: int) -> torch.Tensor:
    """[P] shared counts of the row pairs (a[p], b[p]): rows [P, w] int64
    ascending, padded with PAD past their counts na, nb [P].

    For a hash a_k of A that B also holds, the distinct hashes of the union
    up to it are (k + 1) of A's, plus the pos_k of B's below it and itself,
    less the shared ones counted twice, so its rank in the union is
    k + 1 + pos_k - (shared hashes before it)."""
    w = a.shape[1]
    pos = torch.searchsorted(b, a)
    hit = torch.gather(b, 1, pos.clamp(max=w - 1)) == a
    k = torch.arange(w, device=a.device)
    hit &= (k[None, :] < na[:, None]) & (pos < nb[:, None])
    before = torch.cumsum(hit, dim=1) - hit.long()
    rank = k[None, :] + 1 + pos - before
    s_use = torch.clamp(torch.minimum(na, nb), max=s)
    return (hit & (rank <= s_use[:, None])).sum(dim=1)


def pair_shared(rows: torch.Tensor, counts: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, s: int,
                chunk: int = 1 << 16) -> torch.Tensor:
    """Shared counts of the pairs (ii[p], jj[p]) of the rows, in chunks."""
    out = torch.empty(ii.shape[0], dtype=torch.int64, device=rows.device)
    for lo in range(0, ii.shape[0], chunk):
        i, j = ii[lo : lo + chunk], jj[lo : lo + chunk]
        out[lo : lo + chunk] = shared_counts(rows[i], counts[i], rows[j], counts[j], s)
    return out


def distance(shared: np.ndarray, s_use: np.ndarray, k: int, precision: str = "float32") -> np.ndarray:
    """float32 Mash distances of pairs with these shared counts and s_use,
    computed in `precision` (float32, or bfloat16 for the control)."""
    if precision == "float32":
        f = np.float32
        j = np.where(s_use > 0, shared.astype(f) / np.maximum(s_use, 1).astype(f), f(0.0)).astype(f)
        jj = np.maximum(j, f(1e-30))
        d = np.where(j > f(0.0), -np.log(f(2.0) * jj / (f(1.0) + jj)) / f(k), f(1.0))
        return np.clip(d, f(0.0), f(1.0)).astype(f)
    if precision == "bfloat16":
        bf = torch.bfloat16
        sh = torch.as_tensor(shared).to(bf)
        su = torch.as_tensor(np.maximum(s_use, 1)).to(bf)
        j = torch.where(torch.as_tensor(s_use) > 0, sh / su, torch.zeros((), dtype=bf))
        jj = torch.clamp(j, min=1e-30)
        d = torch.where(j > 0, -torch.log(2.0 * jj / (1.0 + jj)) / k, torch.ones((), dtype=bf))
        return torch.clamp(d, 0.0, 1.0).float().numpy()
    raise ValueError(f"unknown precision {precision!r}")
