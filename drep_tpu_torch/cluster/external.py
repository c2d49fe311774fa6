"""The subprocess engines around `mash` and `fastANI`.

Counterpart of drep_tpu/cluster/external.py (the reference's run_MASH and
run_pairwise_fastANI). These engines run the external binaries on the
host and move no work onto the card or off it: a run with
``--primary_algorithm mash`` launches no Mash kernel, and one with
``--S_algorithm fastANI`` no indicator kernel. Each raises UserInputError
when its binary is not on $PATH; nothing falls back to a device engine.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import pandas as pd

from drep_tpu_torch.cluster.dispatch import register_primary, register_secondary
from drep_tpu_torch.errors import UserInputError
from drep_tpu_torch.ingest import GenomeSketches
from drep_tpu_torch.utils.durableio import atomic_write_bytes
from drep_tpu_torch.utils.logger import get_logger


def require_binary(binary: str, hint: str = "jax_mash/jax_ani") -> str:
    """Resolve an external binary or fail naming the device engine (the
    JAX package's text, so both packages fail alike)."""
    path = shutil.which(binary)
    if path is None:
        raise UserInputError(
            f"external binary {binary!r} not found on $PATH — use the TPU-native "
            f"engine ({hint}) or install {binary}"
        )
    return path


def run_subprocess(cmd: list[str], cwd: str | None = None) -> str:
    """Run one external tool invocation; raise with captured stderr on failure."""
    get_logger().debug("subprocess: %s", " ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=cwd)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed (exit {res.returncode}): {res.stderr[-2000:]}")
    return res.stdout


@register_primary("mash")
def primary_mash(gs: GenomeSketches, bdb: pd.DataFrame | None = None, processes: int = 1, **_):
    """`mash sketch` + `mash dist` all-vs-all (the reference's primary
    default). mash names its rows by the paths it sketched; they are
    matched on their basenames."""
    require_binary("mash")
    if bdb is None:
        raise ValueError("mash fallback needs Bdb (paths to the FASTA files)")
    loc = {r.genome: r.location for r in bdb.itertuples()}
    names = gs.names
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "all")
        paths = [loc[g] for g in names]
        run_subprocess(["mash", "sketch", "-p", str(processes), "-s", str(gs.sketch_size), "-o", msh] + paths)
        out = run_subprocess(["mash", "dist", "-p", str(processes), f"{msh}.msh", f"{msh}.msh"])
    n = len(names)
    index = {os.path.basename(p): i for i, p in enumerate(paths)}
    dist = np.ones((n, n), dtype=np.float32)
    for line in out.strip().splitlines():
        ref, qry, d, _p, _shared = line.split("\t")
        i = index[os.path.basename(ref)]
        j = index[os.path.basename(qry)]
        dist[i, j] = float(d)
    np.fill_diagonal(dist, 0.0)
    return dist, 1.0 - dist


@register_secondary("fastANI")
def secondary_fastani(
    gs: GenomeSketches,
    indices: list[int],
    bdb: pd.DataFrame | None = None,
    processes: int = 1,
    **_,
):
    """Pairwise fastANI within one primary cluster (the reference's
    secondary default): one call over a list file of the members' paths,
    its output rows matched on those exact path strings."""
    require_binary("fastANI")
    if bdb is None:
        raise ValueError("fastANI fallback needs Bdb (paths to the FASTA files)")
    loc = {r.genome: r.location for r in bdb.itertuples()}
    names = [gs.names[i] for i in indices]
    paths = [loc[g] for g in names]
    m = len(names)
    ani = np.zeros((m, m), dtype=np.float32)
    cov = np.zeros((m, m), dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        lst = os.path.join(tmp, "genomes.txt")
        atomic_write_bytes(lst, ("\n".join(paths) + "\n").encode())
        out_f = os.path.join(tmp, "fastani.out")
        run_subprocess(["fastANI", "--ql", lst, "--rl", lst, "-t", str(processes), "-o", out_f])
        index = {p: i for i, p in enumerate(paths)}
        with open(out_f) as f:
            for line in f:
                q, r, a, frag_mapped, frag_total = line.split("\t")
                i, j = index[q], index[r]
                ani[i, j] = float(a) / 100.0
                cov[i, j] = float(frag_mapped) / max(float(frag_total), 1.0)
    np.fill_diagonal(ani, 1.0)
    np.fill_diagonal(cov, 1.0)
    return ani, cov


# every binary the subprocess engines and the bonus stage call
# (check_dependencies probes each)
EXTERNAL_SUITE = [
    "mash", "fastANI", "nucmer", "prodigal", "checkm", "centrifuge", "ANIcalculator", "nsimscan",
]

# how each binary reports its version
_VERSION_FLAGS = {
    "mash": ["--version"],
    "fastANI": ["--version"],
    "nucmer": ["--version"],
    "prodigal": ["-v"],
    "checkm": [],  # checkm prints usage with version header on bare call
    "centrifuge": ["--version"],
}


def find_program(binary: str) -> tuple[str | None, str | None]:
    """(path, version) of an external binary. The version is the first
    non-empty line of its version call, None where the binary has no
    known version flag or the call fails."""
    path = shutil.which(binary)
    if path is None:
        return None, None
    flags = _VERSION_FLAGS.get(binary)
    if flags is None:
        return path, None
    try:
        res = subprocess.run([binary] + flags, capture_output=True, text=True, timeout=30)
        out = (res.stdout + res.stderr).strip().splitlines()
        return path, next((ln.strip() for ln in out if ln.strip()), None)
    except Exception:  # noqa: BLE001 — a version is best effort
        return path, None
