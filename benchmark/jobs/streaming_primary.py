"""Job driver ``streaming_primary``: one job is what the port's controller
does for a streaming primary (drep_tpu_torch/cluster/controller.py::
_streaming_primary), through the port's two public calls:

1. ``ops.minhash.pack_sketches(bottoms, names, MASH_sketch)``;
2. ``parallel.streaming.streaming_primary_clusters(packed, ...)`` with the
   configuration's k, P_ani, warn_dist (the retention bound) and
   clusterAlg, the cell's block and pruning, and a new checkpoint
   directory under $TMPDIR, deleted when the job ends (a reused one would
   resume and compute nothing).

The work of a job is the N(N-1)/2 genome pairs it decides. The answers
(retained edges and primary labels) of every job are kept until the
window has closed; then each is compared with the plain reference
(benchmark/reference).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import torch

from benchmark.gen.planted import plant_config
from benchmark.reference.check import compare_outputs
from benchmark.reference.primary import primary_reference
from benchmark.roofline.mash import dense_job_cost

# the layers a job's host time splits into, in the order they run
PHASES = ("pack", "prune", "walk", "linkage")


class Job:
    """Set-up (the planted inputs), the window's jobs, and the check."""

    def __init__(self, config: dict, params: dict, seed: int, device: torch.device):
        self.config = config
        self.params = params
        self.device = device
        self.n = int(config["genomes"])
        self.sketch = int(config["MASH_sketch"])
        self.planted = plant_config(config, self.n, seed, device)
        self.bottoms = self.planted.bottoms()
        self.names = [f"genome_{i:06d}.fna" for i in range(self.n)]
        self.dense = params["primary_prune"] == "off"
        self.outputs: list[tuple] = []
        self.shared_sum: int | None = None

    # -- the timed path --------------------------------------------------

    def _job(self, bottoms: list, names: list) -> tuple[dict, tuple]:
        from drep_tpu_torch.ops.minhash import pack_sketches
        from drep_tpu_torch.parallel import streaming

        cfg, p = self.config, self.params
        ckpt = tempfile.mkdtemp(prefix="streaming_primary_")
        try:
            t0 = time.perf_counter()
            packed = pack_sketches(bottoms, names, self.sketch)
            t1 = time.perf_counter()
            labels, (ii, jj, dd), pairs = streaming.streaming_primary_clusters(
                packed, int(cfg["mash_k"]), float(cfg["P_ani"]), block=int(p["block"]),
                checkpoint_dir=ckpt, keep_dist=float(cfg["warn_dist"]), cluster_alg=cfg["clusterAlg"],
                primary_prune=p["primary_prune"], prune_bands=int(p["prune_bands"]),
                prune_min_shared=int(p["prune_min_shared"]), prune_join_chunk=int(p["prune_join_chunk"]),
                device=self.device,
            )
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        st = streaming.STATS
        n = len(names)
        record = {
            "work": n * (n - 1) // 2,
            "pairs_computed": int(pairs),
            "edges": int(len(ii)),
            "launches": int(st["launches"]),
            "pack_s": t1 - t0,
            "prune_s": float(st["prune_seconds"]),
            "walk_s": float(st["seconds"]),
            "linkage_s": float(st["linkage_seconds"]),
        }
        return record, (ii, jj, dd, labels)

    def warm(self) -> None:
        """The whole path once on the first ``warm_genomes`` genomes (the
        cell's own shape where that is all of them): builds or loads the
        kernels and the native linkage, and starts the device's allocator
        and the host's heap at the sizes the window uses."""
        m = min(self.n, int(self.params["warm_genomes"]))
        self._job(self.bottoms[:m], self.names[:m])

    def run(self) -> dict:
        """One job of the window."""
        record, out = self._job(self.bottoms, self.names)
        self.outputs.append(out)
        return record

    def phases(self, record: dict) -> list[tuple[str, float]]:
        """(layer, seconds) of a job's host time, in the order they ran."""
        return [(name, record[f"{name}_s"]) for name in PHASES]

    # -- after the window --------------------------------------------------

    def _reference(self, precision: str = "float32"):
        cfg = self.config
        cutoff = 1.0 - float(cfg["P_ani"])
        keep = max(cutoff, float(cfg["warn_dist"]))
        return primary_reference(self.planted.hashes, self.planted.counts, self.sketch, int(cfg["mash_k"]),
                                 cutoff, keep, self.device, precision)

    def check(self, records: list[dict]) -> dict[str, float]:
        """The numbers compared (benchmark/reference/check.py), each the
        worst over the window's jobs."""
        ref = self._reference()
        self.shared_sum = ref.shared_sum
        values: dict[str, float] = {}
        for out in self.outputs:
            for name, v in compare_outputs(ref, *out).items():
                values[name] = max(values.get(name, v), v)
        if self.dense:
            values["pairs_off"] = max(abs(r["work"] - r["pairs_computed"]) for r in records)
        self.outputs.clear()
        return values

    def control(self) -> dict[str, float]:
        """The control: the reference in bfloat16 put in the program's place,
        compared as the program's answers are."""
        ref = self._reference()
        low = self._reference("bfloat16")
        n = self.n
        labels = low.canon[:, 0]
        values = compare_outputs(ref, low.keys // n, low.keys % n, low.dist, labels)
        if self.dense:
            values["pairs_off"] = 0
        return values

    def kernel_bounds(self) -> dict[str, tuple[int, int]]:
        """{kernel name: (merge steps, bytes) a job}: the Mash kernel over
        every pair a dense job decides (read after :meth:`check`)."""
        if not self.dense or self.shared_sum is None:
            return {}
        return {"mash_shared": dense_job_cost(self.planted.counts, self.sketch, self.shared_sum)}
