"""A process of tests/test_torch_pod.py's library-level pod: run through
subprocess, not collected by pytest.

    python tests/_torch_pod_worker.py OUT_NPZ CHECKPOINT_DIR [--no_ring] [--log_dir DIR]

A pod member when the pod environment is set (WORLD_SIZE, RANK,
MASTER_ADDR, MASTER_PORT), a mid-run joiner when DREP_TORCH_POD_JOIN is.
It walks the streaming primary over the seeded planted pack of
:func:`planted_pack` on the CPU with --max_joins 1 and writes its edges
to OUT_NPZ, or ``drained`` beside it when it was asked to drain, and its
fault counters (joins, churn) to ``OUT_NPZ.counters.json``. A pod member
first runs a store-less pod ring over the pack's first RING_GENOMES
genomes (4 positions, 2 a member) into ``OUT_NPZ.ring.npy``, unless
``--no_ring``. With ``--log_dir`` and DREP_TORCH_EVENTS=on it traces into
DIR.
"""

import json
import os
import sys

import numpy as np

N_GENOMES = 1100
WIDTH = 64
BLOCK = 128
CUTOFF = 0.3
RING_GENOMES = 90


def planted_pack():
    """The same pack in every process: planted clusters of sketches."""
    from drep_tpu_torch.ops.minhash import pack_sketches

    rng = np.random.default_rng(11)
    sk = []
    while len(sk) < N_GENOMES:
        pool = np.unique(rng.integers(0, 2**62, size=2 * WIDTH, dtype=np.uint64))
        for _ in range(int(rng.integers(1, 9))):
            keep = pool[rng.random(len(pool)) < 0.9]
            own = np.unique(rng.integers(0, 2**62, size=WIDTH // 6, dtype=np.uint64))
            sk.append(np.sort(np.concatenate([keep, own]))[:WIDTH])
    sk = sk[:N_GENOMES]
    return pack_sketches(sk, [f"p{i}" for i in range(len(sk))], WIDTH)


def ring_pack():
    """The pack's first RING_GENOMES genomes."""
    from drep_tpu_torch.ops.minhash import PackedSketches

    p = planted_pack()
    return PackedSketches(ids=p.ids[:RING_GENOMES], counts=p.counts[:RING_GENOMES], names=p.names[:RING_GENOMES])


def main() -> None:
    out, ckpt, opts = sys.argv[1], sys.argv[2], sys.argv[3:]
    from drep_tpu_torch.parallel import faulttol
    from drep_tpu_torch.parallel.mesh import initialize_distributed, process_index
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges
    from drep_tpu_torch.utils import telemetry
    from drep_tpu_torch.utils.profiling import counters

    pod = initialize_distributed()
    if "--log_dir" in opts:
        telemetry.configure(log_dir=opts[opts.index("--log_dir") + 1], pid=process_index())
    if pod and "--no_ring" not in opts:
        # a store-less pod ring first: each member's rows over gloo
        from drep_tpu_torch.parallel.allpairs import sharded_mash_allpairs
        from drep_tpu_torch.parallel.mesh import make_mesh

        np.save(out + ".ring.npy", sharded_mash_allpairs(ring_pack(), k=21, mesh=make_mesh(4, "cpu")))
    try:
        ii, jj, dd, pairs = streaming_mash_edges(
            planted_pack(), k=21, cutoff=CUTOFF, block=BLOCK, checkpoint_dir=ckpt, device="cpu",
            ft_config=faulttol.FaultTolConfig(max_joins=1),
        )
    except faulttol.PodDrained:
        with open(out + ".drained", "w") as f:
            f.write("drained")
        return
    finally:
        telemetry.close()
        with open(out + ".counters.json", "w") as f:
            json.dump(counters.faults, f)
    np.savez(out, ii=ii, jj=jj, dist=dd, pairs=np.int64(pairs))


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
