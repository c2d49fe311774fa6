"""Real 2-process pods of the port on the CPU, over gloo
(drep_tpu_torch/parallel/mesh.py), against single-process runs.

Each member is its own ``python`` process started with the standard pod
environment on a free localhost port; every member is reaped when a case
fails. Four pod launches:

- (a) a healthy pod's ``compare --streaming_primary`` with heartbeats
  off: the sharded ingest (the members' digests agree), the stores' gloo
  barriers, the streaming primary's stripes dealt over the members and
  their edges exchanged over gloo, the secondary replicated on each. Cdb and Ndb
  are byte-identical to the JAX package's single-process run on the same
  argv, Mdb's edges are the port's single-process edges byte for byte and
  the JAX package's at the repo's atol=1e-7 (XLA's float32 log against
  numpy's);
- (b) the same with member 1 SIGKILLed at its first stripe
  (``process_death:kill``): the survivor declares it dead, re-deals and
  finishes with the same tables. The JAX package's own SIGKILL pod tests
  are red on the reference side, so this is held against the
  single-process runs, as those tests are;
- (c) ``compare --mesh_shape 4``, the dense primary's ring over 2
  positions a member, member 1 SIGKILLed at its second ring step
  (``ring_step:kill``): the survivor recomputes the missing blocks, and
  Cdb, Ndb and Mdb equal the JAX package's single-device run (Mdb at
  atol=1e-7) and the port's single-process run byte for byte;
- (d) a library-level streaming walk (tests/_torch_pod_worker.py) where
  member 1 drains at its first stripe and a third process joins mid-run
  (``DREP_TORCH_POD_JOIN``, --max_joins 1): the edges are the JAX
  package's single-process walk's (its pairs exactly, its distances at
  atol=1e-7) and the port's bit for bit; before it, the two members'
  store-less pod ring (rows over gloo) gives the JAX package's
  ``all_vs_all_mash`` (atol=1e-7) and the port's one-device matrix bit
  for bit.
"""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from drep_tpu_torch.utils import telemetry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARGS = ["--skip_plots", "--MASH_sketch", "64"]
STREAMING = ["--streaming_primary", "--streaming_block", "128"]
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("DREP_TORCH_")}
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               DREP_TORCH_HEARTBEAT_S="0.3", DREP_TORCH_COLLECTIVE_TIMEOUT_S="90")
    env.update(extra)
    return env


def _run(cmds: list[tuple[list[str], dict]], log_dir, gate=None) -> list[int]:
    """Start the processes (the rest only once `gate()` holds, when given,
    after the first); their exit codes. All are reaped (and killed on a
    timeout or a failure here)."""
    import time

    procs = []
    try:
        for i, (argv, env) in enumerate(cmds):
            if i == 1 and gate is not None:
                deadline = time.monotonic() + TIMEOUT_S
                while not gate():
                    assert time.monotonic() < deadline and procs[0][0].poll() is None, "the gate never opened"
                    time.sleep(0.05)
            log = open(os.path.join(log_dir, f"proc{i}.log"), "w")  # noqa: SIM115 — closed below
            procs.append((subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
        return [p.communicate(timeout=TIMEOUT_S)[0] or p.returncode for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _pod(wd, log_dir, argv: list[str], faults: str = "", heartbeat: str = "0.3") -> list[int]:
    port = str(_free_port())
    cmds = []
    for rank in range(2):
        env = _env({"WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": port, "DREP_TORCH_FAULTS": faults, "DREP_TORCH_HEARTBEAT_S": heartbeat})
        cmds.append(([sys.executable, "-m", "drep_tpu_torch", *argv, "--device", "cpu"], env))
    return _run(cmds, log_dir)


def _log(log_dir, i: int) -> str:
    with open(os.path.join(log_dir, f"proc{i}.log")) as f:
        return f.read()


def _table(wd, name: str) -> bytes:
    with open(os.path.join(wd, "data_tables", f"{name}.csv"), "rb") as f:
        return f.read()


def _mdb_close(got_wd, want_wd) -> None:
    a, b = pd.read_csv(os.path.join(got_wd, "data_tables", "Mdb.csv")), pd.read_csv(
        os.path.join(want_wd, "data_tables", "Mdb.csv"))
    assert list(a.genome1) == list(b.genome1) and list(a.genome2) == list(b.genome2)
    np.testing.assert_allclose(a.dist.to_numpy(), b.dist.to_numpy(), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    from _index_testlib import write_genome_set

    return write_genome_set(str(tmp_path_factory.mktemp("g")), [6] * 50, seed=3, length=3000)


@pytest.fixture(scope="module")
def singles(genomes, tmp_path_factory):
    """The single-process runs: the port's and the JAX package's, streaming
    and dense."""
    from drep_tpu.workflows import compare_wrapper as jax_compare
    from drep_tpu_torch.workflows import compare_wrapper as torch_compare

    root = tmp_path_factory.mktemp("single")
    out = {}
    for mode, extra in (("streaming", {"streaming_primary": True, "streaming_block": 128}), ("dense", {})):
        kw = dict(skip_plots=True, MASH_sketch=64, **extra)
        out[("torch", mode)] = str(root / f"torch_{mode}")
        torch_compare(out[("torch", mode)], genomes, device="cpu", **kw)
        out[("jax", mode)] = str(root / f"jax_{mode}")
        jax_compare(out[("jax", mode)], genomes, **kw)
    telemetry.close()
    return out


def test_healthy_streaming_pod_equals_single_process(tmp_path, genomes, singles):
    wd = str(tmp_path / "wd")
    # heartbeats off: the stores' gloo barriers and the edge allgather
    rcs = _pod(wd, tmp_path, ["compare", wd, "-g", *genomes, *ARGS, *STREAMING], heartbeat="0")
    assert rcs == [0, 0], (_log(tmp_path, 0)[-3000:], _log(tmp_path, 1)[-3000:])
    digests = [line.split("digest ")[1] for i in range(2) for line in _log(tmp_path, i).splitlines()
               if "assembled 300 genomes, digest" in line]
    assert len(digests) == 2 and digests[0] == digests[1]
    for name in ("Cdb", "Ndb"):
        assert _table(wd, name) == _table(singles[("jax", "streaming")], name)
    assert _table(wd, "Mdb") == _table(singles[("torch", "streaming")], "Mdb")
    _mdb_close(wd, singles[("jax", "streaming")])
    shards = sorted(os.listdir(os.path.join(wd, "data", "streaming_primary")))
    assert [s for s in shards if s.startswith("row_")] == ["row_00000.npz", "row_00001.npz", "row_00002.npz"]
    assert not [s for s in shards if s.startswith(".pod-")]  # no heartbeat, no note


def test_streaming_pod_survives_a_sigkilled_member(tmp_path, genomes, singles):
    wd = str(tmp_path / "wd")
    rcs = _pod(wd, tmp_path, ["compare", wd, "-g", *genomes, *ARGS, *STREAMING], faults="process_death:kill:proc=1")
    assert rcs[0] == 0 and rcs[1] == -signal.SIGKILL, (rcs, _log(tmp_path, 0)[-3000:])
    assert "stopped heartbeating" in _log(tmp_path, 0)
    for name in ("Cdb", "Ndb", "Mdb"):
        assert _table(wd, name) == _table(singles[("torch", "streaming")], name)
    for name in ("Cdb", "Ndb"):
        assert _table(wd, name) == _table(singles[("jax", "streaming")], name)
    store = os.path.join(wd, "data", "streaming_primary")
    assert "row_00001.e01.npz" in os.listdir(store)  # member 1's stripe, re-dealt at epoch 1
    from drep_tpu_torch.utils.durableio import read_json_checked

    meta = read_json_checked(os.path.join(store, "meta.json"))
    assert meta["dead_processes"] == [1] and meta["pod_epochs"] == 2


def test_ring_pod_survives_a_sigkilled_member(tmp_path, genomes, singles):
    wd = str(tmp_path / "wd")
    rcs = _pod(wd, tmp_path, ["compare", wd, "-g", *genomes, *ARGS, "--mesh_shape", "4"],
               faults="ring_step:kill:proc=1:skip=1")
    assert rcs[0] == 0 and rcs[1] == -signal.SIGKILL, (rcs, _log(tmp_path, 0)[-3000:])
    log0 = _log(tmp_path, 0)
    assert "stopped heartbeating" in log0 and "dense ring: completed with MEMBERSHIP CHURN" in log0
    for name in ("Cdb", "Ndb", "Mdb"):
        assert _table(wd, name) == _table(singles[("torch", "dense")], name)
    for name in ("Cdb", "Ndb"):
        assert _table(wd, name) == _table(singles[("jax", "dense")], name)
    _mdb_close(wd, singles[("jax", "dense")])
    (store,) = os.listdir(os.path.join(wd, "data", "dense_ring"))
    blocks = sorted(b for b in os.listdir(os.path.join(wd, "data", "dense_ring", store)) if b.startswith("blk_"))
    # member 1 (positions 2, 3) published its first step; the survivor its second at epoch 1
    assert "blk_002_002.npz" in blocks and "blk_002_001.e01.npz" in blocks and "blk_003_002.e01.npz" in blocks


def test_streaming_walk_drain_and_join_give_the_same_edges(tmp_path):
    sys.path.insert(0, HERE)
    from _torch_pod_worker import BLOCK, CUTOFF, planted_pack, ring_pack

    from drep_tpu.ops.minhash import PackedSketches as JaxPacked
    from drep_tpu.ops.minhash import all_vs_all_mash as jax_all_vs_all_mash
    from drep_tpu.parallel.streaming import streaming_mash_edges as jax_streaming_mash_edges
    from drep_tpu_torch.ops.mash import all_vs_all_mash
    from drep_tpu_torch.parallel.streaming import streaming_mash_edges

    pack = planted_pack()
    want = streaming_mash_edges(pack, k=21, cutoff=CUTOFF, block=BLOCK, device="cpu")
    jax_want = jax_streaming_mash_edges(JaxPacked(ids=pack.ids, counts=pack.counts, names=list(pack.names)), k=21,
                                        cutoff=CUTOFF, block=BLOCK)
    ckpt = str(tmp_path / "ckpt")
    worker = [sys.executable, os.path.join(HERE, "_torch_pod_worker.py")]
    port = str(_free_port())
    # the joiner (an explicit id) starts first and the pod once its join
    # request is out, so the leader admits it at its first check; every
    # stripe takes 0.3 s more, so the pod is still walking then
    slow = "streaming_tile:sleep:secs=0.3"
    cmds = [([*worker, str(tmp_path / "j.npz"), ckpt], _env({"DREP_TORCH_POD_JOIN": "2",
                                                             "DREP_TORCH_FAULTS": slow}))]
    cmds += [([*worker, str(tmp_path / f"m{r}.npz"), ckpt],
              _env({"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": port, "DREP_TORCH_FAULTS": f"{slow},process_death:drain:proc=1"}))
             for r in range(2)]
    rcs = _run(cmds, tmp_path, gate=lambda: os.path.exists(os.path.join(ckpt, ".pod-join.p2")))
    assert rcs == [0, 0, 0], (rcs, _log(tmp_path, 1)[-3000:], _log(tmp_path, 0)[-3000:])
    assert os.path.exists(str(tmp_path / "m1.npz.drained"))
    log0 = _log(tmp_path, 1)
    assert "departed PLANNED" in log0 and "JOINED mid-run" in log0
    for name in ("m0.npz", "j.npz"):
        with np.load(str(tmp_path / name)) as z:
            np.testing.assert_array_equal(z["ii"], jax_want[0])
            np.testing.assert_array_equal(z["jj"], jax_want[1])
            np.testing.assert_allclose(z["dist"], jax_want[2], rtol=0, atol=1e-7)
            for key, arr in zip(("ii", "jj", "dist"), want[:3], strict=True):
                assert z[key].tobytes() == np.asarray(arr).tobytes(), (name, key)
    # the store-less pod ring the members ran first: rows over gloo, the
    # JAX package's matrix and the port's one-device matrix on both
    rp = ring_pack()
    jax_single = np.array(jax_all_vs_all_mash(rp, k=21)[0])
    np.fill_diagonal(jax_single, 0.0)
    single = all_vs_all_mash(rp, k=21, device="cpu")[0]
    np.fill_diagonal(single, 0.0)
    for r in range(2):
        ring = np.load(str(tmp_path / f"m{r}.npz.ring.npy"))
        np.testing.assert_allclose(ring, jax_single, rtol=0, atol=1e-7)
        assert ring.tobytes() == single.tobytes()
