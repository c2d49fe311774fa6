"""The port's fault layer (drep_tpu_torch/utils/faults.py,
parallel/faulttol.py, the retry and fsync parts of utils/durableio.py)
against the JAX package's (drep_tpu/utils/faults.py,
drep_tpu/parallel/faulttol.py, drep_tpu/utils/durableio.py), and the
single-process cases of tests/test_chaos.py on the port's streaming walk.

- a spec parses to the same rules and fires on the same calls in both
  registries; the modes and sites of later items are refused naming them;
- injected stripe failures retry to completion with edges bit-identical
  to a clean walk; an injected hang trips the watchdog; spent retries
  raise FaultTolError, where the JAX package would recompute the tile on
  the host;
- AutoTimeout derives the JAX package's deadline from the same
  latencies, and the streaming walk reports it as a gauge;
- torn, zero-byte and truncated stripe shards are recomputed on resume;
- --io_retries rides out EIO/ESTALE and stops at ENOSPC, --fsync
  fsyncs; payload bytes equal the JAX package's;
- the CLI flags reach the cluster stage's _ft_config, and the kernel
  warmup beside ingest raises its build error after the join.
"""

import errno
import json
import logging
import os
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from drep_tpu.parallel import faulttol as jax_faulttol
from drep_tpu.parallel import streaming as jax_streaming
from drep_tpu.utils import durableio as jax_durableio
from drep_tpu.utils import faults as jax_faults
from drep_tpu.ops.minhash import PackedSketches as JaxPacked
from drep_tpu_torch.ops.minhash import PAD_ID, PackedSketches
from drep_tpu_torch.parallel import faulttol, streaming
from drep_tpu_torch.parallel.faulttol import FaultTolConfig, FaultTolError, retrying_call
from drep_tpu_torch.utils import durableio, faults
from drep_tpu_torch.utils.logger import get_logger
from drep_tpu_torch.utils.profiling import counters

CPU = torch.device("cpu")
BLOCK = 128


@pytest.fixture(autouse=True)
def _clean():
    """Injection off, counters and durable-I/O knobs reset, before and
    after every test, in both packages; one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (faults, jax_faults):
        mod.configure(None)
    counters.reset()
    durableio.configure()
    jax_durableio.configure()
    yield
    for mod in (faults, jax_faults):
        mod.configure(None)
    counters.reset()
    durableio.configure()
    jax_durableio.configure()
    torch.set_num_threads(n)


@contextmanager
def _capture_log(level=logging.WARNING):
    records: list[logging.LogRecord] = []

    class H(logging.Handler):
        def emit(self, record):
            records.append(record)

    h = H(level=level)
    logger = get_logger()
    old = logger.level
    logger.setLevel(min(level, old) if old else level)
    logger.addHandler(h)
    try:
        yield records
    finally:
        logger.removeHandler(h)
        logger.setLevel(old)


def _packed(n=600, s=16, pools=20, seed=0):
    """(port pack, JAX pack): genomes drawn from `pools` id pools, so
    genomes of a pool are near and pools far apart."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, s), PAD_ID, dtype=np.int32)
    cts = np.full(n, s, dtype=np.int32)
    pool_ids = [np.sort(rng.choice(2**20, size=s * 2, replace=False).astype(np.int32)) for _ in range(pools)]
    for i in range(n):
        ids[i] = np.sort(rng.choice(pool_ids[i % pools], size=s, replace=False))
    names = [f"g{i}" for i in range(n)]
    return PackedSketches(ids=ids, counts=cts, names=names), JaxPacked(ids=ids, counts=cts, names=names)


def _walk(packed, **kw):
    return streaming.streaming_mash_edges(packed, k=21, cutoff=0.3, block=BLOCK, device=CPU, **kw)


def _assert_edges_identical(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# --- the registry --------------------------------------------------------

# (spec, what each call polls): every field of the grammar
REGISTRY_SPECS = [
    ("streaming_tile:raise:0.3:seed=7", "fire"),
    ("streaming_tile:raise:1.0:skip=3:max=2", "fire"),
    ("streaming_tile:raise:0.5:seed=3:device=1", "fire"),
    ("secondary_batch:raise:0.4:seed=11:max=5", "fire"),
    ("secondary_batch:raise:0.5:seed=1,streaming_tile:raise:0.2:seed=9", "fire"),
    ("io:io_error:0.5:seed=2:path=row_", "write"),
    ("io:stale_read:1.0:skip=1:max=3", "read"),
    ("io:enospc:0.6:seed=4:max=4", "write"),
    ("io:io_error:1.0:proc=7", "write"),
    ("io:io_error:0.7:proc=0:seed=5", "read"),
    ("shard_write:torn:0.5:seed=5:path=.e01", "torn"),
    ("io:corrupt:1.0:path=.e01:max=2", "corrupt"),
]


def _fired(mod, spec: str, poll: str, calls: int = 48) -> list[tuple[int, str]]:
    """(call index, what fired) over `calls` polls of one registry; the
    calls alternate devices 0/1, two sites and two paths."""
    mod.configure(spec)
    out = []
    for i in range(calls):
        path = f"/store/row_{i:05d}" + (".e01.npz" if i % 3 == 0 else ".npz")
        try:
            if poll == "fire":
                mod.fire("streaming_tile" if i % 4 else "secondary_batch", device=i % 2)
            elif poll in ("read", "write"):
                mod.fire_io(poll, path=path)
            elif poll == "torn":
                if mod.torn_write(path=path):
                    out.append((i, "torn"))
            elif mod.corrupt_write(path=path):
                out.append((i, "corrupt"))
        except (mod.InjectedFault, OSError) as e:
            out.append((i, type(e).__name__ + str(getattr(e, "errno", ""))))
    return out


def _rule_fields(rule) -> tuple:
    return (rule.site, rule.mode, rule.prob, rule.seed, rule.secs, rule.device, rule.proc, rule.skip,
            rule.max_fires, rule.path_sub)


@pytest.mark.parametrize("spec,poll", REGISTRY_SPECS)
def test_spec_parses_and_fires_as_jax(spec, poll):
    got = {site: [_rule_fields(r) for r in rules] for site, rules in faults._parse(spec).items()}
    want = {site: [_rule_fields(r) for r in rules] for site, rules in jax_faults._parse(spec).items()}
    assert got == want
    fired = _fired(faults, spec, poll)
    assert fired == _fired(jax_faults, spec, poll)
    assert bool(fired) == ("proc=7" not in spec)


@pytest.mark.parametrize("spec", [
    "process_death:kill",
    "ring_step:drain",
    "process_death:drain",
    "ring_dispatch:raise",
    "autoscale_decide:raise",
    "barrier:sleep",
    "allgather:hang",
])
def test_pod_modes_and_sites_parse_as_jax(spec):
    """The elastic pod's sites and its drain mode, and the pod autoscaling
    controller's site, parse into the JAX package's rules."""
    want = {site: [_rule_fields(r) for r in rules] for site, rules in jax_faults._parse(spec).items()}
    got = {site: [_rule_fields(r) for r in rules] for site, rules in faults._parse(spec).items()}
    assert got == want and got


@pytest.mark.parametrize("spec", ["autoscale_decide:drain", "autoscale_decide:torn", "autoscale_decide:io_error",
                                  "autoscale_decide:raise:path=x"])
def test_autoscale_decide_refuses_modes_without_semantics_as_jax(spec):
    """A mode the controller's site never acts on is refused at parse time,
    in both packages."""
    for mod in (faults, jax_faults):
        with pytest.raises(mod.FaultSpecError):
            mod._parse(spec)


def test_autoscale_decide_kill_ends_the_controller_on_its_third_tick(tmp_path):
    """``autoscale_decide:kill:skip=2`` SIGKILLs the controller as its third
    tick starts, in both packages' CLIs: two decision records, no third."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    seen = []
    for name, argv, env_name in (
            ("torch", [sys.executable, "-m", "drep_tpu_torch.autoscale"], "DREP_TORCH_FAULTS"),
            ("jax", [sys.executable, os.path.join(root, "tools", "pod_autoscale.py")], "DREP_TPU_FAULTS")):
        log = tmp_path / f"{name}.jsonl"
        env = {k: v for k, v in os.environ.items() if not k.startswith(("DREP_TORCH_", "DREP_TPU_"))}
        env.update({env_name: "autoscale_decide:kill:skip=2", "JAX_PLATFORMS": "cpu",
                    "PYTHONPATH": root + os.pathsep + env.get("PYTHONPATH", "")})
        res = subprocess.run([*argv, str(ckpt), "--deadline", "60", "--interval", "0.05", "--count", "5",
                              "--decision_log", str(log)], env=env, cwd=root, capture_output=True, text=True,
                             timeout=120)
        with open(log) as f:
            seen.append((res.returncode, [json.loads(line)["reason"] for line in f]))
    assert seen[0] == seen[1] == (-9, ["no-live-members", "no-live-members"]), seen
    assert not os.listdir(ckpt)


@pytest.mark.parametrize("spec", [
    "wire:reset", "wire:garble:path=replica0", "wire:stall:secs=2:max=1", "supervisor_tick:raise",
    "supervisor_spawn:kill:skip=1", "streaming_tile:kill:0.5",
])
def test_supervision_wire_and_kill_specs_parse_as_jax(spec):
    """The fleet supervisor's sites, the wire site with its modes and
    ``path=`` peer labels, and the kill mode (ported with the supervisor)
    parse into the JAX package's rules."""
    got = {site: [_rule_fields(r) for r in rules] for site, rules in faults._parse(spec).items()}
    want = {site: [_rule_fields(r) for r in rules] for site, rules in jax_faults._parse(spec).items()}
    assert got == want and got


# the unknown site and mode are built by concatenation: drep-lint's
# fault-site rule rejects such spec literals anywhere in the tree
@pytest.mark.parametrize("spec", [
    "not_a_site" + ":raise", "streaming_tile:" + "not_a_mode", "streaming_tile:raise:0.5:bogus=1",
    "secondary_batch:enospc", "secondary_batch:torn", "io:torn", "streaming_tile:raise:path=x",
    "streaming_tile", "io:kill", "secondary_batch:garble", "wire:raise", "supervisor_tick:raise:path=x",
])
def test_malformed_specs_raise_as_jax(spec):
    with pytest.raises(jax_faults.FaultSpecError):
        jax_faults.configure(spec)
    with pytest.raises(faults.FaultSpecError):
        faults.configure(spec)


def test_env_activation_and_zero_cost_when_unset(monkeypatch):
    monkeypatch.setenv(faults.ENV, "streaming_tile:raise:1.0")
    faults.reset()
    assert faults.active()
    with pytest.raises(faults.InjectedFault):
        faults.fire("streaming_tile", device=0)
    assert counters.faults["injected_streaming_tile_raise"] == 1
    monkeypatch.delenv(faults.ENV)
    faults.reset()
    assert not faults.active() and faults._RULES == {}
    faults.fire("streaming_tile", device=0)  # no rule: a no-op


# --- retries and the watchdog -----------------------------------------


def test_injected_stripe_failures_retry_to_completion():
    """test_chaos.py:234: edges bit-identical to a clean walk, honest
    counters; every injected raise costs the launch it follows."""
    tp, _ = _packed()
    want = _walk(tp)
    counters.reset()
    faults.configure("streaming_tile:raise:0.4:seed=7")
    got = _walk(tp, ft_config=FaultTolConfig())
    _assert_edges_identical(got, want)
    assert got[3] == want[3]
    fired = counters.faults["injected_streaming_tile_raise"]
    assert fired > 0 and counters.faults["retries"] == fired
    assert streaming.STATS["launches"] == streaming.STATS["stripes"] + fired
    assert counters.report()["fault_tolerance"]["retries"] == fired


@pytest.mark.parametrize("fire", [True, False])
def test_retrying_call_fires_its_site_before_the_call_or_leaves_it_to_fn(fire):
    """With ``fire`` the site fires before each attempt (a secondary
    engine call: an injected raise costs no call); without it `fn` fires
    the site itself after its work (a streaming stripe: the raise costs
    the launch it follows). Either way one retry completes the call."""
    faults.configure("streaming_tile:raise:1.0:max=1")
    calls = []

    def fn():
        calls.append(1)
        if not fire:
            faults.fire("streaming_tile", device=0)
        return 7

    assert retrying_call(fn, site="streaming_tile", config=FaultTolConfig(max_retries=1), fire=fire) == 7
    assert len(calls) == (1 if fire else 2)
    assert counters.faults["retries"] == 1 and counters.faults["injected_streaming_tile_raise"] == 1


def test_watchdog_trips_on_injected_hang():
    """test_chaos.py:274: a hung stripe trips the watchdog; the retry
    launches again and the edges are the clean walk's."""
    tp, _ = _packed(n=300)
    want = _walk(tp)
    counters.reset()
    faults.configure("streaming_tile:hang:1.0:secs=5:max=1")
    got = _walk(tp, ft_config=FaultTolConfig(dispatch_timeout_s=0.5))
    _assert_edges_identical(got, want)
    assert counters.faults["watchdog_trips"] == 1 and counters.faults["retries"] == 1
    assert streaming.STATS["launches"] == streaming.STATS["stripes"] + 1


def test_spent_retries_raise_instead_of_cpu_fallback():
    """In place of test_chaos.py:287: where the JAX package recomputes
    every tile on the host once its retries are spent, the port raises
    FaultTolError after 1 + max_retries launches of the first stripe."""
    tp, jp = _packed(n=256)
    want = jax_streaming.streaming_mash_edges(jp, k=21, cutoff=0.3, block=BLOCK)
    spec = "streaming_tile:raise:1.0"
    jax_faults.configure(spec)
    got_jax = jax_streaming.streaming_mash_edges(
        jp, k=21, cutoff=0.3, block=BLOCK, ft_config=jax_faulttol.FaultTolConfig(max_retries=1, backoff_s=0.0))
    np.testing.assert_array_equal(got_jax[0], want[0])  # the JAX package fell back to the host
    faults.configure(spec)
    with pytest.raises(FaultTolError, match="streaming_tile: failed after 2 attempts"):
        _walk(tp, ft_config=FaultTolConfig(max_retries=1))
    assert counters.faults["injected_streaming_tile_raise"] == 2 and counters.faults["retries"] == 1
    assert "cpu_fallback_tiles" not in counters.faults


def test_retrying_call_exhaustion_raises_faulttol_error():
    """test_chaos.py:363, and the same attempts as the JAX package's."""
    faults.configure("secondary_batch:raise:1.0")
    with pytest.raises(FaultTolError, match="secondary_batch"):
        retrying_call(lambda: 1, site="secondary_batch", config=FaultTolConfig(max_retries=1))
    assert counters.faults["injected_secondary_batch_raise"] == 2
    faults.configure("secondary_batch:raise:1.0:max=1")
    assert retrying_call(lambda: 42, site="secondary_batch", config=FaultTolConfig(max_retries=1)) == 42
    assert counters.faults["retries"] == 2
    calls = []
    cfg = FaultTolConfig(dispatch_timeout_s=0.5, max_retries=1)
    faults.configure("secondary_batch:hang:1.0:secs=3:max=1")
    assert retrying_call(lambda: calls.append(1) or 7, site="secondary_batch", config=cfg) == 7
    assert calls == [1] and counters.faults["watchdog_trips"] == 1


def test_auto_timeout_derives_jax_deadline():
    """test_chaos.py:600 and :865: the same constants, and the same
    deadline from the same latencies, under each config."""
    for name in ("AUTO_TIMEOUT_MULT", "AUTO_TIMEOUT_FLOOR_S", "AUTO_TIMEOUT_WARMUP", "AUTO_TIMEOUT_MIN_SAMPLES",
                 "AUTO_TIMEOUT_WARMUP_CAP_S"):
        assert getattr(faulttol, name) == getattr(jax_faulttol, name)
    rng = np.random.default_rng(0)
    waits = np.concatenate([rng.uniform(0.5, 20.0, 10), rng.uniform(0.001, 4.0, 80)])
    for cfg in ({"auto_timeout": True}, {"dispatch_timeout_s": 2.0, "auto_timeout": True}, {}):
        mine = faulttol.AutoTimeout(FaultTolConfig(**cfg))
        theirs = jax_faulttol.AutoTimeout(jax_faulttol.FaultTolConfig(**cfg))
        for dt in waits:
            assert (mine.effective(), mine.derived()) == (theirs.effective(), theirs.derived())
            mine.note(float(dt))
            theirs.note(float(dt))
        assert (mine.effective(), mine.derived()) == (theirs.effective(), theirs.derived())
    auto = faulttol.AutoTimeout(FaultTolConfig(auto_timeout=True))
    assert auto.derived() is None and auto.effective() == faulttol.AUTO_TIMEOUT_WARMUP_CAP_S
    for _ in range(faulttol.AUTO_TIMEOUT_WARMUP + 8):  # each call noted under the watchdog
        retrying_call(lambda: 1, site="streaming_tile", config=auto.config, auto=auto)
    assert auto.derived() == faulttol.AUTO_TIMEOUT_FLOOR_S
    assert "watchdog_trips" not in counters.faults


def test_streaming_reports_derived_watchdog_gauge():
    """test_chaos.py:635: 13 stripes, enough samples past the warmup."""
    tp, _ = _packed(n=1600)
    _walk(tp, ft_config=FaultTolConfig(auto_timeout=True))
    assert streaming.STATS["stripes"] >= faulttol.AUTO_TIMEOUT_WARMUP + faulttol.AUTO_TIMEOUT_MIN_SAMPLES
    assert counters.gauges["derived_dispatch_timeout_s"] == faulttol.AUTO_TIMEOUT_FLOOR_S
    assert "watchdog_trips" not in counters.faults


def test_torn_shard_write_is_recomputed_on_resume(tmp_path):
    """test_chaos.py:307."""
    tp, _ = _packed(n=600)
    ck = str(tmp_path / "ckpt")
    faults.configure("shard_write:torn:1.0:max=2")
    r1 = _walk(tp, checkpoint_dir=ck)
    faults.configure(None)
    assert counters.faults["injected_shard_write_torn"] == 2
    with _capture_log() as records:
        r2 = _walk(tp, checkpoint_dir=ck)
    _assert_edges_identical(r2, r1)
    assert sum("corrupt shard" in r.getMessage() for r in records) == 2
    assert 0 < r2[3] < r1[3] and counters.faults["corrupt_shards_healed"] == 2
    r3 = _walk(tp, checkpoint_dir=ck)
    assert r3[3] == 0
    _assert_edges_identical(r3, r1)


def test_zero_byte_and_truncated_row_shards_heal_on_resume(tmp_path):
    """test_chaos.py:891: planted on disk, no registry."""
    tp, _ = _packed(n=600)
    ck = str(tmp_path / "ckpt")
    r1 = _walk(tp, checkpoint_dir=ck)
    shards = sorted(f for f in os.listdir(ck) if f.startswith("row_"))
    zero, trunc = os.path.join(ck, shards[0]), os.path.join(ck, shards[2])
    open(zero, "wb").close()
    data = open(trunc, "rb").read()
    with open(trunc, "wb") as f:
        f.write(data[: len(data) // 3])
    counters.reset()
    r2 = _walk(tp, checkpoint_dir=ck)
    _assert_edges_identical(r2, r1)
    redone = sum(streaming._real_pairs_in_tile(bi * BLOCK, bj * BLOCK, BLOCK, tp.n)
                 for bi in (0, 2) for bj in range(bi, 5))
    assert r2[3] == redone and counters.faults["corrupt_shards_healed"] == 2
    assert _walk(tp, checkpoint_dir=ck)[3] == 0


# --- durable I/O ---------------------------------------------------------


def test_io_retries_ride_out_transient_errors(tmp_path):
    """test_chaos.py:988: EIO on publish and ESTALE at resume retried,
    counted; a budget of 1 against 2 injected errors raises and books
    io_unrecoverable; the counts match the JAX package's."""
    tp, _ = _packed(n=300)
    want = _walk(tp)
    ck = str(tmp_path / "ckpt")
    faults.configure("io:io_error:1.0:max=2")
    r1 = _walk(tp, checkpoint_dir=ck)
    _assert_edges_identical(r1, want)
    assert counters.faults["io_retries"] == 2 and counters.faults["injected_io_io_error"] == 2
    counters.reset()
    faults.configure("io:stale_read:1.0:max=1")
    r2 = _walk(tp, checkpoint_dir=ck)
    assert r2[3] == 0 and counters.faults["io_retries"] == 1
    durableio.configure(retries=1)
    faults.configure("io:io_error:1.0:max=2")
    with pytest.raises(OSError) as ei:
        durableio.atomic_savez(str(tmp_path / "x.npz"), a=np.arange(3))
    assert ei.value.errno == errno.EIO and counters.faults["io_unrecoverable"] == 1
    # the same spec and budget in the JAX package: the same outcome
    from drep_tpu.utils.profiling import counters as jax_counters

    jax_counters.reset()
    jax_durableio.configure(retries=1)
    jax_faults.configure("io:io_error:1.0:max=2")
    with pytest.raises(OSError):
        jax_durableio.atomic_savez(str(tmp_path / "y.npz"), a=np.arange(3))
    assert jax_counters.faults["io_unrecoverable"] == 1 and jax_counters.faults["io_retries"] == 1
    jax_counters.reset()


def test_enospc_degrades_into_actionable_store_full_error(tmp_path):
    """test_chaos.py:1032: never retried; names the store and the bytes."""
    tp, _ = _packed(n=300)
    faults.configure("io:enospc:1.0")
    with pytest.raises(durableio.StoreFullError, match="ENOSPC") as ei:
        _walk(tp, checkpoint_dir=str(tmp_path / "ckpt"))
    assert str(tmp_path) in str(ei.value) and "bytes" in str(ei.value)
    assert "io_retries" not in counters.faults


def test_fsync_calls_fsync_and_payload_bytes_equal_jax(tmp_path, monkeypatch):
    """--fsync: the tmp file and its directory fsynced around each
    publish; the published npz bytes are the JAX package's."""
    synced = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd) or real(fd))
    arrays = {"ii": np.arange(5, dtype=np.int64), "dist": np.linspace(0, 1, 5, dtype=np.float32)}
    durableio.atomic_savez(str(tmp_path / "a.npz"), **arrays)
    assert synced == []
    durableio.configure(fsync=True)
    assert durableio.fsync_enabled()
    durableio.atomic_savez(str(tmp_path / "b.npz"), **arrays)
    assert len(synced) == 2  # the file, then its directory
    jax_durableio.atomic_savez(str(tmp_path / "c.npz"), **arrays)
    for name in ("a.npz", "b.npz"):
        assert (tmp_path / name).read_bytes() == (tmp_path / "c.npz").read_bytes()
    durableio.configure()
    assert not durableio.fsync_enabled() and durableio.io_retries() == durableio.DEFAULT_IO_RETRIES


def test_corrupt_publish_detected_by_checksum(tmp_path):
    """io:corrupt flips a bit after the publish; the reader classifies
    it corrupt (recompute and heal), as the JAX package's does."""
    faults.configure("io:corrupt:1.0:max=1")
    p = str(tmp_path / "row_00000.npz")
    durableio.atomic_savez(p, ii=np.arange(64, dtype=np.int64))
    with pytest.raises(durableio.CorruptPayloadError):
        durableio.load_npz_checked(p)
    with pytest.raises(jax_durableio.CorruptPayloadError):
        jax_durableio.load_npz_checked(p)


# --- the CLI -------------------------------------------------------------


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags,want", [
    ([], FaultTolConfig(max_retries=2, dispatch_timeout_s=0.0, auto_timeout=True)),
    (["--fault_retries", "5", "--dispatch_timeout", "12.5"],
     FaultTolConfig(max_retries=5, dispatch_timeout_s=12.5, auto_timeout=False)),
    (["--dispatch_timeout", "-1", "--io_retries", "4", "--fsync", "--no_overlap_ingest"],
     FaultTolConfig(max_retries=2, dispatch_timeout_s=0.0, auto_timeout=False)),
])
def test_cli_flags_reach_ft_config(tmp_path, genome_paths, monkeypatch, flags, want):
    """The flags that now run parse and reach _ft_config, which installs
    the executor default and the durable-I/O policy."""
    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.controller import main as torch_main

    got = {}
    real = controller._ft_config

    def spy(kw):
        got["cfg"] = real(kw)
        got["io"] = (durableio.io_retries(), durableio.fsync_enabled())
        got["overlap"] = kw["overlap_ingest"]
        raise _Stop

    monkeypatch.setattr(controller, "_ft_config", spy)
    try:
        with pytest.raises(_Stop):
            torch_main(["compare", str(tmp_path / "wd"), "-g", *genome_paths, "--device", "cpu", "--skip_plots",
                        *flags])
        assert got["cfg"] == want and faulttol.DEFAULT_CONFIG == want
        assert got["io"] == ((4, True) if "--fsync" in flags else (3, False))
        assert got["overlap"] == ("--no_overlap_ingest" not in flags)
    finally:
        faulttol.configure_defaults(FaultTolConfig())


@pytest.mark.parametrize("flag,item", [
    (["--max_dead_processes", "2"], ("max_dead_processes", 2)), (["--max_joins", "1"], ("max_joins", 1)),
    (["--drain_grace_s", "5"], ("drain_grace_s", 5.0)),
])
def test_cli_pod_and_tracing_flags_still_raise(tmp_path, genome_paths, monkeypatch, flag, item):
    """The elastic pod's flags, once refused, now run: each reaches
    _ft_config with its value, which builds the JAX package's config
    (--drain_grace_s arms the drain handler instead)."""
    import dataclasses

    from drep_tpu.parallel.faulttol import FaultTolConfig as JaxFaultTolConfig
    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.controller import main as torch_main

    got = {}
    real = controller._ft_config
    graces = []
    monkeypatch.setattr(controller, "install_drain_handler", graces.append)

    def spy(kw):
        got["kw"], got["cfg"] = kw, real(kw)
        raise _Stop

    monkeypatch.setattr(controller, "_ft_config", spy)
    try:
        with pytest.raises(_Stop):
            torch_main(["compare", str(tmp_path / "wd"), "-g", *genome_paths, "--device", "cpu", *flag])
    finally:
        faulttol.configure_defaults(FaultTolConfig())
    key, value = item
    assert got["kw"][key] == value
    mine = dataclasses.asdict(got["cfg"])
    want = dataclasses.asdict(JaxFaultTolConfig(
        max_retries=2, dispatch_timeout_s=0.0, auto_timeout=True,
        **({key: value} if key != "drain_grace_s" else {})))
    assert mine == want
    assert graces == [value if key == "drain_grace_s" else 30.0]


def test_kernel_warmup_starts_only_where_it_helps_and_raises_its_error(tmp_path, genome_paths, monkeypatch):
    """--no_overlap_ingest's counterpart: the warmup thread starts only
    for a cuda device with sketching to do; a failed kernel build is
    raised after ingest, never swallowed."""
    from drep_tpu_torch.cluster import controller
    from drep_tpu_torch.ingest import make_bdb
    from drep_tpu_torch.ops import _build
    from drep_tpu_torch.workdir import WorkDirectory

    built = []
    monkeypatch.setattr(_build, "build_all", lambda: built.append(1) or (_ for _ in ()).throw(
        RuntimeError("nvcc failed on csrc/mash_shared.cu")))
    bdb = make_bdb(genome_paths)
    wd = WorkDirectory(str(tmp_path / "wd"))
    kw = controller._fill_defaults({})
    cuda = torch.device("cuda")
    assert controller._start_kernel_warmup({**kw, "device": CPU}, wd, bdb) is None
    assert controller._start_kernel_warmup({**kw, "device": cuda, "overlap_ingest": False}, wd, bdb) is None
    warm = controller._start_kernel_warmup({**kw, "device": cuda}, wd, bdb)
    warm.join()
    assert built == [1]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        warm.raise_error()

    # through d_cluster_wrapper: ingest completes, then the build error
    monkeypatch.setattr(controller, "resolve_device", lambda device: cuda)
    monkeypatch.setattr(controller, "_resolve_estimator_for_run", lambda n, kw: "sort")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        controller.d_cluster_wrapper(wd, bdb)
    assert wd.has_arrays("sketches") and built == [1, 1]
    # a cached ingest has nothing to hide the build behind: no thread
    assert controller._start_kernel_warmup({**kw, "device": cuda}, wd, bdb) is None


def test_cli_refuses_a_malformed_env_spec_before_writing(tmp_path, genome_paths, monkeypatch):
    """A DREP_TORCH_FAULTS spec the port cannot run raises FaultSpecError
    before the workdir is made, naming what it cannot parse."""
    from drep_tpu_torch.controller import main as torch_main

    # the unknown mode built by concatenation, as above
    monkeypatch.setenv(faults.ENV, "autoscale_decide:" + "bogus_mode")
    faults.reset()
    wd = tmp_path / "wd"
    try:
        with pytest.raises(faults.FaultSpecError, match="bogus_mode"):
            torch_main(["compare", str(wd), "-g", *genome_paths, "--device", "cpu", "--skip_plots"])
    finally:
        faults.reset()
    assert not wd.exists()


def test_cli_runs_under_an_autoscale_decide_spec(tmp_path, genome_paths, monkeypatch):
    """An ``autoscale_decide`` spec no longer stops a run: `compare` parses
    it, fires it nowhere and writes its tables."""
    from drep_tpu_torch.controller import main as torch_main

    monkeypatch.setenv(faults.ENV, "autoscale_decide:kill:skip=2")
    faults.reset()
    wd = tmp_path / "wd"
    try:
        torch_main(["compare", str(wd), "-g", *genome_paths, "--device", "cpu", "--skip_plots"])
    finally:
        faults.reset()
    assert (wd / "data_tables" / "Cdb.csv").exists()
