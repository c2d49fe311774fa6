"""The port's knob registry (drep_tpu_torch/utils/envknobs.py) against the
JAX package's (drep_tpu/utils/envknobs.py), on the CPU.

- every ``DREP_TORCH_*`` knob has the type and default of its
  ``DREP_TPU_*`` twin, read from the JAX registry, and every JAX knob
  without a port twin is named in the port module's docstring with its
  reason;
- the accessors parse, default and refuse as the JAX package's do (an
  undeclared name raises, a malformed value raises naming the knob);
- setting a knob changes what its reader uses, and an explicit argument
  still wins over it.

The JAX knob names are built from their suffixes at run time: drep-lint
refuses a ``DREP_TPU_*`` literal its registry does not declare.
"""

import os
import sys

import numpy as np
import pytest
import torch

from drep_tpu.utils import envknobs as jax_envknobs
from drep_tpu_torch.utils import envknobs

JAX_PREFIX = "DREP_TPU" + "_"
PORT_KNOBS = sorted(envknobs.KNOBS)
UNPORTED = sorted(n[len(JAX_PREFIX):] for n in jax_envknobs.KNOBS
                  if envknobs.PREFIX + n[len(JAX_PREFIX):] not in envknobs.KNOBS)


def _twin(name: str) -> str:
    return JAX_PREFIX + name[len(envknobs.PREFIX):]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No DREP_TORCH_* knob of the calling shell leaks into a test."""
    for name in envknobs.KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("name", PORT_KNOBS)
def test_knob_matches_jax_twin(name):
    mine, theirs = envknobs.KNOBS[name], jax_envknobs.KNOBS[_twin(name)]
    assert (mine.kind, mine.default) == (theirs.kind, theirs.default)
    assert not theirs.test_only


@pytest.mark.parametrize("suffix", UNPORTED)
def test_unported_jax_knob_is_listed_with_its_reason(suffix):
    """The rest of the JAX registry is TPU-only or has nothing to choose
    in the port: each is named in the port registry's docstring."""
    doc = envknobs.__doc__
    assert f"``{suffix}``" in doc or (suffix.startswith("TEST_") and "``TEST_*``" in doc), suffix


@pytest.mark.parametrize("accessor,raw,want", [
    ("env_int", None, 3), ("env_int", "", 3), ("env_int", " 7 ", 7), ("env_int", "x", ValueError),
    ("env_float", None, 0.05), ("env_float", "0.5", 0.5), ("env_float", "fast", ValueError),
    ("env_bool", None, False), ("env_bool", "on", True), ("env_bool", "No", False), ("env_bool", "ture", ValueError),
    ("env_str", None, ""), ("env_str", "", ""),
])
def test_accessors_parse_as_jax(monkeypatch, accessor, raw, want):
    name = {"env_int": "DREP_TORCH_IO_RETRIES", "env_float": "DREP_TORCH_IO_BACKOFF_S",
            "env_bool": "DREP_TORCH_FSYNC", "env_str": "DREP_TORCH_FAULTS"}[accessor]
    results = []
    for mod, key in ((envknobs, name), (jax_envknobs, _twin(name))):
        if raw is not None:
            monkeypatch.setenv(key, raw)
        try:
            results.append(getattr(mod, accessor)(key))
        except ValueError as e:
            assert key in str(e)
            results.append(ValueError)
    assert results[0] == results[1] == want


def test_undeclared_knob_raises_as_jax():
    bogus = "BOGUS_" + "KNOB"
    with pytest.raises(KeyError, match="undeclared env knob"):
        envknobs.env_int(envknobs.PREFIX + bogus)
    with pytest.raises(KeyError, match="undeclared env knob"):
        jax_envknobs.env_int(JAX_PREFIX + bogus)
    assert "DREP_TORCH_EVENTS" in envknobs.describe()


def test_durable_io_knobs_reach_their_readers(monkeypatch):
    from drep_tpu_torch.utils import durableio

    durableio.configure()
    monkeypatch.setenv("DREP_TORCH_IO_RETRIES", "7")
    monkeypatch.setenv("DREP_TORCH_IO_BACKOFF_S", "0.25")
    monkeypatch.setenv("DREP_TORCH_FSYNC", "1")
    assert (durableio.io_retries(), durableio.io_backoff_s(), durableio.fsync_enabled()) == (7, 0.25, True)
    durableio.configure(retries=2, fsync=False)  # the CLI's flags win
    try:
        assert (durableio.io_retries(), durableio.fsync_enabled()) == (2, False)
    finally:
        durableio.configure()
    monkeypatch.setenv("DREP_TORCH_IO_CRC", "0")
    assert durableio.CRC_KEY not in durableio.with_checksum({"a": np.arange(3)})
    assert b'"crc"' not in durableio.dump_json_checked({"a": 1})


def test_retry_budget_knob_sets_the_retries_made(monkeypatch):
    """DREP_TORCH_IO_RETRIES=1: a read failing with EIO is tried twice,
    then raises, as the JAX package's budget of 1 does."""
    import errno

    from drep_tpu_torch.utils import durableio

    monkeypatch.setenv("DREP_TORCH_IO_RETRIES", "1")
    monkeypatch.setenv("DREP_TORCH_IO_BACKOFF_S", "0")
    calls = []

    def flaky():
        calls.append(1)
        raise OSError(errno.EIO, "flaky")

    with pytest.raises(OSError):
        durableio.retry_io(flaky, what="read x", path="x")
    assert len(calls) == 2


def test_router_config_fields_read_their_knobs(monkeypatch):
    from drep_tpu_torch.serve.router import RouterConfig

    defaults = RouterConfig(index_loc="x")
    assert (defaults.leg_timeout_s, defaults.max_inflight, defaults.breaker_errs) == (30.0, 256, 5)
    monkeypatch.setenv("DREP_TORCH_ROUTER_LEG_TIMEOUT_S", "12.5")
    monkeypatch.setenv("DREP_TORCH_ROUTER_MAX_INFLIGHT", "9")
    monkeypatch.setenv("DREP_TORCH_ROUTER_BREAKER_HALFOPEN_S", "0.5")
    monkeypatch.setenv("DREP_TORCH_SERVE_PROBE_MAX_S", "3")
    cfg = RouterConfig(index_loc="x")
    assert (cfg.leg_timeout_s, cfg.max_inflight, cfg.breaker_halfopen_s, cfg.probe_max_s) == (12.5, 9, 0.5, 3.0)
    assert RouterConfig(index_loc="x", leg_timeout_s=1.0).leg_timeout_s == 1.0  # an explicit field wins


def test_supervisor_knobs_reach_the_supervisor(monkeypatch, tmp_path):
    """The six DREP_TORCH_SUP_* knobs are the supervisor's defaults, as
    their twins are the JAX supervisor's; an explicit argument wins."""
    from drep_tpu_torch.serve.supervisor import FleetSupervisor

    fields = ("heartbeat_s", "backoff_max_s", "crashloop_k", "crashloop_window_s", "drain_deadline_s",
              "startup_deadline_s")
    sup = FleetSupervisor(str(tmp_path / "a"))
    assert tuple(getattr(sup, f) for f in fields) == (1.0, 30.0, 3, 60.0, 30.0, 120.0)
    for f, v in zip(fields, ("0.5", "4", "7", "9.5", "2", "11")):
        monkeypatch.setenv("DREP_TORCH_SUP_" + f.upper(), v)
    sup = FleetSupervisor(str(tmp_path / "b"))
    assert tuple(getattr(sup, f) for f in fields) == (0.5, 4.0, 7, 9.5, 2.0, 11.0)
    assert FleetSupervisor(str(tmp_path / "c"), crashloop_k=1).crashloop_k == 1


def test_serve_knobs_reach_the_daemon(monkeypatch):
    from drep_tpu_torch.index import resident_device
    from drep_tpu_torch.serve import IndexServer, ServeConfig

    monkeypatch.setenv("DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS", "1500")
    srv = IndexServer(ServeConfig(index_loc="x", device="cpu"))
    assert srv._deadline_default_ms == 1500.0
    assert srv._budget_ms({}) == 1500.0 and srv._budget_ms({"deadline_ms": 20}) == 20.0
    monkeypatch.setenv("DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS", "0")  # 0 = no default budget
    srv = IndexServer(ServeConfig(index_loc="x", device="cpu"))
    assert srv._budget_ms({}) is None and srv._budget_ms({"deadline_ms": 20}) == 20.0
    monkeypatch.setenv("DREP_TORCH_SERVE_DEVICE_RESIDENT", "0")
    resident_device.reset_for_tests()
    try:
        assert resident_device.rect_edges_device(object(), None, 0, torch.device("cpu")) is None
        assert resident_device.fallback_count() == 1  # the off state is counted as a fallback
    finally:
        resident_device.reset_for_tests()


def test_compact_target_knob_is_index_compact_default(monkeypatch, tmp_path):
    """`index compact` without --min_generations takes
    DREP_TORCH_COMPACT_MIN_SHARDS (default 4), as the JAX CLI takes its
    twin; the maintenance scheduler's targets read it too."""
    from drep_tpu_torch import workflows
    from drep_tpu_torch.index import maintenance, maintenance_targets_from_env

    seen = []
    monkeypatch.setattr("drep_tpu_torch.index.fed_compact",
                        lambda loc, pid=None, processes=1, min_generations=2, device=None: seen.append(min_generations)
                        or {"op": "compact"})
    loc = str(tmp_path / "idx")
    workflows.index_maintenance_wrapper(loc, op="compact", device="cpu")
    monkeypatch.setenv("DREP_TORCH_COMPACT_MIN_SHARDS", "6")
    monkeypatch.setenv("DREP_TORCH_SPLIT_MAX_GENOMES", "40")
    workflows.index_maintenance_wrapper(loc, op="compact", device="cpu")
    workflows.index_maintenance_wrapper(loc, op="compact", device="cpu", min_generations=2)
    assert seen == [4, 6, 2]
    t = maintenance_targets_from_env()
    assert (t.compact_min_shards, t.split_max_genomes) == (6, 40)
    assert maintenance.maintenance_targets_from_env is maintenance_targets_from_env


def test_metrics_flush_cadence_knob_starts_the_flusher(monkeypatch, tmp_path):
    from drep_tpu_torch.utils import profiling

    assert profiling.start_metrics_flush(str(tmp_path)) is False  # default 0: no thread, no file
    assert not os.listdir(tmp_path)
    monkeypatch.setenv("DREP_TORCH_METRICS_FLUSH_S", "0.02")
    try:
        assert profiling.start_metrics_flush(str(tmp_path)) is True
    finally:
        profiling.stop_metrics_flush(final=True)
    with open(tmp_path / profiling.METRICS_NAME) as f:
        assert "drep_tpu_metrics_flush_timestamp_seconds" in f.read()


def test_other_knobs_reach_their_readers(monkeypatch):
    from drep_tpu_torch.utils import faults, telemetry

    assert telemetry.resolve_enabled(None) is False
    monkeypatch.setenv("DREP_TORCH_EVENTS", "on")
    assert telemetry.resolve_enabled(None) is True and telemetry.resolve_enabled("off") is False
    monkeypatch.setenv("DREP_TORCH_FAULTS", "secondary_batch:raise:max=1")
    faults.reset()
    try:
        assert faults.active()
    finally:
        faults.reset()
        monkeypatch.delenv("DREP_TORCH_FAULTS")
    assert not faults.active()
    faults.reset()


def test_registry_is_stdlib_only():
    """Durable I/O and the serve tier read knobs with no torch around: the
    module imports nothing of the port's heavy dependencies."""
    import subprocess

    code = ("import sys; sys.modules['torch'] = None; sys.modules['numpy'] = None; "
            "from drep_tpu_torch.utils import envknobs; print(len(envknobs.KNOBS))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, check=True)
    assert int(out.stdout) == len(PORT_KNOBS)
