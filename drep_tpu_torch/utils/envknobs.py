"""Registry of every ``DREP_TORCH_*`` environment knob.

Counterpart of drep_tpu/utils/envknobs.py. Every knob the port reads is
declared once here (name, type, default, one-line doc) and read through a
typed accessor (:func:`env_str`, :func:`env_int`, :func:`env_float`,
:func:`env_bool`); reading an undeclared name raises, so a typo'd export
is an error rather than a silent no-op. Each knob is the twin of the JAX
package's ``DREP_TPU_*`` knob of the same suffix, with its type and
default. An explicit CLI flag or constructor argument wins over the
knob, as in the JAX package.

Accessor semantics (the JAX package's):

- unset        -> the declared default (a per-call ``default`` wins);
- empty/blank  -> the declared default (int/float/bool; ``env_str``
  returns the raw value, so a spec-string knob keeps "" == off);
- bool strings -> ``1/true/on/yes`` are True, ``0/false/off/no`` are
  False; anything else raises ``ValueError`` naming the knob;
- int/float    -> ``int()``/``float()``; a malformed value raises
  ``ValueError`` naming the knob.

Knobs of the JAX package the port does not declare, and why:

- TPU only (no path of the port reads them): ``PALLAS_INDICATOR``,
  ``PALLAS_RING``, ``RING_COMM``, ``RING_MONOLITHIC``, ``RING_VMEM_MB``,
  ``MASH_ROWS_PER_ITER`` and ``TEST_CPU_DEVICES``;
- ``GREEDY_MATMUL``: the port's greedy secondary has one route, the
  rectangular indicator product (``csrc/indicator_mm.cu``), so there is
  no gather path to force it off;
- ``INDICATOR_DTYPE``: the fused indicator kernel accumulates int8
  products in int32, one dtype, so there is nothing to force;
- ``RING_VARIANT``: ``ops/ring.py::pick_variant`` chooses a containment
  ring's step from its v_pad and width, so there is nothing to pin;
- ``NO_NATIVE``: the native library's Python paths already run where no
  compiler is present, and the two paths are equal;
- ``WIRE_CRC``: the port's receivers accept frames without a CRC (a JAX
  daemon's with its CRC off), so interoperation needs no switch;
- the chaos harness's ``TEST_*``, which configure the JAX package's
  test workers only.

Stdlib only: durable I/O, the serve tier and the autoscale tools read
knobs with no torch around.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["Knob", "KNOBS", "env_str", "env_int", "env_float", "env_bool", "knob", "describe"]

PREFIX = "DREP_TORCH_"


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "str" | "int" | "float" | "bool"
    default: object
    doc: str


KNOBS: dict[str, Knob] = {}


def _declare(name: str, kind: str, default, doc: str) -> None:
    if name in KNOBS:
        raise ValueError(f"duplicate env-knob declaration: {name}")
    KNOBS[name] = Knob(name, kind, default, doc)


# -- fault injection ---------------------------------------------------------
_declare("DREP_TORCH_FAULTS", "str", "",
         "Deterministic fault-injection spec, `site:mode[:prob][:k=v]` comma-list "
         "(utils/faults.py). Empty = off.")
# -- durable I/O -------------------------------------------------------------
_declare("DREP_TORCH_IO_RETRIES", "int", 3,
         "Transient-I/O retry budget (EIO/ESTALE/ETIMEDOUT) per durable op "
         "(utils/durableio.py); the CLI --io_retries overrides.")
_declare("DREP_TORCH_IO_BACKOFF_S", "float", 0.05,
         "First retry backoff (s); doubles per attempt.")
_declare("DREP_TORCH_FSYNC", "bool", False,
         "Set 1 to fsync tmp file + directory around every atomic publish; "
         "the CLI --fsync overrides.")
_declare("DREP_TORCH_IO_CRC", "bool", True,
         "Set 0 to disable in-band checksum embed+verify on npz payloads and "
         "JSON notes.")
# -- observability -----------------------------------------------------------
_declare("DREP_TORCH_EVENTS", "bool", False,
         "Set 1/on to enable structured event tracing (utils/telemetry.py); "
         "the CLI --events overrides.")
_declare("DREP_TORCH_METRICS_FLUSH_S", "float", 0.0,
         "Prometheus textfile flush cadence (s) for <log>/metrics.prom; 0 = off.")
# -- the elastic pod ---------------------------------------------------------
_declare("DREP_TORCH_HEARTBEAT_S", "float", 5.0,
         "Per-process heartbeat cadence (s) of the elastic pod "
         "(parallel/faulttol.py); 0 disables heartbeats and epoch re-dealing.")
_declare("DREP_TORCH_COLLECTIVE_TIMEOUT_S", "float", 900.0,
         "Watchdog (s) of the pod's collective waits; call sites override the "
         "default where healthy skew differs (6 h at the allgather). <=0 disables.")
_declare("DREP_TORCH_POD_JOIN", "str", "",
         "Mid-run join request on a NEW process: 'auto' derives an id from the "
         "pod's notes, an integer pins one. Empty = not a joiner.")
_declare("DREP_TORCH_INGEST_BARRIER_S", "float", 600.0,
         "Sharded ingest across a pod (ingest.py): max wait (s) with no new sketch "
         "shard appearing before declaring a peer dead.")
_declare("DREP_TORCH_AUTOSCALE_SPAWNED", "bool", False,
         "Set by a controller on the processes it spawns (the fleet supervisor "
         "sets it in each replica): the join and drain notes such a pod member "
         "publishes carry an `autoscale` stamp. Never set by hand.")
# -- federated index ---------------------------------------------------------
_declare("DREP_TORCH_FED_PODS", "int", 0,
         "Federated `index update`: run per-partition updates as up to this many "
         "concurrent subprocess pods; 0 = in process. The CLI --fed_pods overrides.")
_declare("DREP_TORCH_FED_SHARD_MAX", "int", 4096,
         "Boundary-bucket cross-partition join: max band-code bucket width per "
         "range shard (pow2). Execution knob only: the candidate set is the same "
         "for every value.")
# -- index maintenance -------------------------------------------------------
_declare("DREP_TORCH_SPLIT_GC_GRACE_S", "float", 0.0,
         "Partition split/merge: delay (s) between the federation.json commit and "
         "the parent-store gc (index/maintenance.py).")
_declare("DREP_TORCH_COMPACT_GC_GRACE_S", "float", 0.0,
         "Generation compaction: delay (s) between the meta publish and the "
         "superseded-shard gc.")
_declare("DREP_TORCH_COMPACT_MIN_SHARDS", "int", 4,
         "Maintenance scheduler: propose compaction for a partition holding at "
         "least this many shard-family generations; `index compact` without "
         "--min_generations uses it as its threshold.")
_declare("DREP_TORCH_SPLIT_MAX_GENOMES", "int", 0,
         "Maintenance scheduler: propose splitting a partition past this many "
         "genomes; 0 disables split proposals.")
# -- serving -----------------------------------------------------------------
_declare("DREP_TORCH_SERVE_DEVICE_RESIDENT", "bool", True,
         "Serve: keep the resident sketch matrix on the device across classify "
         "batches (index/resident_device.py); 0 = the per-batch union path. "
         "Verdicts are the same either way.")
_declare("DREP_TORCH_SERVE_RESIDENT_MB", "int", 0,
         "Streaming federated serve: byte budget (MiB) of resident partition "
         "sketches (LRU past it); 0 = unlimited. `index serve --resident_mb` "
         "overrides.")
_declare("DREP_TORCH_SERVE_PROBE_BACKOFF_S", "float", 1.0,
         "First reload-probe delay after a partition quarantine; doubles per "
         "failed probe.")
_declare("DREP_TORCH_SERVE_PROBE_MAX_S", "float", 60.0,
         "Cap on the partition and replica reprobe backoff (s).")
_declare("DREP_TORCH_SERVE_DEADLINE_DEFAULT_MS", "float", 30000.0,
         "Serve: deadline budget (ms) stamped onto requests that carry no "
         "`deadline_ms`; 0 disables the default.")
# -- fleet router ------------------------------------------------------------
_declare("DREP_TORCH_ROUTER_LEG_TIMEOUT_S", "float", 30.0,
         "Router: per-leg socket deadline; `index route --leg_timeout_s` overrides.")
_declare("DREP_TORCH_ROUTER_HEDGE_DELAY_S", "float", 2.0,
         "Router: straggler hedge delay; `index route --hedge_delay_s` overrides.")
_declare("DREP_TORCH_ROUTER_PROBE_BACKOFF_S", "float", 1.0,
         "Router: first reprobe delay after a replica is ejected; doubles up to "
         "DREP_TORCH_SERVE_PROBE_MAX_S. `index route --probe_backoff_s` overrides.")
_declare("DREP_TORCH_ROUTER_MAX_INFLIGHT", "int", 256,
         "Router: max queued classify requests before backpressure refusals; "
         "`index route --max_inflight` overrides.")
_declare("DREP_TORCH_ROUTER_BREAKER_ERRS", "int", 5,
         "Router circuit breaker: leg errors within the window that open a "
         "replica's breaker; 0 disables.")
_declare("DREP_TORCH_ROUTER_BREAKER_WINDOW_S", "float", 30.0,
         "Router circuit breaker: sliding error window (s).")
_declare("DREP_TORCH_ROUTER_BREAKER_HALFOPEN_S", "float", 5.0,
         "Router circuit breaker: seconds an open breaker holds before one "
         "half-open probe leg.")
# -- autoscaling -------------------------------------------------------------
_declare("DREP_TORCH_AUTOSCALE_INTERVAL_S", "float", 5.0,
         "Autoscale controller: seconds between snapshots; --interval overrides.")
_declare("DREP_TORCH_AUTOSCALE_COOLDOWN_S", "float", 30.0,
         "Autoscale controller: minimum seconds between two scaling decisions; "
         "--cooldown overrides.")
_declare("DREP_TORCH_AUTOSCALE_MAX_SPAWN", "int", 1,
         "Autoscale controller: max joiners spawned (a pod) or replicas placed (a fleet) "
         "per scale-up decision; "
         "--max_spawn overrides.")
# -- fleet supervisor --------------------------------------------------------
_declare("DREP_TORCH_SUP_HEARTBEAT_S", "float", 1.0,
         "Fleet supervisor (serve/supervisor.py): seconds between liveness ticks "
         "(a pid poll and a /healthz probe a healthy slot); --heartbeat_s overrides.")
_declare("DREP_TORCH_SUP_BACKOFF_MAX_S", "float", 30.0,
         "Fleet supervisor: cap of the decorrelated restart backoff "
         "uniform(base, prev*3); --backoff_max_s overrides.")
_declare("DREP_TORCH_SUP_CRASHLOOP_K", "int", 3,
         "Fleet supervisor: deaths inside the crash-loop window that quarantine a "
         "slot (0 = never); --crashloop_k overrides.")
_declare("DREP_TORCH_SUP_CRASHLOOP_WINDOW_S", "float", 60.0,
         "Fleet supervisor: the crash-loop window (s); --crashloop_window_s overrides.")
_declare("DREP_TORCH_SUP_DRAIN_DEADLINE_S", "float", 30.0,
         "Fleet supervisor: seconds after SIGTERM before a draining replica is "
         "SIGKILLed (an escalation); --drain_deadline_s overrides.")
_declare("DREP_TORCH_SUP_STARTUP_DEADLINE_S", "float", 120.0,
         "Fleet supervisor: seconds a spawned replica gets to print its ready line "
         "before the spawn books a death; --startup_deadline_s overrides.")


def knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"undeclared env knob {name!r} — declare it in drep_tpu_torch/utils/envknobs.py") from None


def _raw(name: str) -> str | None:
    knob(name)  # an undeclared read fails loudly at run time
    return os.environ.get(name)


def env_str(name: str, default: str | None = None):
    """String knob. Unset -> the declared default (a per-call `default`
    wins); a set-but-empty value is returned as is."""
    raw = _raw(name)
    if raw is None:
        return default if default is not None else KNOBS[name].default
    return raw


def env_int(name: str, default: int | None = None) -> int:
    raw = _raw(name)
    if raw is None or not raw.strip():
        return int(default if default is not None else KNOBS[name].default)
    try:
        return int(raw.strip())
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected an integer") from None


def env_float(name: str, default: float | None = None) -> float:
    raw = _raw(name)
    if raw is None or not raw.strip():
        return float(default if default is not None else KNOBS[name].default)
    try:
        return float(raw.strip())
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number") from None


_TRUE = frozenset({"1", "true", "on", "yes"})
_FALSE = frozenset({"0", "false", "off", "no"})


def env_bool(name: str, default: bool | None = None) -> bool:
    raw = _raw(name)
    fallback = bool(default if default is not None else KNOBS[name].default)
    if raw is None or not raw.strip():
        return fallback
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    # loud: a typo must never silently flip a safety default
    raise ValueError(f"{name}={raw!r}: expected one of {sorted(_TRUE)} / {sorted(_FALSE)}")


def describe() -> str:
    """Human-readable registry dump."""
    width = max(len(k) for k in KNOBS)
    return "\n".join(
        f"{k.name:<{width}}  {k.kind:<5} default={k.default!r}\n{'':<{width}}  {k.doc}"
        for k in sorted(KNOBS.values(), key=lambda k: k.name)
    )
