"""Deterministic fault injection for the port's device and storage paths.

Counterpart of drep_tpu/utils/faults.py. The pipeline's
crash story (atomic shard checkpoints, per-cluster secondary
checkpoints, the ingest shard store) is testable because kills are
external; its live-failure story (a launch that raises, a launch that
hangs, a torn shard, a flaky filesystem) is testable only if those
failures can be made on purpose. Named injection points sit on those
paths, and a spec string decides which of them misbehave, how and how
often, deterministically, so a failing chaos run replays.

Spec syntax (``DREP_TORCH_FAULTS``, or :func:`configure`), the JAX
package's grammar unchanged::

    site:mode[:prob][:key=value ...]  [, site:mode ...]

    DREP_TORCH_FAULTS="streaming_tile:raise:0.05:seed=7,shard_write:torn"

- ``site``: the injection point. The port threads all twenty-two of the
  JAX package's sites at the JAX package's fire points: ``streaming_tile``
  (each streaming stripe's launch, parallel/streaming.py),
  ``secondary_batch`` (each secondary engine call, cluster/controller.py),
  ``shard_write`` (each npz shard publish, utils/durableio.py), ``io``
  (every durable read and write), ``index_update`` (an update's tail
  rectangle and its publish, index/update.py), ``meta_publish`` (the
  generation commit, index/meta.py), ``partition_load`` /
  ``partition_classify`` (a served partition's load and consult) and
  ``partition_update`` (a federated update's partition and its commit,
  index/federation.py), ``partition_split`` and ``compaction``
  (index/maintenance.py's transactions), ``router_leg`` /
  ``replica_health`` (a routed leg and a replica probe,
  serve/router.py), ``wire`` (each reply line through the chaos proxy,
  serve/wirechaos.py, polled by :func:`wire_fault`), and
  ``supervisor_spawn`` / ``supervisor_tick`` (a spawn after the manifest
  records its intent and before the fork, and the top of each
  supervision tick, serve/supervisor.py), and the elastic pod's:
  ``ring_dispatch`` (each dense-ring step's wait and each per-block
  recovery launch, parallel/allpairs.py), ``ring_step`` (each ring step
  boundary), ``allgather`` (the pod's edge and row exchanges),
  ``barrier`` (each pod barrier, utils/ckptmeta.py) and
  ``process_death`` (each streaming stripe, before its launch); and
  ``autoscale_decide`` (the top of each tick of the pod's autoscaling
  controller, autoscale/controller.py).
- ``mode``: ``raise`` (InjectedFault), ``hang`` (sleep ``secs``, default
  3600, then raise: trips the watchdog), ``sleep`` (sleep ``secs``, then
  go on), ``kill`` (SIGKILL the calling process: no cleanup, as an
  external kill; not at the ``io`` site), ``torn`` (``shard_write``
  only: publish a truncated file in place of the atomic write), the
  ``io`` modes ``io_error`` (EIO on reads and writes), ``stale_read``
  (ESTALE on reads), ``enospc`` (ENOSPC on writes) and ``corrupt`` (flip
  one bit of the published file), and the ``wire`` modes, which the
  proxy acts out on the byte stream of one reply line: ``reset`` (RST
  mid-reply), ``stall`` (hold it ``secs``, default 3600), ``slow``
  (delay it ``secs``, default 0.05), ``short_read`` (half the line, then
  EOF), ``garble`` (flip bytes inside the frame's body: the CRC must
  catch it) and ``dup`` (the line twice). ``drain`` (``process_death``
  and ``ring_step`` only) asks this process for a planned departure, as
  SIGTERM does (parallel/faulttol.py::request_drain), honoured at that
  very boundary.
- ``prob``: per-call probability (default 1.0), drawn from the rule's
  own ``random.Random(seed)`` stream.
- ``key=value``: ``seed=N`` (default 0), ``secs=F``, ``device=N`` (fire
  only for that device slot), ``max=N`` (stop after N fires),
  ``proc=N`` (fire only in process N of a pod),
  ``skip=N`` (let the first N matching calls pass), ``path=S`` (fire
  only where the target path contains S; io and shard_write sites, and
  on the wire site the proxy's peer label, so one spec damages one hop).

The same spec fires on the same calls of a site in both packages. With
no spec, :func:`fire` costs one falsy check.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import time
from dataclasses import dataclass, field

from drep_tpu_torch.utils import envknobs

ENV = "DREP_TORCH_FAULTS"

# every site of the JAX package's registry, each polled where the JAX
# package polls it, so that its specs parse and fire the same way
SITES = (
    "streaming_tile", "ring_dispatch", "ring_step", "secondary_batch", "shard_write", "allgather",
    "barrier", "process_death", "io", "index_update", "partition_update", "meta_publish",
    "partition_load", "partition_classify", "autoscale_decide", "router_leg", "replica_health",
    "partition_split", "compaction", "wire", "supervisor_spawn", "supervisor_tick",
)
IO_MODES = ("io_error", "stale_read", "enospc", "corrupt")
WIRE_MODES = ("reset", "stall", "slow", "short_read", "garble", "dup")
MODES = ("raise", "hang", "sleep", "torn", "kill", "drain") + IO_MODES + WIRE_MODES


class InjectedFault(RuntimeError):
    """An artificial failure fired by the registry: retried exactly like
    a real launch error (only the counters label it injected)."""


class FaultSpecError(ValueError):
    """A malformed fault spec (bad site, mode or field)."""


@dataclass
class _Rule:
    site: str
    mode: str
    prob: float = 1.0
    seed: int = 0
    secs: float | None = None
    device: int | None = None
    proc: int | None = None
    skip: int = 0
    max_fires: int | None = None
    path_sub: str | None = None
    fired: int = 0
    seen: int = 0
    rng: random.Random = field(init=False)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)

    def should_fire(self, device: int | None, path: str | None = None) -> bool:
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.device is not None and device != self.device:
            return False
        if self.path_sub is not None and (path is None or self.path_sub not in path):
            return False
        if self.proc is not None:
            from drep_tpu_torch.parallel.mesh import process_index

            if process_index() != self.proc:
                return False
        self.seen += 1
        if self.seen <= self.skip:
            return False
        # drawn on every matching call, so the stream's position depends
        # only on the number of matching calls
        return self.rng.random() < self.prob


def _parse(spec: str) -> dict[str, list[_Rule]]:
    rules: dict[str, list[_Rule]] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        fields = entry.split(":")
        if len(fields) < 2:
            raise FaultSpecError(f"fault entry needs site:mode, got {entry!r}")
        site, mode = fields[0], fields[1]
        if site not in SITES:
            raise FaultSpecError(f"unknown fault site {site!r} (known: {', '.join(SITES)})")
        if mode not in MODES:
            raise FaultSpecError(f"unknown fault mode {mode!r} (known: {', '.join(MODES)})")
        # a rule its site never acts on would claim coverage and inject
        # nothing: each mode belongs to the sites that poll it
        if mode in IO_MODES and site != "io":
            raise FaultSpecError(f"mode {mode!r} is io-site-only (got site {site!r})")
        if site == "io" and mode in ("torn", "kill"):
            raise FaultSpecError(f"mode {mode!r} has no 'io' site semantics — use shard_write:torn for torn "
                                 f"publishes, or another site's kill for deaths")
        if mode == "drain" and site not in ("process_death", "ring_step"):
            # consumed at the elastic loops' safe boundaries, which are
            # exactly these sites' fire points
            raise FaultSpecError(f"mode 'drain' fires only at the safe-boundary sites process_death/ring_step "
                                 f"(got site {site!r})")
        if mode in WIRE_MODES and site != "wire":
            raise FaultSpecError(f"mode {mode!r} is wire-site-only (got site {site!r})")
        if site == "wire" and mode not in WIRE_MODES:
            raise FaultSpecError(f"the 'wire' site takes only the wire modes {', '.join(WIRE_MODES)} (got {mode!r})")
        if mode == "torn" and site != "shard_write":
            raise FaultSpecError(f"mode 'torn' is shard_write-only (got site {site!r})")
        rule = _Rule(site=site, mode=mode)
        for f in fields[2:]:
            if "=" in f:
                key, _, val = f.partition("=")
                if key == "seed":
                    rule.seed = int(val)
                elif key == "secs":
                    rule.secs = float(val)
                elif key == "device":
                    rule.device = int(val)
                elif key == "proc":
                    rule.proc = int(val)
                elif key == "skip":
                    rule.skip = int(val)
                elif key == "max":
                    rule.max_fires = int(val)
                elif key == "path":
                    # only the durable-I/O sites pass a path, and the wire
                    # site its peer label; anywhere else the rule would
                    # never fire
                    if site not in ("io", "shard_write", "wire"):
                        raise FaultSpecError(
                            f"path= is only meaningful on the io/shard_write/wire sites (got {site!r})")
                    rule.path_sub = val
                else:
                    raise FaultSpecError(f"unknown fault field {key!r} in {entry!r}")
            else:
                rule.prob = float(f)
        rule.__post_init__()  # re-seed after the seed= field
        rules.setdefault(site, []).append(rule)
    return rules


# None: not parsed yet (read from the environment on first use); {}:
# nothing injected, one falsy check a call
_RULES: dict[str, list[_Rule]] | None = None


def configure(spec: str | None) -> None:
    """Install a spec in this process; None or "" turns injection off."""
    global _RULES
    _RULES = _parse(spec) if spec else {}


def reset() -> None:
    """Forget the installed spec; the environment is read again on next use."""
    global _RULES
    _RULES = None


def _rules() -> dict[str, list[_Rule]]:
    global _RULES
    if _RULES is None:
        _RULES = _parse(envknobs.env_str(ENV))
    return _RULES


def active() -> bool:
    return bool(_rules())


def _record(rule: _Rule) -> None:
    from drep_tpu_torch.utils.profiling import counters

    rule.fired += 1
    counters.add_fault(f"injected_{rule.site}_{rule.mode}")


def fire(site: str, device: int | None = None) -> None:
    """Run the matching rules of `site`: raise, hang, sleep or kill. A watched
    site calls this inside the watched region, so that a ``hang`` trips
    the watchdog rather than the caller."""
    rules = _RULES if _RULES is not None else _rules()
    if not rules:
        return
    for rule in rules.get(site, ()):
        if not rule.should_fire(device):
            continue
        _record(rule)
        if rule.mode == "raise":
            raise InjectedFault(f"injected fault at {site} (device={device})")
        if rule.mode == "hang":
            time.sleep(3600.0 if rule.secs is None else rule.secs)
            raise InjectedFault(f"injected hang at {site} woke up (device={device})")
        if rule.mode == "sleep":
            time.sleep(0.05 if rule.secs is None else rule.secs)
        if rule.mode == "kill":
            # an external SIGKILL's stand-in: no cleanup, no atexit; the
            # counters die with the process
            os.kill(os.getpid(), signal.SIGKILL)
        if rule.mode == "drain":
            # SIGTERM's stand-in, minus the signal: consumed at this very
            # boundary (the elastic loops check right after their fire)
            from drep_tpu_torch.parallel.faulttol import request_drain

            request_drain()


def torn_write(site: str = "shard_write", path: str | None = None) -> bool:
    """Should the writer tear this publish? (polled by the writer: a torn
    file is something it writes, not an exception)."""
    rules = _RULES if _RULES is not None else _rules()
    if not rules:
        return False
    for rule in rules.get(site, ()):
        if rule.mode == "torn" and rule.should_fire(None, path=path):
            _record(rule)
            return True
    return False


def corrupt_write(site: str = "io", path: str | None = None) -> bool:
    """Should the writer flip a bit of this file after its atomic publish
    (the ``io:corrupt`` mode)?"""
    rules = _RULES if _RULES is not None else _rules()
    if not rules:
        return False
    for rule in rules.get(site, ()):
        if rule.mode == "corrupt" and rule.should_fire(None, path=path):
            _record(rule)
            return True
    return False


def wire_fault(peer: str | None = None):
    """Poll the ``wire`` site for one reply line about to cross `peer`'s
    hop (serve/wirechaos.py, a poll a reply line). Returns the matching
    rule, whose mode the proxy acts out on the byte stream, or None;
    ``path=`` rules match the peer label."""
    rules = _RULES if _RULES is not None else _rules()
    if not rules:
        return None
    for rule in rules.get("wire", ()):
        if rule.should_fire(None, path=peer):
            _record(rule)
            return rule
    return None


def fire_io(op: str, path: str | None = None) -> None:
    """Run the ``io`` site's rules for one durable I/O attempt (`op` is
    ``"read"`` or ``"write"``), inside the retried region so that the
    transient errors exercise the real backoff: ``stale_read`` fires on
    reads only, ``enospc`` on writes only, ``io_error`` on both;
    ``corrupt`` is polled by :func:`corrupt_write`."""
    rules = _RULES if _RULES is not None else _rules()
    if not rules:
        return
    for rule in rules.get("io", ()):
        if rule.mode == "corrupt":
            continue
        if rule.mode == "stale_read" and op != "read":
            continue
        if rule.mode == "enospc" and op != "write":
            continue
        if not rule.should_fire(None, path=path):
            continue
        _record(rule)
        if rule.mode == "io_error":
            raise OSError(errno.EIO, f"injected EIO at io ({op}: {path})")
        if rule.mode == "stale_read":
            raise OSError(errno.ESTALE, f"injected ESTALE at io (read: {path})")
        if rule.mode == "enospc":
            raise OSError(errno.ENOSPC, f"injected ENOSPC at io (write: {path})")
        if rule.mode == "raise":
            raise InjectedFault(f"injected fault at io ({op}: {path})")
        if rule.mode == "hang":
            # a wedged filesystem call surfaces as EIO after the hang, for
            # the retry loop (not a watchdog) to handle
            time.sleep(3600.0 if rule.secs is None else rule.secs)
            raise OSError(errno.EIO, f"injected hang at io woke up ({op}: {path})")
        if rule.mode == "sleep":
            time.sleep(0.05 if rule.secs is None else rule.secs)
