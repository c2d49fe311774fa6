"""Fault-tolerant launches for one process: retries and a watchdog.

Counterpart of the single-process part of drep_tpu/parallel/faulttol.py:

- :func:`retrying_call`, one bounded retry loop with exponential backoff
  and an optional per-attempt watchdog. It runs each streaming stripe
  (parallel/streaming.py, fault site ``streaming_tile``) and each
  secondary engine call (cluster/controller.py, ``secondary_batch``).
  The port's stripe launch is synchronous (``ops/mash.py::
  stripe_survivors`` returns host arrays), so the watchdog bounds the
  launch and its copy back, not only a wait after it. When the attempts
  are spent it raises :class:`FaultTolError`: nothing recomputes the
  work on the host (the JAX package's CPU fallback tile is not ported, by
  the rule that nothing falls back to a plain version).
- :class:`AutoTimeout`, the watchdog deadline derived from the run's own
  launch latencies (k x rolling median, warmup excluded, floored); the
  streaming walk keeps one for its stripes.

The JAX package's ``TileExecutor`` routes a stripe between the devices of
a pod and benches a device that keeps failing; the port runs a stripe on
one device, so its retries run on that device (the multi-device executor
comes with the pod, ROADMAP item 12b).

A CUDA error is sticky. After a launch fails with an error such as
``cudaErrorIllegalAddress`` the context is lost, every retry on the same
card fails again, and the run raises FaultTolError after
``--fault_retries`` attempts. A kernel that really hangs is the same: the
retry queues behind the hung launch on the card and trips the watchdog
again. Either way the run fails fast where it would have hung, and a
rerun resumes from the checkpoints. The retries pay off for transient
host-side failures (a failed allocation, a filesystem hiccup inside the
call, an injected fault).

Every event is counted in utils/profiling's counters (``retries``,
``watchdog_trips``). The elastic pod (heartbeats, joins, drains,
collective timeouts) is ROADMAP item 12b and not ported.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from drep_tpu_torch.utils import faults
from drep_tpu_torch.utils.logger import get_logger


class FaultTolError(RuntimeError):
    """A launch failed beyond the retry budget."""


class WatchdogTimeout(FaultTolError):
    """One launch outlasted the per-launch watchdog."""


@dataclass(frozen=True)
class FaultTolConfig:
    """Knobs of the retries (CLI: --fault_retries, --dispatch_timeout)."""

    max_retries: int = 2  # attempts after the first failure
    dispatch_timeout_s: float = 0.0  # per-launch watchdog; 0 = auto or off
    # dispatch_timeout_s == 0 with auto_timeout derives the watchdog from
    # the run's own launch latencies; a positive dispatch_timeout_s always
    # governs. Off in the library default (a bare call runs no watchdog
    # thread); the CLI's controller turns it on.
    auto_timeout: bool = False


# the first retry's delay, doubled an attempt (the JAX package's default)
RETRY_BACKOFF_S = 0.05

# the auto-derived watchdog: k x the rolling median wait, the first waits
# excluded as warmup, floored so that ~0 ms waits cannot derive a
# hair-trigger; before enough samples the cap bounds an early hang
AUTO_TIMEOUT_MULT = 20.0
AUTO_TIMEOUT_FLOOR_S = 30.0
AUTO_TIMEOUT_WARMUP = 8
AUTO_TIMEOUT_MIN_SAMPLES = 4
AUTO_TIMEOUT_WARMUP_CAP_S = 300.0


class AutoTimeout:
    """The auto-derived per-launch watchdog deadline: k x the rolling
    median of the caller's own wait latencies, the first `warmup` waits
    excluded, floored at ``AUTO_TIMEOUT_FLOOR_S``, and the warmup cap
    until enough samples exist. A positive ``dispatch_timeout_s`` governs;
    auto off means no watchdog (0.0)."""

    def __init__(self, config: FaultTolConfig, warmup: int = AUTO_TIMEOUT_WARMUP) -> None:
        self.config = config
        self.warmup = warmup
        self._waits: deque[float] = deque(maxlen=64)
        self._n_waits = 0

    def note(self, dt: float) -> None:
        self._n_waits += 1
        if self._n_waits > self.warmup:
            self._waits.append(dt)

    def effective(self) -> float:
        if self.config.dispatch_timeout_s > 0:
            return self.config.dispatch_timeout_s
        if not self.config.auto_timeout:
            return 0.0
        if len(self._waits) < AUTO_TIMEOUT_MIN_SAMPLES:
            return AUTO_TIMEOUT_WARMUP_CAP_S
        return max(AUTO_TIMEOUT_MULT * statistics.median(self._waits), AUTO_TIMEOUT_FLOOR_S)

    def derived(self) -> float | None:
        """The derived deadline, or None where an explicit value governs,
        auto is off, or the samples are still too few (the cap is a bound,
        not a derivation)."""
        if self.config.dispatch_timeout_s > 0 or not self.config.auto_timeout:
            return None
        if len(self._waits) < AUTO_TIMEOUT_MIN_SAMPLES:
            return None
        return self.effective()


# the process-wide default, installed once a run by the cluster
# controller from the CLI flags; callers without a config read it
DEFAULT_CONFIG = FaultTolConfig()


def configure_defaults(config: FaultTolConfig) -> None:
    global DEFAULT_CONFIG
    DEFAULT_CONFIG = config


def _watchdog_run(fn: Callable[[], Any], timeout_s: float, what: str, site: str):
    """Run `fn` on a disposable daemon thread bounded by `timeout_s`:
    WatchdogTimeout (counted) on overrun, else `fn`'s value or its
    exception. One thread a watched call: a tripped call leaves its
    thread inside the launch, and the next call must not queue behind the
    thread (on the card it still queues behind the launch: see the module
    docstring)."""
    box: dict[str, Any] = {}
    done = threading.Event()

    def work() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=work, daemon=True, name=f"drep-watchdog-{site}").start()
    if not done.wait(timeout_s):
        from drep_tpu_torch.utils.profiling import counters

        counters.add_fault("watchdog_trips")
        raise WatchdogTimeout(f"{what}: exceeded the {timeout_s:.1f}s watchdog")
    if "err" in box:
        raise box["err"]
    return box["value"]


def retrying_call(
    fn: Callable[[], Any],
    site: str,
    config: FaultTolConfig | None = None,
    auto: AutoTimeout | None = None,
    fire: bool = True,
):
    """``fn()`` with bounded retries: FaultTolError once ``1 +
    max_retries`` attempts have failed. Each attempt runs under the
    watchdog where its deadline is positive: `auto`'s (the caller's
    AutoTimeout, which notes each success's latency), else the config's
    ``dispatch_timeout_s``. The fault `site` fires before each attempt,
    as in the JAX package; ``fire=False`` where `fn` fires it itself (a
    streaming stripe fires after its launch, as the JAX package's fires at
    its wait, so an injected raise costs the launch it follows)."""
    from drep_tpu_torch.utils.profiling import counters

    cfg = config if config is not None else DEFAULT_CONFIG

    def attempt_fn() -> Any:
        if fire:
            faults.fire(site)
        return fn()

    last: BaseException | None = None
    for attempt in range(cfg.max_retries + 1):
        if attempt:
            time.sleep(RETRY_BACKOFF_S * (2 ** (attempt - 1)))
            counters.add_fault("retries")
        timeout = auto.effective() if auto is not None else cfg.dispatch_timeout_s
        t0 = time.perf_counter()
        try:
            value = attempt_fn() if timeout <= 0 else _watchdog_run(attempt_fn, timeout, what=site, site=site)
        except Exception as e:  # noqa: BLE001
            last = e
            get_logger().warning("%s: attempt %d/%d failed: %s", site, attempt + 1, cfg.max_retries + 1, e)
            continue
        if auto is not None:
            auto.note(time.perf_counter() - t0)
        return value
    raise FaultTolError(f"{site}: failed after {cfg.max_retries + 1} attempts (last: {last!r})") from last
