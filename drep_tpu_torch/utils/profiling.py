"""Stage counters, latency histograms, the Prometheus textfile flush and
the device profiler.

Counterpart of drep_tpu/utils/profiling.py: :class:`Histogram`,
:class:`Counters` (stage, add, add_fault, set_gauge, observe, note_epoch,
report, write, reset), :func:`prom_text`, the periodic flush and
:func:`trace`. ``stage`` traces a ``stage:<name>`` span and ``add_fault``
a ``fault`` instant (utils/telemetry.py; free with tracing off); the
flush cadence is ``DREP_TORCH_METRICS_FLUSH_S`` (0, the default: no
thread, no file). :func:`trace` is the ``--profile`` hook:
``torch.profiler`` over the CPU and the card, exported as a Chrome
trace, where the JAX package runs ``jax.profiler.trace``. The JAX
package's tile accounting (``add_tiles``) and notes are not ported: no
port path records them.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

from drep_tpu_torch.utils import envknobs, telemetry

METRICS_FLUSH_ENV = "DREP_TORCH_METRICS_FLUSH_S"
METRICS_NAME = "metrics.prom"
TRACE_NAME = "trace.json"


@dataclass
class _Stage:
    pairs: int = 0
    seconds: float = 0.0
    calls: int = 0


class Histogram:
    """Bounded-window latency histogram for a long-lived process: a ring
    of the last `size` observations feeds the percentiles, while
    count/total/max run unbounded. O(1) observe, O(size) summary."""

    __slots__ = ("size", "ring", "count", "total", "vmax")

    def __init__(self, size: int = 8192):
        self.size = int(size)
        self.ring: list[float] = []
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if len(self.ring) < self.size:
            self.ring.append(v)
        else:
            self.ring[self.count % self.size] = v
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    @staticmethod
    def _pick(sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
        return sorted_vals[int(idx)]

    def percentile(self, q: float) -> float:
        return self._pick(sorted(self.ring), q)

    def summary(self) -> dict[str, float]:
        vals = sorted(self.ring)
        return {
            "count": self.count,
            "mean": round(self.total / self.count, 4) if self.count else 0.0,
            "p50": round(self._pick(vals, 0.5), 4),
            "p90": round(self._pick(vals, 0.9), 4),
            "p99": round(self._pick(vals, 0.99), 4),
            "max": round(self.vmax, 4),
        }


@dataclass
class Counters:
    """Per-stage pair/time accounting, fault-event counts, gauges (last
    write wins) and named latency histograms. One process-global instance
    (:data:`counters`) plus independent instances for tests."""

    stages: dict[str, _Stage] = field(default_factory=dict)
    faults: dict[str, int] = field(default_factory=dict)
    gauges: dict[str, float] = field(default_factory=dict)
    # ownership-epoch bumps in order (with their reasons); a single
    # process records none until the elastic pod (item 12b) bumps them
    epoch_history: list = field(default_factory=list)
    hists: dict[str, Histogram] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, pairs: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        # the one hook that traces every counted stage block
        with telemetry.span("stage:" + name):
            try:
                yield
            finally:
                st = self.stages.setdefault(name, _Stage())
                st.pairs += int(pairs)
                st.seconds += time.perf_counter() - t0
                st.calls += 1

    def add(self, name: str, pairs: int, seconds: float) -> None:
        """Record one stage call measured by the caller (where the pairs
        are known only after the call)."""
        st = self.stages.setdefault(name, _Stage())
        st.pairs += int(pairs)
        st.seconds += float(seconds)
        st.calls += 1

    def add_fault(self, kind: str, n: int = 1) -> None:
        """Count one event of `kind` (a retry, a refusal, a shed, an
        injected fault) and, with tracing on, stamp when it happened."""
        self.faults[kind] = self.faults.get(kind, 0) + int(n)
        telemetry.event("fault", kind=kind, n=int(n))

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """One observation into the named histogram (made on first use)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.observe(value)

    def note_epoch(self, epoch: int, reason: str) -> None:
        """Record one ownership-epoch bump: the history, the ``pod_epoch``
        gauge, the event stream's stamped epoch and an ``epoch`` instant."""
        self.epoch_history.append({"epoch": int(epoch), "reason": str(reason), "at": round(time.time(), 3)})
        self.set_gauge("pod_epoch", float(epoch))
        telemetry.set_epoch(int(epoch))
        telemetry.event("epoch", epoch=int(epoch), reason=str(reason))

    def report(self) -> dict[str, Any]:
        import torch

        n_chips = max(1, torch.cuda.device_count())
        out: dict[str, Any] = {"n_chips": n_chips, "stages": {}}
        total_pairs, total_seconds = 0, 0.0
        for name, st in self.stages.items():
            rate = st.pairs / st.seconds if st.seconds > 0 else 0.0
            out["stages"][name] = {
                "pairs": st.pairs,
                "seconds": round(st.seconds, 4),
                "calls": st.calls,
                "pairs_per_sec": round(rate, 1),
                "pairs_per_sec_per_chip": round(rate / n_chips, 1),
            }
            total_pairs += st.pairs
            total_seconds += st.seconds
        total_rate = total_pairs / total_seconds if total_seconds > 0 else 0.0
        out["total"] = {
            "pairs": total_pairs,
            "seconds": round(total_seconds, 4),
            "pairs_per_sec_per_chip": round(total_rate / n_chips, 1),
        }
        if self.faults:
            out["fault_tolerance"] = dict(sorted(self.faults.items()))
        if self.gauges:
            out["gauges"] = dict(sorted(self.gauges.items()))
        if self.epoch_history:
            out["epoch_history"] = list(self.epoch_history)
        if self.hists:
            out["histograms"] = {name: h.summary() for name, h in sorted(self.hists.items())}
        return out

    def write(self, log_dir: str) -> str:
        """``<log_dir>/perf_counters.json``, written atomically."""
        from drep_tpu_torch.utils.durableio import atomic_write_bytes

        path = os.path.join(log_dir, "perf_counters.json")
        atomic_write_bytes(path, json.dumps(self.report(), indent=1, sort_keys=True).encode())
        return path

    def reset(self) -> None:
        self.stages.clear()
        self.faults.clear()
        self.gauges.clear()
        self.epoch_history.clear()
        self.hists.clear()


counters = Counters()  # the process-global instance


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prom_text(c: Counters | None = None) -> str:
    """The counters as Prometheus textfile-collector lines, under the JAX
    package's metric names: stage totals, fault events by kind, gauges,
    histogram summaries and the flush timestamp."""
    c = counters if c is None else c
    stages = sorted(c.stages.items())
    lines = [
        "# HELP drep_tpu_stage_pairs_total pair comparisons recorded per stage",
        "# TYPE drep_tpu_stage_pairs_total counter",
        *(f'drep_tpu_stage_pairs_total{{stage="{_prom_escape(n)}"}} {st.pairs}' for n, st in stages),
        "# TYPE drep_tpu_stage_seconds_total counter",
        *(f'drep_tpu_stage_seconds_total{{stage="{_prom_escape(n)}"}} {round(st.seconds, 6)}'
          for n, st in stages),
        "# TYPE drep_tpu_stage_calls_total counter",
        *(f'drep_tpu_stage_calls_total{{stage="{_prom_escape(n)}"}} {st.calls}' for n, st in stages),
        "# HELP drep_tpu_fault_events_total fault-tolerance events by kind",
        "# TYPE drep_tpu_fault_events_total counter",
        *(f'drep_tpu_fault_events_total{{kind="{_prom_escape(k)}"}} {v}' for k, v in sorted(c.faults.items())),
        "# HELP drep_tpu_gauge derived operational values (last write wins)",
        "# TYPE drep_tpu_gauge gauge",
        *(f'drep_tpu_gauge{{name="{_prom_escape(g)}"}} {v}' for g, v in sorted(c.gauges.items())),
        "# HELP drep_tpu_latency summary stats over the recent observation window",
        "# TYPE drep_tpu_latency gauge",
        *(
            f'drep_tpu_latency{{name="{_prom_escape(n)}",stat="{stat}"}} {v}'
            for n, h in sorted(c.hists.items())
            for stat, v in h.summary().items()
        ),
        "# TYPE drep_tpu_epoch_bumps_total counter",
        f"drep_tpu_epoch_bumps_total {len(c.epoch_history)}",
        "# TYPE drep_tpu_metrics_flush_timestamp_seconds gauge",
        f"drep_tpu_metrics_flush_timestamp_seconds {round(time.time(), 3)}",
    ]
    return "\n".join(lines) + "\n"


def flush_metrics(log_dir: str, c: Counters | None = None) -> str:
    """One atomic publish of the counters to ``<log_dir>/metrics.prom``:
    a scrape mid-publish reads the previous whole file."""
    from drep_tpu_torch.utils.durableio import atomic_write_bytes

    path = os.path.join(log_dir, METRICS_NAME)
    atomic_write_bytes(path, prom_text(c).encode())
    return path


_METRICS: dict[str, Any] = {"stop": None, "thread": None, "log_dir": None}


def metrics_flush_cadence_s() -> float:
    return envknobs.env_float(METRICS_FLUSH_ENV)


def start_metrics_flush(log_dir: str) -> bool:
    """Start a daemon thread that flushes the counters every
    ``DREP_TORCH_METRICS_FLUSH_S`` seconds; at 0, the default, no thread
    starts and no file is written. A second start replaces the first."""
    stop_metrics_flush()
    _METRICS["log_dir"] = log_dir
    cadence_s = metrics_flush_cadence_s()
    if cadence_s <= 0:
        return False
    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(cadence_s):
            try:
                flush_metrics(log_dir)
            except OSError:  # a failed flush must not end the process; the next one retries
                pass

    t = threading.Thread(target=loop, daemon=True, name="drep-metrics-flush")
    _METRICS["stop"] = stop
    _METRICS["thread"] = t
    t.start()
    return True


def stop_metrics_flush(final: bool = False) -> None:
    """Stop the flusher; with `final`, publish one last snapshot so the
    scrape file agrees with the exit-time perf_counters.json."""
    stop, t = _METRICS["stop"], _METRICS["thread"]
    _METRICS["stop"] = _METRICS["thread"] = None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=2.0)
    if final and stop is not None and _METRICS["log_dir"]:
        with contextlib.suppress(OSError):
            flush_metrics(_METRICS["log_dir"])


@contextlib.contextmanager
def trace(trace_dir: str | None) -> Iterator[None]:
    """``torch.profiler`` over the block, CPU and CUDA activities, exported
    as a Chrome trace to ``<trace_dir>/trace.json``, when a directory is
    given; a no-op otherwise. A trace that cannot be written raises."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
