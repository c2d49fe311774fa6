"""The traced run: a ``torch.profiler`` timeline of the window, reduced to
device time by name, the device's busy time and the idle gaps.

The harness marks each job of the window with a ``record_function`` span
``bench.job``; the job driver's host phases, timed in each job's record,
are laid end to end inside it (harness.split_phases). Device activity is
every kernel, copy and fill in the trace. An idle gap is a stretch of the window with no device
activity. It is cut where a harness span starts or ends, and each piece
is labelled by the innermost span that holds it, so a gap that runs from
one job's linkage through the next job's pack reads as two.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str):
    """A harness span (``bench.<name>``), seen by the profiler when one is running."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Timeline:
    """Seconds of device time by operation name, the busy seconds (the
    union of device intervals inside the window), the window's seconds,
    and the idle gaps [(label, seconds)] longest first."""

    device_ops: dict[str, float]
    busy_s: float
    window_s: float
    gaps: list[tuple[str, float]]

    def device_seconds(self, needle: str) -> float:
        """Device seconds of the operations whose name holds `needle`."""
        return sum(s for name, s in self.device_ops.items() if needle in name)


class Profiled:
    """``with Profiled(device) as p: ...`` then ``p.timeline()``."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def timeline(self, refine=None) -> Timeline:
        """The window's :class:`Timeline`; `refine` may add host spans."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return reduce_events(events, refine)


def reduce_events(events: list[dict], refine=None) -> Timeline:
    """Chrome-trace events -> :class:`Timeline` over the window that the
    ``bench.job`` spans cover (first start to last end). `refine` takes
    the host spans [(name, start_us, end_us)] and returns them with more
    (the job driver's phases)."""
    spans = sorted(
        (e["name"][len(SPAN_PREFIX):], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX)
    )
    jobs = [s for s in spans if s[0] == "job"]
    if refine is not None:
        spans = refine(spans)
    if not jobs:
        return Timeline({}, 0.0, 0.0, [])
    w0, w1 = min(s[1] for s in jobs), max(s[2] for s in jobs)
    ops: dict[str, float] = {}
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
        intervals.append((a, b))
    intervals.sort()
    busy = 0.0
    gaps_us: list[tuple[float, float]] = []
    cur_a, cur_b = None, w0
    for a, b in intervals:
        if cur_a is None or a > cur_b:
            if a > cur_b:
                gaps_us.append((cur_b, a))
            if cur_a is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if w1 > cur_b:
        gaps_us.append((cur_b, w1))
    gaps = sorted((piece for a, b in gaps_us for piece in _pieces(spans, a, b)), key=lambda g: -g[1])
    return Timeline(ops, busy * 1e-6, (w1 - w0) * 1e-6, gaps)


def _pieces(spans: list[tuple[str, float, float]], a: float, b: float) -> list[tuple[str, float]]:
    """The idle stretch [a, b] (us) cut where a span starts or ends:
    (label, seconds) pieces, neighbours of one label joined."""
    cuts = sorted({a, b, *(t for _, s, e in spans for t in (s, e) if a < t < b)})
    out: list[list] = []
    for lo, hi in zip(cuts, cuts[1:]):
        name = _label(spans, (lo + hi) / 2)
        if out and out[-1][0] == name:
            out[-1][1] += hi - lo
        else:
            out.append([name, hi - lo])
    return [(name, us * 1e-6) for name, us in out]


def _label(spans: list[tuple[str, float, float]], t: float) -> str:
    """The innermost harness span holding time `t` (the shortest), or
    'between_jobs'."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best is not None else "between_jobs"
