"""Structured event tracing: durable, crash-safe, append-only JSONL logs.

Counterpart of drep_tpu/utils/telemetry.py, in its formats byte for byte,
so ``tools/trace_report.py`` and ``tools/scrub_store.py`` read the port's
logs unchanged:

- one append-only file per process, ``<log>/events.p<N>.jsonl``, one JSON
  object per line: ``{"run", "pid", "epoch", "ev", "ph", "mono", "wall",
  "args"?}``. ``run`` is a workdir-stable run id, kept in
  ``events.runid`` beside the logs, so a resume keeps the id and the
  merged timeline spans the kill; ``mono``/``wall`` are
  ``time.monotonic()``/``time.time()`` seconds.
- **spans**: ``ph`` "B" at enter, "E" at exit with a ``dur`` arg (and
  ``error`` when the block raised). A "B" with no "E" is the crash
  evidence: what was in flight when the process died.
- **point events**: ``ph`` "i" (faults, verdicts, publishes).

Each line is written and flushed whole, so a SIGKILL tears at most the
final line, which the readers treat as crash evidence.

Off by default. Then every emit path is one falsy dict lookup, ``span()``
returns one shared no-op object, and no file is created. The gate is
``--events {off,on}``, or ``DREP_TORCH_EVENTS`` where the flag is not
given; :func:`configure` resolves the sink, and without a log dir tracing
stays off. Unlike the JAX package, whose sink turns itself off when the
log dir is unwritable, a trace the port was asked for and cannot write
raises: a traced run never finishes without its trace.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any

from drep_tpu_torch.utils import envknobs

EVENTS_ENV = "DREP_TORCH_EVENTS"
RUN_ID_NAME = "events.runid"


def env_enabled() -> bool:
    return envknobs.env_bool(EVENTS_ENV)


def resolve_enabled(flag: str | bool | None) -> bool:
    """The CLI/env gate: an explicit ``--events on/off`` wins; None falls
    through to ``DREP_TORCH_EVENTS`` (default off)."""
    if flag is None:
        return env_enabled()
    if isinstance(flag, bool):
        return flag
    return str(flag).strip().lower() in ("1", "on", "true")


# the process-global sink; "enabled" is the hot-path check, and the file
# opens at the first emit, so a run with tracing off never touches disk
_STATE: dict[str, Any] = {
    "enabled": False,
    "log_dir": None,
    "pid": 0,
    "run": None,
    "epoch": 0,
    "sink": None,
}
_LOCK = threading.RLock()


def configure(
    log_dir: str | None = None,
    enabled: str | bool | None = None,
    pid: int | None = None,
    run_id: str | None = None,
) -> bool:
    """Install the process event sink. `enabled` None resolves the env
    gate; tracing needs a `log_dir` to be on. Returns the final enabled
    state. Reconfiguring closes any previous sink first."""
    close()
    with _LOCK:
        on = resolve_enabled(enabled)
        if pid is not None:
            _STATE["pid"] = int(pid)
        _STATE["log_dir"] = log_dir
        _STATE["run"] = run_id
        _STATE["epoch"] = 0
        _STATE["enabled"] = bool(on and log_dir)
    return _STATE["enabled"]


def enabled() -> bool:
    return _STATE["enabled"]


def set_epoch(epoch: int) -> None:
    """Keep the stamped ownership epoch current (every later line
    carries it)."""
    _STATE["epoch"] = int(epoch)


def set_pid(pid: int) -> None:
    """Re-home the stream to a new process id: close the current sink so
    later lines land in ``events.p<pid>.jsonl``. A pod joiner configures
    tracing as process 0 and learns its admitted id only from the leader's
    admit note (parallel/faulttol.py::join_elastic_pod); lines written
    before stay under the old id."""
    if int(pid) == _STATE["pid"]:
        return
    close()
    with _LOCK:
        _STATE["pid"] = int(pid)


def _load_run_id(log_dir: str) -> str:
    """The workdir-stable run id, kept beside the event logs so a resume
    keeps it. The first writer wins through O_EXCL; a loser reads the
    winner's id (retrying through the create-to-write window)."""
    path = os.path.join(log_dir, RUN_ID_NAME)
    rid = uuid.uuid4().hex[:12]
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        pass
    else:
        try:
            os.write(fd, rid.encode())
        finally:
            os.close(fd)
        return rid
    for _ in range(20):
        with open(path, encoding="utf-8") as f:
            got = f.read().strip()
        if got:
            return got
        time.sleep(0.02)
    raise OSError(f"{path}: the run id stayed empty (another writer died mid-create?)")


def _sink():
    """The open sink, opened at the first emit; None with tracing off.
    The caller holds _LOCK."""
    s = _STATE["sink"]
    if s is not None or not _STATE["enabled"]:
        return s
    log_dir = _STATE["log_dir"]
    os.makedirs(log_dir, exist_ok=True)
    if _STATE["run"] is None:
        _STATE["run"] = _load_run_id(log_dir)
    path = os.path.join(log_dir, f"events.p{_STATE['pid']}.jsonl")
    s = open(path, "a", encoding="utf-8")  # noqa: SIM115 — the long-lived sink, closed by close()
    _STATE["sink"] = s
    return s


def _emit(ev: str, ph: str, args: dict | None) -> None:
    # under the lock: a configure() or close() on another thread cannot
    # close the sink between this line's lookup and its write
    with _LOCK:
        s = _sink()
        if s is None:
            return
        rec: dict[str, Any] = {
            "run": _STATE["run"],
            "pid": _STATE["pid"],
            "epoch": _STATE["epoch"],
            "ev": ev,
            "ph": ph,
            "mono": round(time.monotonic(), 6),
            "wall": round(time.time(), 6),
        }
        if args:
            rec["args"] = args
        # one write + flush a line: a SIGKILL tears at most the last one
        s.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
        s.flush()


def event(ev: str, **args) -> None:
    """Emit one point event (``ph`` "i"). Free when tracing is off."""
    if not _STATE["enabled"]:
        return
    _emit(ev, "i", args or None)


class _Span:
    """B at enter, E at exit (E carries ``dur`` from the monotonic clock).
    The B record is the crash evidence when the process dies inside."""

    __slots__ = ("ev", "args", "_t0")

    def __init__(self, ev: str, args: dict) -> None:
        self.ev = ev
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        _emit(self.ev, "B", self.args or None)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        args = dict(self.args)
        args["dur"] = round(time.monotonic() - self._t0, 6)
        if exc_type is not None:
            args["error"] = exc_type.__name__
        _emit(self.ev, "E", args)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP = _NoopSpan()


def span(ev: str, **args):
    """Context manager tracing one span; with tracing off, one shared
    no-op object."""
    if not _STATE["enabled"]:
        return _NOOP
    return _Span(ev, args)


def close() -> None:
    """Flush and close the sink (it reopens at the next emit, so a late
    event after an early close is not lost)."""
    with _LOCK:
        s = _STATE["sink"]
        _STATE["sink"] = None
        if s is not None:
            s.flush()
            s.close()


def read_events(log_dir: str) -> list[dict]:
    """Every record of every ``events.p<N>.jsonl`` under `log_dir`, file by
    file in pid order, each file in line order. A line that does not
    parse raises ValueError, unless it is the last line of its file: a
    SIGKILL tears at most that one, and it is skipped."""
    import glob
    import re

    def pid_of(path: str) -> int:
        m = re.search(r"events\.p(\d+)\.jsonl$", path)
        return int(m.group(1)) if m else -1

    out: list[dict] = []
    for path in sorted(glob.glob(os.path.join(log_dir, "events.p*.jsonl")), key=pid_of):
        with open(path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        for i, line in enumerate(lines):
            try:
                out.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    break  # the torn tail: crash evidence, not damage
                raise ValueError(f"{path}:{i + 1}: unparseable event line {line[:120]!r}") from None
    return out


def open_spans(records: list[dict]) -> dict[str, int]:
    """Spans whose "B" records outnumber their "E" ones, by (pid, name):
    {"<pid>:<name>": unclosed count}; empty for a cleanly finished run.
    An "E" with no "B" before it counts as -1 (damage, not a crash)."""
    balance: dict[str, int] = {}
    for r in records:
        if r.get("ph") in ("B", "E"):
            key = f"{r.get('pid')}:{r.get('ev')}"
            balance[key] = balance.get(key, 0) + (1 if r["ph"] == "B" else -1)
    return {k: v for k, v in balance.items() if v}
