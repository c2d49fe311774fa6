"""The pod-status snapshot: one read-only look at an elastic pod's store.

Counterpart of drep_tpu/utils/hosttools.py, which loads
``tools/pod_status.py::collect`` from the repo checkout. That tool
imports the JAX package, so the port keeps its own copy of ``collect``
here, in the tool's keys and values: the autoscaling controller
(autoscale/controller.py) and the serve daemon's ``update_pod`` field
(serve/daemon.py) read a pod through it. The formats are the JAX
package's: heartbeat and membership notes ``.pod-{hb,done,dead,drain,
join,admit}.p<N>``, ``row_*`` / ``blk_*`` shards with ``.eNN`` epoch
names, ``meta.json``.

Read-only by contract, byte for byte: :func:`collect` lists and reads
and writes nothing under the dir. Liveness is the pod's own rule: a
member's beat is stale when it is older than the newest beat by more
than ``HEARTBEAT_MISS_FACTOR`` x ``DREP_TORCH_HEARTBEAT_S`` (at least
1 s), judged on the file server's clock. Notes are read through the
checked readers of utils/durableio.py; a torn or corrupt note reads as
absent.

The tool's renderers and CLI (``render``, ``follow``,
``collect_federation``, ``collect_serve``, ``main``) are not copied:
``python tools/pod_status.py`` reads the port's stores as it reads the
JAX package's.
"""

from __future__ import annotations

import os
import re
import time

from drep_tpu_torch.parallel.faulttol import HEARTBEAT_MISS_FACTOR, heartbeat_cadence_s
from drep_tpu_torch.utils import durableio

__all__ = ["collect"]

_NOTE_RE = re.compile(r"^\.pod-(hb|done|dead|drain|join|admit)\.p(\d+)$")
_ROW_RE = re.compile(r"^row_(\d+)(?:\.e\d+)?\.npz$")
_BLK_RE = re.compile(r"^blk_(\d+)_(\d+)(?:\.e\d+)?\.npz$")


def _read_note(path: str):
    """A note's dict, or None where it is missing, torn or corrupt."""
    try:
        note = durableio.read_json_checked(path, what="pod note")
        return note if isinstance(note, dict) else None
    except (OSError, ValueError, durableio.CorruptPayloadError):
        return None


def _ring_total_blocks(meta: dict) -> int | None:
    """The block count of the dense ring's schedule
    (parallel/allpairs.py::ring_schedule): a half schedule runs
    ceil((D+1)/2) steps of D blocks, and an even D's middle step keeps
    only its canonical half."""
    try:
        d = int(meta["n_devices"])
    except (KeyError, TypeError, ValueError):
        return None
    if not meta.get("half", True):
        return d * d
    total = (d + 2) // 2 * d
    if d > 1 and d % 2 == 0:
        total -= d // 2
    return total


def _first_mtimes(ckpt_dir: str, names: list[str], regex) -> dict:
    """{shard key: earliest mtime} of the names `regex` matches: several
    epochs of one shard count once, at their first publish."""
    out: dict = {}
    for name in names:
        m = regex.match(name)
        if not m:
            continue
        key = tuple(int(g) for g in m.groups())
        try:
            mt = os.stat(os.path.join(ckpt_dir, name)).st_mtime
        except OSError:
            continue
        if key not in out or mt < out[key]:
            out[key] = mt
    return out


def collect(ckpt_dir: str, now: float | None = None) -> dict:
    """One read-only snapshot of the pod store at `ckpt_dir`: membership,
    epoch, shard progress and an ETA from the publish rate, or
    ``{"error": ...}`` where the dir cannot be listed. `now` (wall-clock
    seconds) defaults to the current time."""
    # drep-lint: allow[clock-mono] — staleness is judged against note mtimes (server clock), like the protocol
    now = time.time() if now is None else now
    try:
        names = sorted(os.listdir(ckpt_dir))
    except OSError as e:
        return {"error": f"cannot list {ckpt_dir}: {e}"}

    notes: dict[str, dict[int, str]] = {k: {} for k in ("hb", "done", "dead", "drain", "join", "admit")}
    for name in names:
        m = _NOTE_RE.match(name)
        if m:
            notes[m.group(1)][int(m.group(2))] = os.path.join(ckpt_dir, name)
    row_shards = _first_mtimes(ckpt_dir, names, _ROW_RE)
    blk_shards = _first_mtimes(ckpt_dir, names, _BLK_RE)
    meta = _read_note(os.path.join(ckpt_dir, "meta.json")) or {}

    beat_mtime: dict[int, float] = {}
    for pid, path in notes["hb"].items():
        try:
            beat_mtime[pid] = os.stat(path).st_mtime
        except OSError:
            pass
    # the newest beat is the reference (the protocol's rule); the
    # observer's clock only when nothing beats
    ref = max(beat_mtime.values(), default=now)
    miss_s = max(HEARTBEAT_MISS_FACTOR * heartbeat_cadence_s(), 1.0)

    done_notes = {p: _read_note(path) or {} for p, path in notes["done"].items()}
    drain_notes = {p: _read_note(path) or {} for p, path in notes["drain"].items()}
    admit_notes = {p: _read_note(path) or {} for p, path in notes["admit"].items()}
    admitted = {p for p, n in admit_notes.items() if n and "reject" not in n}

    members: dict[int, dict] = {}
    all_pids = (set(beat_mtime) | set(done_notes) | set(drain_notes) | set(notes["dead"]) | set(notes["join"])
                | admitted)
    for pid in sorted(all_pids):
        if pid in notes["dead"]:
            state = "dead"
        elif pid in drain_notes:
            state = "draining"
        elif pid in done_notes:
            state = "finished"
        elif pid in notes["join"] and pid not in admitted:
            state = "joining"
        elif pid in beat_mtime:
            state = "live" if ref - beat_mtime[pid] <= miss_s else "stale"
        else:
            state = "gone"
        entry: dict = {"state": state}
        if pid in beat_mtime:
            entry["beat_age_s"] = round(ref - beat_mtime[pid], 2)
        if "pairs" in done_notes.get(pid, {}):
            entry["pairs"] = int(done_notes[pid]["pairs"])
        if "pairs" in drain_notes.get(pid, {}):
            entry["pairs"] = int(drain_notes[pid]["pairs"])
        if pid in admitted:
            entry["joined"] = True
        members[pid] = entry

    # the epoch: the highest any note carries, or the count of membership
    # verdicts where that is higher
    note_epochs = [int(n["epoch"]) for n in (*done_notes.values(), *drain_notes.values(), *admit_notes.values())
                   if n and "epoch" in n]
    epoch = max([*note_epochs, len(notes["dead"]) + len(drain_notes) + len(admitted), 0])

    shards = row_shards if row_shards else blk_shards
    total = None
    if row_shards or "n_blocks" in meta:
        try:
            total = int(meta["n_blocks"])
        except (KeyError, TypeError, ValueError):
            total = None
    elif blk_shards or "n_devices" in meta:
        total = _ring_total_blocks(meta)
    done = len(shards)
    progress = (done / total) if total else None
    eta_s = None
    if shards and total and done < total:
        mts = sorted(shards.values())
        span = mts[-1] - mts[0]
        if done > 1 and span > 0:
            eta_s = round((total - done) / ((done - 1) / span), 1)

    by_state = lambda s: sorted(p for p, e in members.items() if e["state"] == s)  # noqa: E731
    out = {
        "checkpoint_dir": os.path.abspath(ckpt_dir),
        "observed_at": round(now, 3),
        "heartbeat_cadence_s": heartbeat_cadence_s(),
        "miss_window_s": round(miss_s, 2),
        "epoch": epoch,
        "members": {str(p): members[p] for p in sorted(members)},
        "live": by_state("live"),
        "finished": by_state("finished"),
        "draining": by_state("draining"),
        "dead": sorted(notes["dead"]),
        "stale": by_state("stale"),
        "pending_joins": sorted(set(notes["join"]) - admitted),
        "shards_published": done,
        "shards_total": total,
        "progress": round(progress, 4) if progress is not None else None,
        "eta_s": eta_s,
    }
    if meta:
        keep = ("n", "n_blocks", "block", "n_devices", "kind", "pod_epochs", "dead_processes",
                "planned_departures", "pod_joins")
        out["meta"] = {k: meta[k] for k in keep if k in meta}
    return out
