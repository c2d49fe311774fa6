"""The checkpoint-directory meta protocol of the shard stores.

Counterpart of drep_tpu/utils/ckptmeta.py. A ``meta.json`` pins the exact
inputs the shards of a store were computed from: on open, a matching meta
means the shards resume; a mismatch (or a corrupt meta) clears the
directory and writes the new meta. The format is the JAX package's, so a
store written by either package opens in the other.

On a pod (parallel/mesh.py) one leader clears and writes the meta while
the others wait at :func:`barrier_with_timeout`, then open against the
now-matching meta. The leader is process 0 on a healthy pod, the lowest
live process once the elastic pod has lost a member
(parallel/faulttol.py). The barrier is the gloo group's under the
collective watchdog, or, where a heartbeat manager is running or the pod
has lost a member, a file barrier of sentinel notes
(``.barrier-<tag hash>.p<id>``) over the live members, which admits a
peer that died before reaching it as a pod death.
:func:`stamp_checkpoint_meta` records how a degraded pod produced a store.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Any, Iterable

import numpy as np

from drep_tpu_torch.utils.durableio import atomic_write_bytes, atomic_write_json, read_json_checked

META_NAME = "meta.json"

# the only stored-meta keys a resume may ignore: provenance the JAX
# package's elastic pod stamps into a finished store (how its shards were
# produced, never what from)
META_PROVENANCE_KEYS = ("pod_epochs", "dead_processes", "planned_departures", "pod_joins")


def content_fingerprint(names: Iterable[str], *arrays: np.ndarray) -> str:
    """SHA-1 over an ordered name list plus array contents: the packed
    int32 ids are a run's own vocabulary remap, so a store is pinned to
    its inputs, not to their shapes."""
    h = hashlib.sha1()
    for name in names:
        h.update(str(name).encode())
        h.update(b"\0")
    for arr in arrays:
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def checkpoint_meta_matches(ckpt_dir: str, meta: dict[str, Any]) -> bool:
    """Does `ckpt_dir` hold a meta equal to `meta`, up to the provenance
    keys? Every key of `meta` must be stored with an equal value, and the
    stored meta may carry nothing else. A missing or corrupt meta is not a
    match; an I/O error is raised (an intact store must not be cleared
    for it). Reads only."""
    loc = os.path.join(ckpt_dir, META_NAME)
    if not os.path.exists(loc):
        return False
    try:
        stored = read_json_checked(loc, what="checkpoint meta")
    except FileNotFoundError:
        return False
    except OSError:
        raise
    except Exception:  # noqa: BLE001 — a corrupt meta is not resumable
        return False
    if not isinstance(stored, dict):
        return False
    if set(stored) - set(meta) - set(META_PROVENANCE_KEYS):
        return False
    return all(stored.get(k) == v for k, v in meta.items())


def open_checkpoint_dir(ckpt_dir: str, meta: dict[str, Any], clear_suffixes: tuple[str, ...]) -> bool:
    """Prepare `ckpt_dir` for shards computed under `meta`. True when a
    matching meta is already there (its shards resume); else the files
    ending in any of `clear_suffixes` and the meta are removed, the new
    meta is written, and False is returned.

    On a pod every (live) member calls this in the same order: the leader
    opens, all meet at the barrier, then the rest open against the
    leader's meta. A leader that died at the barrier (the barrier admitted
    its death) is replaced by the lowest live member and the open runs
    again."""
    from drep_tpu_torch.parallel.mesh import process_count, process_index

    pc = process_count()
    if pc > 1:
        from drep_tpu_torch.parallel.faulttol import pod_live

        tag = "drep_tpu_ckpt_open:" + os.path.abspath(ckpt_dir)
        for _ in range(pc):
            live = pod_live()
            leader = 0 if live is None else min(live)
            resume = False
            if process_index() == leader:
                resume = _open_checkpoint_dir_local(ckpt_dir, meta, clear_suffixes)
            barrier_with_timeout(tag, ckpt_dir)
            live2 = pod_live()
            if (0 if live2 is None else min(live2)) != leader:
                continue  # the leader died at or before the barrier: again under the new one
            if process_index() != leader:
                resume = _open_checkpoint_dir_local(ckpt_dir, meta, clear_suffixes)
            return resume
        raise RuntimeError(
            f"open_checkpoint_dir({ckpt_dir!r}): leadership never settled across {pc} passes"
        )
    return _open_checkpoint_dir_local(ckpt_dir, meta, clear_suffixes)


def _open_checkpoint_dir_local(ckpt_dir: str, meta: dict[str, Any], clear_suffixes: tuple[str, ...]) -> bool:
    os.makedirs(ckpt_dir, exist_ok=True)
    if checkpoint_meta_matches(ckpt_dir, meta):
        return True
    for f in os.listdir(ckpt_dir):
        if f == META_NAME or any(f.endswith(s) for s in clear_suffixes):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(ckpt_dir, f))
    atomic_write_json(os.path.join(ckpt_dir, META_NAME), meta)
    return False


def stamp_checkpoint_meta(ckpt_dir: str, extra: dict[str, Any]) -> None:
    """Merge provenance keys (META_PROVENANCE_KEYS) into an existing
    meta.json. Best-effort: a finished stage never dies on its own
    bookkeeping; a failure is logged."""
    loc = os.path.join(ckpt_dir, META_NAME)
    try:
        stored = read_json_checked(loc, what="checkpoint meta")
        if not isinstance(stored, dict):
            raise ValueError(f"meta at {loc} is not a dict")
        stored.update(extra)
        atomic_write_json(loc, stored)
    except Exception as e:  # noqa: BLE001
        from drep_tpu_torch.utils.logger import get_logger

        get_logger().warning("could not stamp checkpoint meta %s with %s: %s", loc, extra, e)


# per-tag barrier sequence numbers: every member reaches the same barriers
# in the same order, so sequence k on one pairs with sequence k on another
_BARRIER_SEQ: dict[str, int] = {}


def _barrier_note(note_dir: str, tag: str, pid: int) -> str:
    taghash = hashlib.sha1(tag.encode()).hexdigest()[:10]
    return os.path.join(note_dir, f".barrier-{taghash}.p{pid}")


def barrier_with_timeout(tag: str, note_dir: str) -> None:
    """A pod barrier that cannot hang forever. Each member first writes a
    sentinel note carrying its sequence number for `tag` into `note_dir`,
    so that a timeout names the members that never arrived. The barrier
    itself is:

    - on a pod that lost a member, the file barrier over the live members
      (the gloo group still counts the dead one);
    - where a heartbeat manager is running (the streaming primary and the
      dense ring start theirs before opening their store), the file
      barrier with liveness checks: a peer that died before arriving is
      declared dead within --max_dead_processes and the barrier completes
      over the survivors;
    - else the gloo barrier under :func:`faulttol.run_with_timeout`.

    The ``barrier`` fault site fires on the last two routes, as in the
    JAX package."""
    from drep_tpu_torch.parallel.faulttol import current_heartbeat, pod_live, run_with_timeout
    import torch

    from drep_tpu_torch.parallel.mesh import process_count, process_index

    pid, pc = process_index(), process_count()
    seq = _BARRIER_SEQ.get(tag, 0) + 1
    _BARRIER_SEQ[tag] = seq
    os.makedirs(note_dir, exist_ok=True)
    live = pod_live()
    if live is not None:
        _file_barrier(tag, note_dir, live, pid, seq)
        return
    hb = current_heartbeat()
    if hb is not None and hb.cadence > 0 and pc > 1:
        from drep_tpu_torch.utils import faults

        faults.fire("barrier")
        _file_barrier(tag, note_dir, None, pid, seq, hb=hb)
        return
    atomic_write_bytes(_barrier_note(note_dir, tag, pid), str(seq).encode())

    def diagnose() -> str:
        missing = []
        for p in range(pc):
            try:
                with open(_barrier_note(note_dir, tag, p)) as f:
                    if int(f.read().strip()) >= seq:
                        continue
            except (OSError, ValueError):
                pass
            missing.append(p)
        if missing:
            return f"Process(es) {missing} of {pc} never reached checkpoint barrier {tag!r} (no sentinel note in {note_dir})."
        return f"All {pc} processes left sentinel notes for barrier {tag!r}: a peer died inside the collective."

    try:
        run_with_timeout(torch.distributed.barrier, what=f"checkpoint barrier {tag!r} ({pc} processes)", site="barrier",
                         diagnose=diagnose)
    finally:
        # a reused directory must not inherit a note that would name a dead
        # peer as arrived
        with contextlib.suppress(OSError):
            os.remove(_barrier_note(note_dir, tag, pid))


def _file_barrier(tag: str, note_dir: str, live: list[int] | None, pid: int, seq: int, hb=None) -> None:
    """Sentinel-note barrier over a process set: each member publishes its
    sequence number for `tag` and polls until every awaited peer's note
    reaches it. A note counts once seen (a member removes its notes only
    at a later stage's heartbeat start); notes older than this stage
    (faulttol.pod_t0, less a skew margin) never count. With `live` the
    awaited set is fixed and a no-show raises at the collective timeout;
    with `hb` it is ``hb.live``'s original members, re-read every poll,
    and a peer that stopped (or never started) beating is declared dead
    (``hb.maybe_check``) and dropped."""
    import time

    from drep_tpu_torch.parallel.faulttol import CollectiveTimeout, collective_timeout_s, heartbeat_cadence_s, pod_t0

    atomic_write_bytes(_barrier_note(note_dir, tag, pid), str(seq).encode())
    fresh_after = pod_t0() - 60.0
    timeout = collective_timeout_s()
    deadline = time.monotonic() + timeout if timeout > 0 else None
    seen: set[int] = set()
    while True:
        # joiners (ids >= the original process count) never run the
        # replicated control flow, so no barrier awaits them
        waiting_on = [p for p in hb.live if p < hb.pc] if hb is not None else live
        missing = []
        for p in waiting_on:
            if p == pid or p in seen:
                continue
            loc = _barrier_note(note_dir, tag, p)
            try:
                st = os.stat(loc)
                with open(loc) as f:
                    ok = int(f.read().strip()) >= seq and st.st_mtime >= fresh_after
            except (OSError, ValueError):
                ok = False
            if ok:
                seen.add(p)
            else:
                missing.append(p)
        if not missing:
            return
        if hb is not None:
            hb.maybe_check()
        if deadline is not None and time.monotonic() > deadline:
            raise CollectiveTimeout(
                f"checkpoint file barrier {tag!r}: process(es) {missing} of awaited set {waiting_on} never "
                f"arrived within {timeout:.0f}s and their heartbeats are "
                f"{'still fresh — wedged, not dead' if hb is not None else 'not monitored here'}. Restart the "
                f"pod; shard-level checkpoints will resume finished work."
            )
        time.sleep(min(1.0, max(0.05, heartbeat_cadence_s() / 5)))
