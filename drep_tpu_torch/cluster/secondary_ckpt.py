"""Per-primary-cluster checkpoints of the secondary (ANI) stage.

Counterpart of drep_tpu/cluster/secondary_ckpt.py, in its format: each
primary cluster's secondary result (Ndb rows, labels, linkage) is
published the moment it finishes as ``pc_%06d.npz`` (uncompressed) under
``<wd>/data/secondary_checkpoints/``, whose meta pins the clustering
arguments and the primary partition. A run killed in the secondary loop
resumes at the first unfinished cluster; a change of flags or of the
primary clusters clears the store. A store written by either package
resumes in the other.

The files are written off the stage's critical path. Serialising an npz
is Python work that holds the GIL (milliseconds a small cluster, seconds
for one of millions of Ndb rows), so a thread cannot hide it behind a
host-bound secondary loop: writer processes do it.
:meth:`SecondaryCheckpoint.start` launches ``WRITERS`` of them before the
loop (their imports take seconds). The caller pickles a save (a batch's
clusters; a fraction of the work of writing them) and hands it to an
idle writer, else waits for the writer whose save is oldest; a thread
waits on each save in flight for its reply. Until a writer has started,
saves are written in this process. One writer cannot keep up where the
loop makes small clusters faster than they are written, or where large
clusters follow each other. :meth:`SecondaryCheckpoint.close` (called by
``finish`` and by the controller when the stage fails) waits for every
save, raises the first error and stops the processes. A parent killed
mid-save leaves each process to finish its save, then it reads
end-of-file and exits; every file is published by an atomic rename, so
it is whole or absent. While fault injection is on (utils/faults.py) the
saves are written in this process, so that the spec's rules see every
write in the JAX package's order.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from typing import Any

import numpy as np
import pandas as pd

from drep_tpu_torch.utils import durableio, faults
from drep_tpu_torch.utils.ckptmeta import content_fingerprint, open_checkpoint_dir
from drep_tpu_torch.utils.logger import get_logger

# one save: the published path and the cluster's (ndb, labels, link)
_Save = tuple[str, pd.DataFrame, np.ndarray, np.ndarray]

# the package's parent directory, for the writer processes' imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# writer processes, each with one save in flight
WRITERS = 2


def _write(path: str, ndb: pd.DataFrame, labels: np.ndarray, link: np.ndarray) -> None:
    arrays: dict[str, np.ndarray] = {
        "labels": np.asarray(labels),
        "link": np.asarray(link),
        "ndb_columns": np.array(list(ndb.columns), dtype=str),
    }
    for c in ndb.columns:
        col = ndb[c].to_numpy()
        if col.dtype == object:
            col = col.astype(str)  # unicode arrays need no pickle
        arrays[f"ndb_col_{c}"] = col
    # uncompressed: thousands of small files a run, where zlib is the cost
    durableio.atomic_savez(path, compressed=False, **arrays)


def serve_writes() -> None:
    """The writer process: reads pickled ``(io_retries, fsync, saves)``
    jobs from stdin until end-of-file, writes each save, and answers each
    job on stdout with ``(error or None, seconds, fault counters moved)``."""
    from drep_tpu_torch.utils.profiling import counters

    replies = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # stray prints go to stderr, not into the replies
    faults.configure(None)  # the parent writes itself while injection is on
    pickle.dump((None, 0.0, {}), replies)  # started
    replies.flush()
    jobs = sys.stdin.buffer
    while True:
        try:
            retries, fsync, saves = pickle.load(jobs)
        except EOFError:
            return
        t0 = time.perf_counter()
        before = dict(counters.faults)
        err = None
        try:
            durableio.configure(retries=retries, fsync=fsync)
            for save in saves:
                _write(*save)
        except Exception as e:  # noqa: BLE001 — raised in the parent
            err = e
        moved = {k: v - before.get(k, 0) for k, v in counters.faults.items() if v != before.get(k, 0)}
        pickle.dump((err, time.perf_counter() - t0, moved), replies)
        replies.flush()


class _Writer:
    """One writer process (:func:`serve_writes`), a thread that waits for
    it to start, and the thread that waits for the reply to its save in
    flight."""

    def __init__(self) -> None:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "from drep_tpu_torch.cluster.secondary_ckpt import serve_writes; serve_writes()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
        )
        self.ready = threading.Event()
        self.sender: threading.Thread | None = None
        self.submitted = 0  # the order of its save in flight among the writers'
        self.reply: tuple = (None, 0.0, {})
        self._starter = threading.Thread(target=self._await_start, name="drep-secondary-ckpt-start")
        self._starter.start()

    def _await_start(self) -> None:
        try:
            pickle.load(self.proc.stdout)  # its first reply: started
        except (OSError, EOFError, pickle.UnpicklingError):
            return  # never ready: the store writes in its own process
        self.ready.set()

    def idle(self) -> bool:
        return self.ready.is_set() and (self.sender is None or not self.sender.is_alive())

    def submit(self, job: bytes, order: int) -> None:
        self.submitted = order
        self.sender = threading.Thread(target=self._send, args=(job,), name="drep-secondary-ckpt")
        self.sender.start()

    def _send(self, job: bytes) -> None:
        try:
            self.proc.stdin.write(job)
            self.proc.stdin.flush()
            self.reply = pickle.load(self.proc.stdout)
        except (OSError, EOFError) as e:
            self.reply = (RuntimeError(f"secondary checkpoint writer process failed: {e!r}"), 0.0, {})

    def stop(self) -> int:
        """End-of-file to a started process (it exits after its save); a
        process still starting has nothing to finish and is killed."""
        killed = not self.ready.is_set()
        if killed:
            self.proc.kill()
        self.proc.stdin.close()
        rc = self.proc.wait()
        self._starter.join()
        self.proc.stdout.close()
        return 0 if killed else rc


class SecondaryCheckpoint:
    """The cluster-granular store; a no-op where `ckpt_dir` is None.
    ``write_s`` is the seconds spent writing (in the writer processes, or
    here while injection is on), ``wait_s`` the caller's seconds blocked
    on them."""

    def __init__(self, ckpt_dir: str | None, snapshot: dict[str, Any], primary: np.ndarray, names: list[str]):
        self.dir = ckpt_dir
        self.n_resumed = 0
        self.write_s = 0.0
        self.wait_s = 0.0
        self._writers: list[_Writer] = []
        self._submitted = 0
        if ckpt_dir is None:
            return
        meta = {
            # format 2: npz payloads (format 1 was pickle, whose shards the
            # bump clears)
            "format": 2,
            "snapshot": json.loads(json.dumps(snapshot, sort_keys=True, default=str)),
            "fingerprint": content_fingerprint(names, np.asarray(primary, dtype=np.int64)),
        }
        open_checkpoint_dir(ckpt_dir, meta, clear_suffixes=(".npz", ".pkl"))

    def _loc(self, pc: int) -> str:
        return os.path.join(self.dir, f"pc_{pc:06d}.npz")

    def load(self, pc: int):
        """(ndb, labels, link) of a finished cluster, or None."""
        if self.dir is None:
            return None
        loc = self._loc(pc)
        if not os.path.exists(loc):
            return None

        def convert(z):
            cols = [str(c) for c in z["ndb_columns"]]
            ndb = pd.DataFrame({c: z[f"ndb_col_{c}"] for c in cols})
            return ndb, z["labels"], z["link"]

        result = durableio.load_npz_or_none(
            loc, what="secondary checkpoint", convert=convert,
            warn="secondary checkpoint: unreadable %s — recomputing",
        )
        if result is not None:
            self.n_resumed += 1  # only once the payload validates
        return result

    def save(self, pc: int, ndb: pd.DataFrame, labels: np.ndarray, link: np.ndarray) -> None:
        """:meth:`save_many` of one cluster."""
        self.save_many([(pc, ndb, labels, link)])

    def start(self) -> None:
        """Launch the writer processes (in the background), where there is
        a store, none runs yet and injection is off."""
        if self.dir is not None and not self._writers and not faults.active():
            self._writers = [_Writer() for _ in range(WRITERS)]

    def save_many(self, results: list[tuple[int, pd.DataFrame, np.ndarray, np.ndarray]]) -> None:
        """Publish each ``(pc, ndb, labels, link)`` of `results` (one save:
        a batch's clusters) on a writer process, or here until one has
        started."""
        if self.dir is None or not results:
            return
        saves: list[_Save] = [(self._loc(pc), ndb, labels, link) for pc, ndb, labels, link in results]
        self.start()
        writer = next((w for w in self._writers if w.idle()), None)
        if writer is None:
            in_flight = [w for w in self._writers if w.sender is not None]
            writer = min(in_flight, key=lambda w: w.submitted) if in_flight else None
        if writer is None or faults.active():
            self.flush()
            t0 = time.perf_counter()
            try:
                for save in saves:
                    _write(*save)
            finally:
                self.write_s += time.perf_counter() - t0
            return
        job = pickle.dumps((durableio.io_retries(), durableio.fsync_enabled(), saves), protocol=pickle.HIGHEST_PROTOCOL)
        self._collect(writer)
        self._submitted += 1
        writer.submit(job, self._submitted)

    def _collect(self, writer: _Writer) -> None:
        """Wait for `writer`'s save in flight, book it, raise its error."""
        if writer.sender is None:
            return
        from drep_tpu_torch.utils.profiling import counters

        t0 = time.perf_counter()
        writer.sender.join()
        self.wait_s += time.perf_counter() - t0
        writer.sender = None
        err, seconds, moved = writer.reply
        self.write_s += seconds
        for kind, n in moved.items():  # the process's I/O retries, booked here
            counters.add_fault(kind, n)
        if err is not None:
            raise err

    def flush(self) -> None:
        """Wait for every save in flight; raise the first error."""
        errors = []
        for writer in self._writers:
            try:
                self._collect(writer)
            except Exception as e:  # noqa: BLE001 — the rest are still collected
                errors.append(e)
        if errors:
            raise errors[0]

    def close(self) -> None:
        """:meth:`flush`, then stop the writer processes."""
        try:
            self.flush()
        finally:
            writers, self._writers = self._writers, []
            rcs = [w.stop() for w in writers]
            if any(rcs):
                raise RuntimeError(f"secondary checkpoint writer processes exited with {rcs}")

    def finish(self, n_total: int) -> None:
        if self.dir is None:
            return
        self.close()
        if self.n_resumed:
            get_logger().info("secondary: resumed %d/%d primary clusters from checkpoints", self.n_resumed, n_total)
