"""Mesh-sharded all-pairs comparison: the dense ring.

Counterpart of drep_tpu/parallel/allpairs.py. Genomes are
row-sharded over the D positions of a mesh (parallel/mesh.py): position m
holds A block m and a B operand that starts as its own block and moves one
hop around the ring each step, so at step i position m computes block
(m, (m - i) mod D).

Half-ring schedule: both tiles are symmetric (tile(A, B) == tile(B, A).T),
so only ``D // 2 + 1`` of the D steps run; for even D the last (middle)
step is self-paired across the two halves of the ring and only positions
m < D/2 keep it. The host mirrors the transposed blocks into the rest.
``full_grid=True`` runs all D steps (the equality reference).

Every step of every position is one launch of the fused kernel
(ops/ring.py), which computes the tile and writes the B operand into the
neighbour's receive buffer: ``csrc/ring_step.cu`` (the merge variant), or,
for a containment ring under the matmul variant (``variant``, by default
ops/ring.py::pick_variant on the ring's v_pad and width),
``csrc/ring_step_mm.cu``. The final step has nothing to rotate and runs
the same kernel without the copy (the JAX package runs a plain XLA
program there; both tiles are equal on dense ranks). Every launch is
issued up front (:func:`_launch_steps`); the host then takes the steps in
order. The JAX package's one-program (monolithic) ring and its rotation
backends are not carried over: the port has this one step-wise ring,
whose matrices are held against the single-device ones.

The block store (the JAX package's format): with a store, each step's
blocks are published as ``blk_AAA_BBB.npz`` (``o0``: the float32 block,
distance or |A ∩ B|; ``.eNN`` in the name once a pod's membership
changed) under ``<root>/ring_<kind>_k<k>_d<D>_<fingerprint>`` beside a
meta.json pinning kind, k, n, D, the schedule and the inputs. The root is
the run's ``data/dense_ring`` (:func:`configure_ring`, set by the
cluster controller). A rerun resumes the blocks found, and every block
still missing — a resume's gaps, a failed step, a dead member's share —
is recomputed on its own by the ring's own kernel without its copy,
through faulttol.TileExecutor over this process's positions (retries, no
CPU fallback), bit-identically; a corrupt block is recomputed into its
own path.

On a pod (parallel/mesh.py) each member runs its own positions' steps.
A hop between two of its positions keeps the fused copy; a hop into
another member's position is not taken: the next position reads its B
block from its own host copy of the pack (every member holds the whole
pack), so no device bytes cross processes. With a store and heartbeats
the ring is elastic: between steps a death verdict (or a drain) ends the
step loop, the missing blocks are dealt over the live members (each
block to its ring owner while that member is live, else by schedule
index), a drain is honoured at step and block boundaries, an admitted
joiner works the schedule's tail under the store's D, and completion is
file-based. Without a store the members exchange their rows over gloo
(:func:`_exchange_rows_no_store`). A replicated local ring on a pod (the
secondary's) keeps no store.

With tracing on (utils/telemetry.py) each step is a ``ring_step`` span
around its wait and publish, each published block a ``blk_publish``
instant, each recovered block a ``ring_block_recover`` span, and the
pod's re-deals ``re_deal`` instants, as in the JAX package. The fault
sites ``ring_step`` (each step boundary) and ``ring_dispatch`` (each
step's wait and each recovery launch) fire where the JAX package's do.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import numpy as np
import torch

from drep_tpu_torch.ops.containment import ani_cov_from_intersections
from drep_tpu_torch.ops.mash import shared_counts_to_distance
from drep_tpu_torch.ops.minhash import PackedSketches, ids_to_device, pad_packed_rows, require_int32_ids
from drep_tpu_torch.ops.ring import (
    MATMUL_TILE_KINDS,
    check_variant,
    matmul_ring_vocab_pad,
    pick_variant,
    ring_step,
    ring_step_matmul,
)
from drep_tpu_torch.parallel.mesh import Mesh
from drep_tpu_torch.utils import telemetry

# the per-step watchdog's warmup: only the first step's wait is excluded
# (a half ring has too few steps to discard the default eight)
RING_STEP_WARMUP = 1


def half_ring_steps(n_devices: int) -> int:
    """Ring steps the triangular schedule runs: ceil((D+1)/2) of D."""
    return n_devices // 2 + 1


def ring_tiles_computed(n_devices: int, half: bool) -> int:
    """Unique block tiles the schedule produces (D*(D+1)/2 when half: the
    even-D middle step contributes only its canonical device half)."""
    if half:
        return n_devices * (n_devices + 1) // 2
    return n_devices * n_devices


def _ring_block_computed(a: int, b: int, n_devices: int) -> bool:
    """Whether the half-ring schedule stored block (row a, col b): device a
    computes column block (a - i) mod D at step i, steps 0..n_steps-1, with
    the even-D middle step kept only on devices a < D/2."""
    i = (a - b) % n_devices
    n_steps = half_ring_steps(n_devices)
    if i >= n_steps:
        return False
    if n_devices % 2 == 0 and n_devices > 1 and i == n_devices // 2:
        return a < n_devices // 2
    return True


def mirror_half_ring(mat: np.ndarray, n_devices: int) -> None:
    """Fill the blocks the half-ring schedule skipped with the transpose of
    their computed twins, in place. `mat` is the gathered [n_pad, n_pad]
    matrix (n_pad a multiple of n_devices)."""
    n_local = mat.shape[0] // n_devices
    for a in range(n_devices):
        for b in range(n_devices):
            if a == b or _ring_block_computed(a, b, n_devices):
                continue
            assert _ring_block_computed(b, a, n_devices), "schedule hole"
            ra = slice(a * n_local, (a + 1) * n_local)
            rb = slice(b * n_local, (b + 1) * n_local)
            mat[ra, rb] = mat[rb, ra].T


def ring_schedule(n_devices: int, half: bool) -> list[tuple[int, int]]:
    """The ordered block list the schedule stores: (row block a, col block
    b) pairs, canonical (a-major) order."""
    return [
        (a, b)
        for a in range(n_devices)
        for b in range(n_devices)
        if not half or _ring_block_computed(a, b, n_devices)
    ]


def ring_step_of(a: int, b: int, n_devices: int) -> int:
    """The ring step that produces block (a, b): device `a` computes
    column block ``(a - i) mod D`` at step `i`."""
    return (a - b) % n_devices


def _finish_mash(tile: np.ndarray, ca: np.ndarray, cb: np.ndarray, packed: PackedSketches, k: int) -> np.ndarray:
    """A block's shared counts -> float32 distance, the single-device
    transform (elementwise, so a block's values are the matrix's)."""
    dist, _j = shared_counts_to_distance(tile, ca, cb, packed.sketch_size, k)
    return dist


def _finish_containment(tile: np.ndarray, ca: np.ndarray, cb: np.ndarray, packed: PackedSketches,
                        k: int) -> np.ndarray:
    """|A ∩ B| as float32 (exact: every count is far below 2^24)."""
    del ca, cb, packed, k
    return tile.astype(np.float32)


# kind -> host transform of a block's int32 tile into the float32 block the
# store holds (the JAX package's block payload ``o0``). Both tiles are
# symmetric, which the half-ring host mirror depends on.
_TILE_KINDS = {"mash": _finish_mash, "containment": _finish_containment}


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


# -- the block store ---------------------------------------------------------

# the run-wide block-store root, set once a run by the cluster controller
# (``<wd>/data/dense_ring``); ring calls deep inside the engines cannot
# thread a workdir down
_RING_CONFIG: dict = {"checkpoint_base": None}


def configure_ring(checkpoint_base: str | None = None) -> None:
    """Install the run-wide root of the ring's block stores (None: rings
    keep their blocks in memory). Replaces the whole config."""
    _RING_CONFIG["checkpoint_base"] = checkpoint_base


def _block_name(a: int, b: int, epoch: int) -> str:
    """Block (a, b)'s shard file name, epoch-stamped as the streaming
    shards: ``blk_AAA_BBB.npz``, ``blk_AAA_BBB.eNN.npz`` once a pod's
    membership changed."""
    base = f"blk_{a:03d}_{b:03d}"
    return f"{base}.npz" if epoch == 0 else f"{base}.e{epoch:02d}.npz"


def _find_block(checkpoint_dir: str, a: int, b: int) -> str | None:
    """The shard of block (a, b) under any ownership epoch, or None."""
    loc = os.path.join(checkpoint_dir, _block_name(a, b, 0))
    if os.path.exists(loc):
        return loc
    hits = sorted(glob.glob(os.path.join(checkpoint_dir, f"blk_{a:03d}_{b:03d}.e*.npz")))
    return hits[0] if hits else None


def _load_block(path: str, n_outputs: int = 1):
    """The block's `n_outputs` arrays, or None when it reads corrupt
    (warned, counted, removed: the block is recomputed into its path)."""
    from drep_tpu_torch.utils.durableio import load_npz_or_none

    return load_npz_or_none(
        path, what="ring block shard",
        convert=lambda z: tuple(z[f"o{i}"] for i in range(n_outputs)),
        warn="dense ring: corrupt block shard %s — recomputing",
    )


def _ring_store_dir(kind: str, k: int, n_devices: int, fingerprint: str) -> str | None:
    """A ring call's store under the configured root (None without one):
    one subdirectory a (kind, D, input fingerprint), so interleaved rings
    (one a secondary cluster) never invalidate each other's blocks."""
    base = _RING_CONFIG["checkpoint_base"]
    if base is None:
        return None
    return os.path.join(base, f"ring_{kind}_k{k}_d{n_devices}_{fingerprint[:12]}")


def _read_ring_meta(store: str) -> dict | None:
    """The store's meta.json, or None while it is missing or corrupt (a
    joiner polls it: the pod writes it at its store open)."""
    from drep_tpu_torch.parallel.faulttol import read_pod_note

    return read_pod_note(os.path.join(store, "meta.json"), what="ring store meta")


# -- the ring ----------------------------------------------------------------


def _launch_steps(ids: np.ndarray, counts: np.ndarray, kind: str, mesh: Mesh, n_local: int, n_steps: int,
                  keep: set, variant: str, v_pad: int) -> list[list[tuple[int, int, torch.Tensor]]]:
    """Every step of this process's positions, issued up front: per step,
    [(row block, col block, int32 tile on the position's device)].

    Position m holds A block m and, at step i, B block (m - i) mod D. The
    fused step writes B into the next position's receive buffer where that
    position is this process's; a hop to another process's position is
    not taken: there the step runs without its copy, and the next position
    reads its B block from its own copy of the host pack. Every rotation
    lands in a fresh buffer allocated before the first launch, so no step
    writes a buffer that another still reads. Each card runs its positions
    on its current stream; where neighbouring positions sit on different
    cards, an event orders each step after the step that wrote its B."""
    D = mesh.size
    width = ids.shape[1]
    mine = set(mesh.local_positions())

    def host_block(m: int, j: int) -> tuple[torch.Tensor, torch.Tensor]:
        rows = slice(j * n_local, (j + 1) * n_local)
        dev = mesh.devices[m]
        return ids_to_device(ids[rows], dev), torch.from_numpy(np.ascontiguousarray(counts[rows])).to(dev)

    a_blk = {m: host_block(m, m) for m in mine}
    # recv[i][m]: position m's B after step i, on position m+1's device,
    # where m+1 is this process's
    recv = [
        {
            m: tuple(torch.empty(shape, dtype=torch.int32, device=mesh.devices[(m + 1) % D])
                     for shape in ((n_local, width), (n_local,)))
            for m in mine if (m + 1) % D in mine
        }
        for _ in range(n_steps - 1)
    ]
    cards = {mesh.devices[m] for m in mine if mesh.devices[m].type == "cuda"}
    multi = len(cards) > 1
    if multi:
        # a peer writes into buffers the caching allocator handed out on
        # another card's stream: let that card's earlier work finish first
        for c in cards:
            torch.cuda.synchronize(c)
    b = dict(a_blk)
    done: dict = {}  # event after each position's previous step
    steps = []
    for i in range(n_steps):
        nxt: dict = {}
        ev: dict = {}
        tiles = []
        for m in sorted(mine):
            col = (m - i) % D
            if m not in b:
                b[m] = host_block(m, col)  # the hop into m crosses processes
            if (m, col) not in keep:
                continue  # the even-D middle step's second half: its twin is kept
            dst = recv[i].get(m) if i < n_steps - 1 else None
            dev = mesh.devices[m]
            with _on(dev):
                src = (m - 1) % D
                if multi and done.get(src) is not None and mesh.devices[src] != dev:
                    torch.cuda.current_stream(dev).wait_event(done[src])
                if variant == "matmul":
                    tile = ring_step_matmul(*a_blk[m], *b[m], v_pad, *(dst or (None, None)))
                else:
                    tile = ring_step(kind, *a_blk[m], *b[m], *(dst or (None, None)))
                tiles.append((m, col, tile))
                if multi:
                    ev[m] = torch.cuda.Event()
                    ev[m].record(torch.cuda.current_stream(dev))
            if dst is not None:
                nxt[(m + 1) % D] = dst
        steps.append(tiles)
        b, done = nxt, ev
    return steps


def _ring_stepwise(packed: PackedSketches, kind: str, k: int, mesh: Mesh, half: bool, variant: str,
                   v_pad: int, checkpoint_dir: str | None, ft_config) -> tuple[np.ndarray, int]:
    """The ring, step by step, with its block store and the elastic pod
    (module docstring): (the assembled, mirrored float32 [n_pad, n_pad]
    matrix, the blocks this process computed)."""
    from drep_tpu_torch.parallel.faulttol import (
        DEFAULT_ALLGATHER_TIMEOUT_S,
        DEFAULT_CONFIG,
        AutoTimeout,
        CollectiveTimeout,
        FaultTolError,
        HeartbeatManager,
        PodDrained,
        TileExecutor,
        WatchdogTimeout,
        _watchdog_run,
        collective_timeout_s,
        drain_requested,
        heartbeat_cadence_s,
        join_elastic_pod,
        join_requested,
        wait_elastic,
    )
    from drep_tpu_torch.parallel.mesh import process_count, process_index
    from drep_tpu_torch.utils import faults
    from drep_tpu_torch.utils.ckptmeta import content_fingerprint
    from drep_tpu_torch.utils.durableio import atomic_savez
    from drep_tpu_torch.utils.logger import get_logger
    from drep_tpu_torch.utils.profiling import counters

    logger = get_logger()
    cfg = ft_config if ft_config is not None else DEFAULT_CONFIG
    finish = _TILE_KINDS[kind]
    D = mesh.size
    pid, pc = process_index(), process_count()
    pod_ring = mesh.spans_processes

    fp = None
    store = checkpoint_dir
    if store is not None or _RING_CONFIG["checkpoint_base"] is not None:
        fp = content_fingerprint(packed.names, packed.counts, packed.ids)
        if store is None:
            store = _ring_store_dir(kind, k, D, fp)
    if store is not None and pc > 1 and not pod_ring:
        # a replicated local ring on a pod (the secondary's): a shared store
        # would put pod barriers inside per-member retries; every member
        # computes the same numbers on its own positions
        store = None

    hb = None
    resume = False
    # a join is honoured only on an explicit store (the pod's shared one):
    # a joiner's other rings compute normally
    joining = checkpoint_dir is not None and join_requested() is not None
    if joining and heartbeat_cadence_s() <= 0:
        from drep_tpu_torch.errors import UserInputError

        raise UserInputError(
            "DREP_TORCH_POD_JOIN is set but heartbeats are disabled (DREP_TORCH_HEARTBEAT_S=0) — ring "
            "admission rides the heartbeat protocol. Unset DREP_TORCH_POD_JOIN to run standalone, or "
            "re-enable heartbeats."
        )
    if joining:
        # a joiner is outside the pod's mesh: it works the per-block
        # completion under the pod's geometry (D from the store's meta)
        want = {"kind": kind, "k": k, "n": packed.n, "half": half, "schedule": "stepwise1", "fingerprint": fp}

        def _meta_ok() -> bool:
            stored = _read_ring_meta(store)
            return stored is not None and all(stored.get(kk) == vv for kk, vv in want.items())

        hb = join_elastic_pod(store, heartbeat_cadence_s(), config=cfg, what="dense ring (mid-run join)",
                              validate=_meta_ok)
        stored_meta = _read_ring_meta(store)
        if stored_meta is None:
            hb.close()
            raise FaultTolError(f"dense ring join: block store meta at {store} disappeared after admission — "
                                f"the pod's store was cleared mid-join")
        D = int(stored_meta["n_devices"])
        pid, pc = hb.pid, hb.pc
        resume = True

    ids, counts = pad_packed_rows(packed.ids, packed.counts, D)
    n_pad = ids.shape[0]
    n_local = n_pad // D
    n_steps = half_ring_steps(D) if half else D
    schedule = ring_schedule(D, half)
    sched_idx = {blk: i for i, blk in enumerate(schedule)}

    if store is not None and not joining:
        cadence = heartbeat_cadence_s()
        if cadence > 0:
            # before the store's open barrier, which it makes heartbeat-aware
            hb = HeartbeatManager(store, cadence, max_dead=cfg.max_dead_processes, max_joins=cfg.max_joins,
                                  pc=pc, pid=pid)
            hb.start()
        meta = {"kind": kind, "k": k, "n": packed.n, "n_devices": D, "half": half, "schedule": "stepwise1",
                "fingerprint": fp}
        from drep_tpu_torch.utils.ckptmeta import open_checkpoint_dir

        try:
            resume = open_checkpoint_dir(store, meta, clear_suffixes=(".npz",))
        except BaseException:
            if hb is not None:
                hb.close()
            raise

    elastic = joining or (hb is not None and pc > 1 and pod_ring)
    mem: dict[tuple[int, int], tuple] = {}
    shard_of: dict[tuple[int, int], str] = {}
    n_computed = 0

    def _maybe_drain() -> None:
        if hb is None or not drain_requested():
            return
        hb.announce_drain(pairs=n_computed)
        raise PodDrained(
            f"dense ring: process {pid} drained at a step/block boundary (planned-departure note published "
            f"with {n_computed} computed block(s); peers re-deal its unfinished blocks immediately)"
        )

    def _missing_blocks() -> list[tuple[int, int]]:
        out = []
        for blk in schedule:
            if blk in mem or blk in shard_of:
                continue
            if store is not None:
                loc = _find_block(store, *blk)
                if loc is not None:
                    shard_of[blk] = loc
                    continue
            out.append(blk)
        return out

    def _save_block(blk: tuple[int, int], tiles: tuple, epoch: int) -> None:
        if store is None:
            return
        path = os.path.join(store, _block_name(blk[0], blk[1], epoch))
        atomic_savez(path, **{f"o{oi}": t for oi, t in enumerate(tiles)})
        shard_of[blk] = path
        telemetry.event("blk_publish", shard=_block_name(blk[0], blk[1], epoch))

    def _finish(a: int, b: int, tile: np.ndarray) -> tuple:
        rows_a = slice(a * n_local, (a + 1) * n_local)
        rows_b = slice(b * n_local, (b + 1) * n_local)
        return (finish(tile, counts[rows_a], counts[rows_b], packed, k),)

    def _join_covered_tail(step_i: int) -> bool:
        """Has an admitted joiner made every block past `step_i` durable?"""
        if hb is None or not hb.joined or hb.dead or hb.drained or store is None or step_i >= n_steps - 1:
            return False
        for blk in schedule:
            if ring_step_of(*blk, D) <= step_i or blk in mem or blk in shard_of:
                continue
            loc = _find_block(store, *blk)
            if loc is None:
                return False
            shard_of[blk] = loc
        return True

    def _deal_block(blk: tuple[int, int], live: list[int]) -> int:
        """Who computes a missing block now: its ring owner while that
        member is live and unfinished (its own steps produce the block),
        else the schedule-index deal over the live set, the JAX package's
        (a pod whose members never wait on each other's steps would
        otherwise compute a slow peer's blocks twice)."""
        owner = mesh.proc_of(blk[0]) if pod_ring else None
        if owner is not None and owner in live and (owner == pid or not hb.peer_finished(owner)):
            return owner
        return live[sched_idx[blk] % len(live)]

    # the per-block redoable unit: the ring's own kernel without its copy,
    # round robin over this process's positions, retried, no CPU fallback
    ex: TileExecutor | None = None
    local = mesh.local_positions() if not joining else []
    slots = [mesh.devices[m] for m in local] or [mesh.devices[0]]

    def _compute_block(blk: tuple[int, int], tail_step: int | None = None) -> tuple:
        nonlocal ex, n_computed
        n_computed += 1
        if ex is None:
            ex = TileExecutor(slots, cfg)
        a, b = blk
        if tail_step is not None:
            # a joiner's share of ring step `tail_step`
            with telemetry.span("ring_step", step=tail_step, steps=n_steps, joiner=True, block=f"{a},{b}"):
                out = _compute_block_tiles(a, b)
            counters.add_fault("ring_join_tail_blocks")
            return out
        with telemetry.span("ring_block_recover", a=a, b=b):
            return _compute_block_tiles(a, b)

    def _compute_block_tiles(a: int, b: int) -> tuple:
        def compute(slot: int) -> np.ndarray:
            dev = slots[slot]
            rows_a = slice(a * n_local, (a + 1) * n_local)
            rows_b = slice(b * n_local, (b + 1) * n_local)
            args = (ids_to_device(ids[rows_a], dev), torch.from_numpy(np.ascontiguousarray(counts[rows_a])).to(dev),
                    ids_to_device(ids[rows_b], dev), torch.from_numpy(np.ascontiguousarray(counts[rows_b])).to(dev))
            with _on(dev):
                tile = ring_step_matmul(*args, v_pad) if variant == "matmul" else ring_step(kind, *args)
                return tile.cpu().numpy()

        out = _finish(a, b, ex.run(compute))
        counters.add_fault("ring_blocks_recovered")
        return out

    try:
        missing0 = set(_missing_blocks() if resume else schedule)
        # the step loop runs only where none of this process's ring blocks
        # (the rows of its positions) is in the store yet and the pod is
        # whole; a partial resume, an inherited degradation or a joiner goes
        # straight to the per-block path. Only this process's own blocks
        # decide: a peer's, published while this process passed the store's
        # barrier, are no resume (the members' steps never wait on each other)
        own = [blk for blk in schedule if blk[0] in set(local)]
        run_ring = bool(own) and all(blk in missing0 for blk in own) and (hb is None or not hb.dead) \
            and not joining
        aborted = None
        if run_ring:
            auto = AutoTimeout(cfg, warmup=RING_STEP_WARMUP)
            keep = set(schedule)
            try:
                pending = _launch_steps(ids, counts, kind, mesh, n_local, n_steps, keep, variant, v_pad)
            except Exception as e:  # noqa: BLE001 — the per-block path recomputes
                counters.add_fault("ring_step_failures")
                logger.warning("dense ring: launching the steps failed (%s) — recomputing its blocks per-tile", e)
                pending, aborted = [], e
            for i, tiles in enumerate(pending):
                if aborted is not None:
                    break
                # the span opens before the fault fires, so a member killed at
                # the boundary leaves its unclosed "B" as the crash evidence
                with telemetry.span("ring_step", step=i, steps=n_steps):
                    faults.fire("ring_step")
                    t0 = time.perf_counter()

                    def wait(tiles=tiles) -> list[np.ndarray]:
                        faults.fire("ring_dispatch")
                        return [t.cpu().numpy() for _m, _c, t in tiles]

                    try:
                        if elastic:
                            ok, host = wait_elastic(wait, hb, collective_timeout_s(),
                                                    what=f"dense ring step {i + 1}/{n_steps} ({kind})",
                                                    site="ring_dispatch", join_tolerant=True)
                            if not ok:
                                aborted = "pod membership changed"
                                break
                        else:
                            timeout = auto.effective()
                            host = wait() if timeout <= 0 else _watchdog_run(
                                wait, timeout, what="ring_dispatch: a ring step's wait", site="ring_dispatch")
                    except WatchdogTimeout as e:
                        counters.add_fault("ring_step_failures")
                        logger.warning("dense ring: step %d/%d tripped the %ss watchdog — recomputing its "
                                       "blocks per-tile", i + 1, n_steps, round(auto.effective(), 1))
                        aborted = e
                        break
                    except (CollectiveTimeout, FaultTolError):
                        raise
                    except Exception as e:  # noqa: BLE001 — per-block recovery
                        counters.add_fault("ring_step_failures")
                        logger.warning("dense ring: step %d/%d failed (%s) — recomputing its blocks per-tile",
                                       i + 1, n_steps, e)
                        aborted = e
                        break
                    auto.note(time.perf_counter() - t0)
                    for (m, col, _t), tile in zip(tiles, host):
                        mem[(m, col)] = _finish(m, col, tile)
                        n_computed += 1
                        _save_block((m, col), mem[(m, col)], hb.epoch if hb is not None else 0)
                    _maybe_drain()  # this step's blocks are durable: a safe exit
                if elastic:
                    ep, gone = hb.epoch, (len(hb.dead), len(hb.drained))
                    hb.maybe_check()  # the death verdict between steps
                    if hb.epoch != ep and (len(hb.dead), len(hb.drained)) != gone:
                        aborted = "pod membership changed"
                        break
                if aborted is None and _join_covered_tail(i):
                    telemetry.event("ring_join_shortcut", after_step=i, steps=n_steps, joined=list(hb.joined))
                    counters.add_fault("ring_join_shortcuts")
                    logger.info("dense ring: joiner(s) %s covered every block past step %d/%d — ending the "
                                "ring early", hb.joined, i + 1, n_steps)
                    break
            derived = auto.derived()
            if derived is not None:
                counters.set_gauge("derived_ring_step_timeout_s", round(derived, 3))

        if pc > 1 and pod_ring and store is None:
            # a store-less pod ring: the rows come over gloo instead
            if aborted is not None:
                raise FaultTolError(
                    f"dense ring: a ring step failed on a multi-process pod with no shared block store — "
                    f"per-block recovery needs one (configure_ring / checkpoint_dir). Original failure: "
                    f"{aborted!r}"
                ) from (aborted if isinstance(aborted, BaseException) else None)
            _exchange_rows_no_store(mem, mesh, schedule, n_local, n_pad, pid, kind)

        if not elastic:
            for blk in _missing_blocks():
                mem[blk] = _compute_block(blk)
                _save_block(blk, mem[blk], hb.epoch if hb is not None else 0)
                _maybe_drain()
        else:
            stall_budget = collective_timeout_s(DEFAULT_ALLGATHER_TIMEOUT_S)
            done_written = False
            last_progress = time.monotonic()
            progress_sig = None
            last_deal_epoch = -1
            while True:
                _maybe_drain()
                live = list(hb.live)
                missing = _missing_blocks()
                if hb.epoch != last_deal_epoch:
                    if hb.epoch > 0:
                        telemetry.event("re_deal", unit="ring_block", live=live, missing=len(missing))
                    last_deal_epoch = hb.epoch
                computed = False
                tail_mode = joining and not hb.dead and not hb.drained
                if tail_mode:
                    # a joiner works the schedule's tail, reversed, split over
                    # the joiners, and meets the advancing ring in the middle
                    joiners = sorted(p for p in live if p >= pc) or [pid]
                    rank = joiners.index(pid) if pid in joiners else 0
                    claim = [blk for r, blk in enumerate(reversed(missing)) if r % len(joiners) == rank]
                else:
                    claim = [blk for blk in missing if _deal_block(blk, live) == pid]
                for blk in claim:
                    computed = True
                    mem[blk] = _compute_block(blk, tail_step=ring_step_of(*blk, D) if tail_mode else None)
                    missing.remove(blk)
                    _save_block(blk, mem[blk], hb.epoch)
                    _maybe_drain()
                    if tail_mode or hb.maybe_check():
                        break
                if not missing and not done_written:
                    hb.mark_done(len(mem))
                    done_written = True
                sig = (len(missing), tuple(hb.live))
                if computed or sig != progress_sig:
                    progress_sig = sig
                    last_progress = time.monotonic()
                if not missing:
                    break
                if hb.maybe_check():
                    continue
                if time.monotonic() - last_progress > stall_budget:
                    raise CollectiveTimeout(
                        f"dense ring completion stalled for {stall_budget:.0f}s: block(s) {missing[:8]}"
                        f"{'...' if len(missing) > 8 else ''} unfinished on live set {hb.live} whose heartbeats "
                        f"are still fresh — a peer is wedged, not dead. Restart the pod; block-level "
                        f"checkpoints will resume finished work."
                    )
                if not computed:
                    time.sleep(min(5.0, max(0.05, hb.cadence)))

        # assembly in schedule order: own blocks from memory, the rest from
        # the store; a corrupt or vanished shard is recomputed into its path
        mat = np.zeros((n_pad, n_pad), np.float32)
        for blk in schedule:
            tiles = mem.get(blk)
            if tiles is None:
                path = shard_of.get(blk) or (_find_block(store, *blk) if store is not None else None)
                tiles = _load_block(path) if path is not None else None
                if tiles is None:
                    from drep_tpu_torch.parallel.streaming import _shard_epoch

                    heal_epoch = _shard_epoch(path) if path is not None else (hb.epoch if hb is not None else 0)
                    tiles = _compute_block(blk)
                    mem[blk] = tiles
                    _save_block(blk, tiles, heal_epoch)
            a, b = blk
            mat[a * n_local : (a + 1) * n_local, b * n_local : (b + 1) * n_local] = tiles[0]
        if half:
            mirror_half_ring(mat, D)

        if hb is not None and hb.epoch > 0:
            if elastic:
                from drep_tpu_torch.utils.ckptmeta import stamp_checkpoint_meta

                stamp = {"pod_epochs": hb.epoch + 1, "dead_processes": hb.dead}
                if hb.drained:
                    stamp["planned_departures"] = hb.drained
                if hb.joined:
                    stamp["pod_joins"] = len(hb.joined)
                stamp_checkpoint_meta(store, stamp)
            logger.warning(
                "dense ring: completed with MEMBERSHIP CHURN — dead %s, drained %s, joined %s; final members %s "
                "covered the missing blocks per-tile across %d ownership epoch(s)",
                hb.dead, hb.drained, hb.joined, hb.live, hb.epoch + 1,
            )
        return mat, n_computed
    finally:
        if hb is not None:
            hb.close()


def _exchange_rows_no_store(mem: dict, mesh: Mesh, schedule, n_local: int, n_pad: int, pid: int,
                            kind: str) -> None:
    """A store-less pod ring's completion: each member's block rows over
    gloo (equal shapes: make_mesh splits the positions evenly), peers'
    blocks placed into `mem` — the same host values a store would have
    round-tripped."""
    from drep_tpu_torch.parallel.faulttol import DEFAULT_ALLGATHER_TIMEOUT_S, collective_timeout_s, run_with_timeout
    from drep_tpu_torch.parallel.mesh import allgather_array

    proc_rows: dict[int, list[int]] = {}
    for m in range(mesh.size):
        proc_rows.setdefault(mesh.proc_of(m), []).append(m)
    mine = proc_rows.get(pid, [])
    by_row: dict[int, list[tuple[int, int]]] = {}
    for a, b in schedule:
        by_row.setdefault(a, []).append((a, b))
    rows = np.zeros((len(mine), n_local, n_pad), np.float32)
    for ri, m in enumerate(mine):
        for a, b in by_row.get(m, ()):
            rows[ri][:, b * n_local : (b + 1) * n_local] = mem[(a, b)][0]
    got = run_with_timeout(
        lambda: allgather_array(rows.ravel()), what=f"dense ring row exchange ({kind})", site="allgather",
        timeout_s=collective_timeout_s(DEFAULT_ALLGATHER_TIMEOUT_S),
    )
    for p, rows_p in sorted(proc_rows.items()):
        if p == pid:
            continue
        g = got[p].reshape(len(rows_p), n_local, n_pad)
        for ri, m in enumerate(rows_p):
            for a, b in by_row.get(m, ()):
                mem[(a, b)] = (g[ri][:, b * n_local : (b + 1) * n_local].copy(),)


def ring_allpairs(
    packed: PackedSketches,
    kind: str,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
    variant: str | None = None,
    checkpoint_dir: str | None = None,
    ft_config=None,
) -> np.ndarray:
    """The `kind` tile over every pair of rows, sharded over the mesh: the
    [N, N] float32 matrix (Mash distance, diagonal not pinned; or |A ∩ B|).
    Half-ring schedule unless `full_grid`. `variant` (merge|matmul) overrides
    the step the ring picks for its rotating steps (``pick_variant``).
    `checkpoint_dir` is the block store (default: a subdirectory of the
    configured root, :func:`configure_ring`, or none); `ft_config` the
    retries of its per-block recovery (default the process's)."""
    if kind not in _TILE_KINDS:
        raise ValueError(f"ring kind {kind!r}: expected one of {tuple(_TILE_KINDS)}")
    require_int32_ids(packed.ids, "ring_allpairs")
    width = packed.ids.shape[1]
    # the matmul step's vocabulary extent, once, from the host ids
    v_pad = matmul_ring_vocab_pad(packed.ids) if kind in MATMUL_TILE_KINDS else 0
    variant = pick_variant(kind, v_pad, width) if variant is None else variant
    check_variant(kind, variant, v_pad)
    mat, _ = _ring_stepwise(packed, kind, k, mesh, not full_grid, variant, v_pad, checkpoint_dir, ft_config)
    n = packed.n
    return np.ascontiguousarray(mat[:n, :n])


def sharded_mash_allpairs(
    packed: PackedSketches,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
    checkpoint_dir: str | None = None,
    ft_config=None,
) -> np.ndarray:
    """[N, N] float32 Mash distance over the ring, diagonal 0 —
    bit-identical to ops/mash.py::all_vs_all_mash's distance."""
    dist = ring_allpairs(packed, "mash", k, mesh, full_grid, checkpoint_dir=checkpoint_dir, ft_config=ft_config)
    np.fill_diagonal(dist, 0.0)
    return dist


def sharded_containment_allpairs(
    packed: PackedSketches,
    k: int,
    mesh: Mesh,
    full_grid: bool = False,
    variant: str | None = None,
    checkpoint_dir: str | None = None,
    ft_config=None,
) -> tuple[np.ndarray, np.ndarray]:
    """([N, N] symmetric max-containment ani, [N, N] directional cov) over
    the ring: symmetric |A ∩ B| tiles, both cov directions from the counts
    on the host. `variant`: as :func:`ring_allpairs`."""
    inter = ring_allpairs(packed, "containment", k, mesh, full_grid, variant, checkpoint_dir, ft_config)
    return ani_cov_from_intersections(inter, packed.counts, k)
