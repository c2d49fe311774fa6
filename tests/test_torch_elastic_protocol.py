"""The elastic pod's protocol, in process: the port's HeartbeatManager
(drep_tpu_torch/parallel/faulttol.py) against the JAX package's on the
same note-directory steps.

Each scenario runs once with each package's managers standing in for the
pod's members (separate managers over one shared note dir, each with its
own stage-sequence view, as separate processes have), and the two runs
must give the same verdicts, live lists, epochs, counters and note files
(names and JSON payloads, timestamps aside). The mixed cases put one
package's member beside the other's in one note dir: a note written by
either package is read by the other. The dealing helpers
(deal_stripes, stripe_owner_live, stripe_weights) are held against the
JAX package's on the same inputs.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from drep_tpu.parallel import faulttol as jax_ft
from drep_tpu.parallel import streaming as jax_streaming
from drep_tpu.utils import profiling as jax_profiling
from drep_tpu_torch.parallel import faulttol as torch_ft
from drep_tpu_torch.parallel import streaming
from drep_tpu_torch.utils import profiling as torch_profiling

CADENCE = 0.2
PKGS = {"torch": (torch_ft, torch_profiling), "jax": (jax_ft, jax_profiling)}


def _member(ft, note_dir, pid, pc=2, max_dead=1, max_joins=0):
    """A member's manager with its own stage-sequence view."""
    ft._HB_SEQ[os.path.abspath(str(note_dir))] = 0
    hb = ft.HeartbeatManager(str(note_dir), CADENCE, max_dead=max_dead, pc=pc, pid=pid, max_joins=max_joins)
    hb.start()
    return hb


def _check(hb) -> bool:
    hb._last_check = 0
    return hb.check()


@pytest.fixture(autouse=True)
def _clean_pod_state():
    for ft, prof in PKGS.values():
        ft.reset_pod()
        ft.clear_drain()
        prof.counters.reset()
    yield
    for ft, prof in PKGS.values():
        ft.reset_pod()
        ft.clear_drain()
        prof.counters.reset()


def _notes(note_dir) -> dict:
    """Every pod note of the dir: name -> its JSON payload without the
    timestamp and checksum (beat notes: their presence only)."""
    out = {}
    for name in sorted(os.listdir(note_dir)):
        if not name.startswith(".pod-"):
            continue
        if name.startswith(".pod-hb."):
            out[name] = None
            continue
        with open(os.path.join(note_dir, name)) as f:
            doc = json.loads(f.read())
        out[name] = {k: v for k, v in doc.items() if k not in ("at", "crc", "token")}
    return out


def _state(hb) -> dict:
    return {"live": list(hb.live), "dead": list(hb.dead), "drained": list(hb.drained),
            "joined": list(hb.joined), "epoch": hb.epoch}


def _faults(prof) -> dict:
    return {k: v for k, v in prof.counters.faults.items() if not k.startswith("io_")}


def _request_join(note_dir, jid, token="tok"):
    from drep_tpu_torch.utils.durableio import atomic_write_bytes, atomic_write_json

    atomic_write_bytes(os.path.join(str(note_dir), f".pod-hb.p{jid}"), b"x")
    atomic_write_json(os.path.join(str(note_dir), f".pod-join.p{jid}"), {"token": token, "at": time.time()})


# ---- the scenarios: each returns what must agree across the packages ------------------


def sc_drain_adopted(ft, prof, d):
    hb0, hb1 = _member(ft, d, 0), _member(ft, d, 1)
    try:
        hb1.announce_drain(pairs=11)
        t_note = os.stat(hb1.drain_path()).st_mtime
        bumped = _check(hb0)
        # adopted at once: no staleness window elapsed
        assert time.time() - t_note < ft.HEARTBEAT_MISS_FACTOR * CADENCE
        return {"bumped": bumped, "hb0": _state(hb0), "pairs": hb0.drain_payload(1)["pairs"],
                "history": [e["reason"] for e in prof.counters.epoch_history], "faults": _faults(prof),
                "pod": (ft.pod_epoch(), ft.pod_live(), ft.pod_drained()), "notes": _notes(d)}
    finally:
        hb0.close()
        hb1.close()


def sc_drained_then_stale(ft, prof, d):
    """A drain followed by the member's beats going stale is never a
    death (max_dead=0 makes one raise)."""
    hb0, hb1 = _member(ft, d, 0, max_dead=0), _member(ft, d, 1, max_dead=0)
    hb1.announce_drain(pairs=3)
    hb1.close()
    try:
        _check(hb0)
        time.sleep(ft.HEARTBEAT_MISS_FACTOR * CADENCE + 0.3)
        for _ in range(3):
            _check(hb0)
        return {"hb0": _state(hb0), "faults": _faults(prof), "notes": _notes(d)}
    finally:
        hb0.close()


def sc_drain_seq_gated(ft, prof, d):
    hb0, hb1 = _member(ft, d, 0), _member(ft, d, 1)
    hb1.announce_drain()
    hb1.close()
    hb0.close()
    ft.reset_pod()
    hb0b = _member(ft, d, 0)
    try:
        from drep_tpu_torch.utils.durableio import atomic_write_json

        atomic_write_json(hb0b.drain_path(1), {"seq": 0, "epoch": 0, "pairs": 0, "at": time.time()})
        _check(hb0b)
        return {"seq": hb0b.seq, "hb0": _state(hb0b), "notes": _notes(d)}
    finally:
        hb0b.close()


def sc_death_verdict(ft, prof, d):
    """A member whose beats stop is declared dead after the miss window,
    confirmed across a cadence; its verdict note is published, the epoch
    bumps and the downstream pod state degrades; a second death past
    max_dead raises."""
    hb0, hb1 = _member(ft, d, 0, pc=3), _member(ft, d, 1, pc=3)
    hb2 = _member(ft, d, 2, pc=3)
    hb1.close()
    try:
        deadline = time.time() + 10
        while 1 in hb0.live and time.time() < deadline:
            _check(hb0)
            time.sleep(0.05)
        verdict = _state(hb0)
        pod = (ft.pod_epoch(), ft.pod_live(), ft.pod_dead())
        _check(hb2)  # the peer adopts the published verdict
        adopted = _state(hb2)
        hb2.close()
        raised = None
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                _check(hb0)
            except ft.FaultTolError as e:
                raised = "max_dead" if "max_dead_processes" in str(e) else str(e)
                break
            time.sleep(0.05)
        return {"verdict": verdict, "adopted": adopted, "pod": pod, "raised": raised,
                "history": [e["reason"] for e in prof.counters.epoch_history],
                "notes": {k: v for k, v in _notes(d).items() if not k.startswith(".pod-dead.p2")}}
    finally:
        hb0.close()


def sc_fenced(ft, prof, d):
    """A member that finds a verdict naming itself fences (raises)."""
    hb0 = _member(ft, d, 0)
    try:
        from drep_tpu_torch.utils.durableio import atomic_write_json

        atomic_write_json(hb0.verdict_path(0), {"by": 1, "seq": 1, "at": time.time()})
        with pytest.raises(ft.FaultTolError, match="fencing"):
            _check(hb0)
        return {"hb0": _state(hb0)}
    finally:
        hb0.close()


def sc_join_admit_adopt(ft, prof, d):
    hb0, hb1 = _member(ft, d, 0, max_joins=1), _member(ft, d, 1, max_joins=1)
    try:
        _request_join(d, 5)
        _check(hb1)  # not the leader: no admission
        before = _state(hb1)
        bumped = _check(hb0)
        adopted = _check(hb1)
        return {"before": before, "bumped": bumped, "adopted": adopted, "hb0": _state(hb0), "hb1": _state(hb1),
                "pod": (ft.pod_live(), ft.pod_joined()), "faults": _faults(prof), "notes": _notes(d)}
    finally:
        hb0.close()
        hb1.close()


def sc_join_budget(ft, prof, d):
    hb0 = _member(ft, d, 0, max_joins=1)
    try:
        _request_join(d, 5, token="a")
        _check(hb0)
        _request_join(d, 6, token="b")
        _check(hb0)
        return {"hb0": _state(hb0), "notes": _notes(d)}
    finally:
        hb0.close()


def sc_join_needs_fresh_beat(ft, prof, d):
    from drep_tpu_torch.utils.durableio import atomic_write_json

    hb0 = _member(ft, d, 0, max_joins=1)
    try:
        atomic_write_json(os.path.join(str(d), ".pod-join.p5"), {"token": "t", "at": time.time()})
        _check(hb0)
        return {"hb0": _state(hb0), "notes": _notes(d)}
    finally:
        hb0.close()


def sc_stale_admit_ghost(ft, prof, d):
    from drep_tpu_torch.utils.durableio import atomic_write_json

    atomic_write_json(os.path.join(str(d), ".pod-admit.p5"),
                      {"pid": 5, "epoch": 1, "live": [0, 1, 5], "pc": 2, "seq": 1, "token": "t",
                       "at": time.time()})
    hb0 = _member(ft, d, 0, max_dead=0, max_joins=1)
    try:
        _check(hb0)
        return {"seq": hb0.seq, "hb0": _state(hb0)}
    finally:
        hb0.close()


def sc_admission_server_clock(ft, prof, d):
    hb0 = _member(ft, d, 0, max_joins=1)
    try:
        hb0._stop.set()
        if hb0._thread is not None:
            hb0._thread.join(timeout=5)
        _request_join(d, 5)
        lag = time.time() - 60.0
        os.utime(hb0.beat_path(), (lag, lag))
        os.utime(hb0.beat_path(5), (lag + 0.05, lag + 0.05))
        _check(hb0)
        return {"hb0": _state(hb0)}
    finally:
        hb0.close()


def _leader_thread(hb):
    stop = threading.Event()

    def run():
        while not stop.wait(0.05):
            hb._last_check = 0
            hb.check()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return stop, t


def sc_join_handshake(ft, prof, d, monkeypatch):
    monkeypatch.setenv(ft.POD_JOIN_ENV, "auto")
    monkeypatch.setenv(ft.COLLECTIVE_TIMEOUT_ENV, "30")
    hb0 = _member(ft, d, 0, max_joins=2)
    stop, t = _leader_thread(hb0)
    try:
        ft._HB_SEQ[os.path.abspath(str(d))] = 0
        hb_j = ft.join_elastic_pod(str(d), CADENCE, config=ft.FaultTolConfig(max_joins=2))
        try:
            return {"pid": hb_j.pid, "pc": hb_j.pc, "live": hb_j.live, "seq_same": hb_j.seq == hb0.seq,
                    "joined": hb_j.joined, "accepted": prof.counters.faults.get("pod_join_accepted")}
        finally:
            hb_j.close()
    finally:
        stop.set()
        t.join()
        hb0.close()


def sc_join_timeout(ft, prof, d, monkeypatch):
    monkeypatch.setenv(ft.POD_JOIN_ENV, "7")
    with pytest.raises(ft.CollectiveTimeout):
        ft.join_elastic_pod(str(d), CADENCE, timeout_s=0.6)
    return {"notes": _notes(d)}


def sc_joiner_never_validates(ft, prof, d, monkeypatch):
    monkeypatch.setenv(ft.POD_JOIN_ENV, "9")
    hb0 = _member(ft, d, 0, pc=1, max_dead=0, max_joins=1)
    stop, t = _leader_thread(hb0)
    try:
        with pytest.raises(ft.CollectiveTimeout, match="never matched"):
            ft.join_elastic_pod(str(d), CADENCE, config=ft.FaultTolConfig(max_joins=1), timeout_s=3.0,
                                validate=lambda: False)
        drain_note = os.path.exists(os.path.join(str(d), ".pod-drain.p9"))
        time.sleep(ft.HEARTBEAT_MISS_FACTOR * CADENCE + 0.3)
        stop.set()
        t.join()
        _check(hb0)
        return {"drain_note": drain_note, "hb0": _state(hb0), "dead": prof.counters.faults.get("dead_processes")}
    finally:
        stop.set()
        t.join()
        hb0.close()


SCENARIOS = {
    "drain_adopted": sc_drain_adopted,
    "drained_then_stale": sc_drained_then_stale,
    "drain_seq_gated": sc_drain_seq_gated,
    "death_verdict": sc_death_verdict,
    "fenced": sc_fenced,
    "join_admit_adopt": sc_join_admit_adopt,
    "join_budget": sc_join_budget,
    "join_needs_fresh_beat": sc_join_needs_fresh_beat,
    "stale_admit_ghost": sc_stale_admit_ghost,
    "admission_server_clock": sc_admission_server_clock,
}
SCENARIOS_ENV = {
    "join_handshake": sc_join_handshake,
    "join_timeout": sc_join_timeout,
    "joiner_never_validates": sc_joiner_never_validates,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(tmp_path, name):
    got = {}
    for pkg, (ft, prof) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = SCENARIOS[name](ft, prof, d)
        ft.reset_pod()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("name", sorted(SCENARIOS_ENV))
def test_scenario_with_env_equals_jax(tmp_path, monkeypatch, name):
    got = {}
    for pkg, (ft, prof) in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = SCENARIOS_ENV[name](ft, prof, d, monkeypatch)
        ft.reset_pod()
    assert got["torch"] == got["jax"]


# ---- mixed pods: one package's notes read by the other's ------------------------------


@pytest.mark.parametrize("leaver,stayer", [("torch", "jax"), ("jax", "torch")])
def test_drain_note_read_across_packages(tmp_path, leaver, stayer):
    ft_l, ft_s = PKGS[leaver][0], PKGS[stayer][0]
    hb0, hb1 = _member(ft_s, tmp_path, 0), _member(ft_l, tmp_path, 1)
    try:
        hb1.announce_drain(pairs=7)
        assert _check(hb0) is True
        assert (hb0.live, hb0.drained, hb0.drain_payload(1)["pairs"]) == ([0], [1], 7)
    finally:
        hb0.close()
        hb1.close()


@pytest.mark.parametrize("judge,victim", [("torch", "jax"), ("jax", "torch")])
def test_death_verdict_and_done_notes_read_across_packages(tmp_path, judge, victim):
    """The judge declares the other package's member dead and publishes
    the verdict; a third member of the victim's package adopts it; a done
    note written by one package is read by the other."""
    ft_j, ft_v = PKGS[judge][0], PKGS[victim][0]
    hb0 = _member(ft_j, tmp_path, 0, pc=3)
    hb1 = _member(ft_v, tmp_path, 1, pc=3)
    hb2 = _member(ft_v, tmp_path, 2, pc=3)
    try:
        hb2.mark_done(42)
        assert hb0.peer_finished(2) and hb0.done_payload(2)["pairs"] == 42
        hb1.close()
        deadline = time.time() + 10
        while 1 in hb0.live and time.time() < deadline:
            _check(hb0)
            time.sleep(0.05)
        assert hb0.dead == [1] and hb0.epoch == 1
        hb2._last_check = 0
        assert hb2.check() is True and hb2.dead == [1]
    finally:
        hb0.close()
        hb2.close()


@pytest.mark.parametrize("leader,joiner", [("torch", "jax"), ("jax", "torch")])
def test_join_admitted_across_packages(tmp_path, monkeypatch, leader, joiner):
    ft_l, ft_j = PKGS[leader][0], PKGS[joiner][0]
    monkeypatch.setenv(ft_j.POD_JOIN_ENV, "auto")
    monkeypatch.setenv(ft_j.COLLECTIVE_TIMEOUT_ENV, "30")
    hb0 = _member(ft_l, tmp_path, 0, max_joins=1)
    stop, t = _leader_thread(hb0)
    try:
        ft_j._HB_SEQ[os.path.abspath(str(tmp_path))] = 0
        hb_j = ft_j.join_elastic_pod(str(tmp_path), CADENCE, config=ft_j.FaultTolConfig(max_joins=1))
        try:
            assert hb_j.pid == 2 and hb_j.pc == 2 and hb_j.live == [0, 1, 2] and hb_j.seq == hb0.seq
        finally:
            hb_j.close()
    finally:
        stop.set()
        t.join()
        hb0.close()


# ---- drain wiring, join refusals ------------------------------------------------------


def test_request_drain_flag_and_sigterm_handler():
    import signal

    assert not torch_ft.drain_requested()
    torch_ft.request_drain()
    assert torch_ft.drain_requested()
    torch_ft.clear_drain()
    assert torch_ft.install_drain_handler(grace_s=600.0) is True
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not torch_ft.drain_requested() and time.time() < deadline:
            time.sleep(0.01)
        assert torch_ft.drain_requested()
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        torch_ft.clear_drain()


def test_join_request_without_heartbeats_refuses_loudly(tmp_path, monkeypatch):
    """DREP_TORCH_POD_JOIN with the protocol unavailable refuses, as the
    JAX package's join knob does."""
    from drep_tpu_torch.errors import UserInputError
    from drep_tpu_torch.ops.minhash import PackedSketches

    ids = np.sort(np.random.default_rng(0).choice(2**20, size=(4, 16), replace=False)).astype(np.int32)
    packed = PackedSketches(ids=np.sort(ids, axis=1), counts=np.full(4, 16, np.int32),
                            names=[f"g{i}" for i in range(4)])
    monkeypatch.setenv(torch_ft.POD_JOIN_ENV, "auto")
    with pytest.raises(UserInputError, match="POD_JOIN"):
        streaming.streaming_mash_edges(packed, k=21, cutoff=0.2, block=4, device="cpu")
    monkeypatch.setenv(torch_ft.HEARTBEAT_ENV, "0")
    with pytest.raises(UserInputError, match="POD_JOIN"):
        streaming.streaming_mash_edges(packed, k=21, cutoff=0.2, block=4, device="cpu",
                                       checkpoint_dir=str(tmp_path / "ckpt"))


# ---- dealing --------------------------------------------------------------------------


@pytest.mark.parametrize("n_blocks", [1, 2, 5, 9, 16, 33])
@pytest.mark.parametrize("live", [[0], [0, 1], [0, 2], [1, 2, 5], [0, 1, 2, 3], [0, 2, 3, 7, 9]])
def test_unweighted_deal_equals_jax(n_blocks, live):
    owners = streaming.deal_stripes(n_blocks, live)
    assert owners == jax_streaming.deal_stripes(n_blocks, live)
    assert owners == [streaming.stripe_owner_live(bi, n_blocks, live) for bi in range(n_blocks)]
    assert set(owners) <= set(live)


@pytest.mark.parametrize("seed", range(6))
def test_weighted_deal_and_stripe_weights_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(3, 40))
    occ = rng.random((n_blocks, n_blocks)) < rng.uniform(0.05, 0.9)
    first = int(rng.integers(0, n_blocks))
    w = streaming.stripe_weights(occ, first)
    np.testing.assert_array_equal(w, jax_streaming.stripe_weights(occ, first))
    live = sorted(rng.choice(12, size=int(rng.integers(1, 6)), replace=False).tolist())
    owners = streaming.deal_stripes(n_blocks, live, w)
    assert owners == jax_streaming.deal_stripes(n_blocks, live, w)
    load = {p: int(sum(w[b] for b in range(n_blocks) if owners[b] == p)) for p in live}
    assert max(load.values()) - min(load.values()) <= max(int(w.max()), 0)
