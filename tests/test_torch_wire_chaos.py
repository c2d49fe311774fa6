"""The port's wire-chaos proxy (drep_tpu_torch/serve/wirechaos.py) and
its ``wire`` fault site against the JAX package's, on the CPU.

- the ``wire`` site's polls (``prob``, ``skip``, ``max``, ``path=``) fire
  on the same reply lines in both registries;
- each of the six wire modes, acted out by the port's proxy with the
  port's registry and by the JAX proxy with the JAX registry in front of
  the same scripted line server, gives the client the same outcome
  (tests/test_wire_chaos.py:120-225): a reset or short read is a clean
  error, a stall past the budget a stamped ``deadline_exceeded``, a
  garbled frame a counted ``wire_corrupt`` that one retry repairs, a
  duplicated frame one answer a request, a slow one the clean answer;
- ``path=`` damages only the hop whose proxy carries that peer label;
- a real port daemon behind the port proxy under ``garble`` answers the
  retried request with the clean wire's verdict, byte for byte, and
  keeps serving.
"""

import json
import os
import socket
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _index_testlib as lib  # noqa: E402

from drep_tpu.serve.wirechaos import WireChaos as JaxWireChaos  # noqa: E402
from drep_tpu.utils import faults as jax_faults  # noqa: E402
from drep_tpu_torch.index import build_from_paths, index_classify  # noqa: E402
from drep_tpu_torch.serve import IndexServer, ServeClient, ServeConfig, ServeError, protocol  # noqa: E402
from drep_tpu_torch.serve.wirechaos import WireChaos  # noqa: E402
from drep_tpu_torch.utils import faults  # noqa: E402

CPU = torch.device("cpu")
# (the proxy class, the registry it polls) of each package
PACKAGES = {"torch": (WireChaos, faults), "jax": (JaxWireChaos, jax_faults)}


class _ScriptedServe:
    """A line server speaking sealed frames: each classify answers a canned
    verdict echoing the request id, each cancel an ack. Records any
    handler exception (wire damage must never reach it)."""

    def __init__(self):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.address = "127.0.0.1:%d" % self._srv.getsockname()[1]
        self.errors: list = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            reader = conn.makefile("rb")
            while True:
                line = reader.readline()
                if not line:
                    return
                req = protocol.unseal(line)
                if req.get("op") == "cancel":
                    conn.sendall(protocol.seal({"ok": True, "op": "cancel", "id": req.get("id"), "cancelled": False}))
                    continue
                conn.sendall(protocol.seal({"ok": True, "id": req.get("id"), "generation": 0, "batch_size": 1,
                                            "verdict": {"genome": os.path.basename(req["genome"]), "novel": True}}))
        except OSError:
            pass
        except Exception as e:  # noqa: BLE001 — the pin is that this never happens
            self.errors.append(e)
        finally:
            conn.close()

    def close(self):
        self._srv.close()


@pytest.fixture()
def stub():
    s = _ScriptedServe()
    try:
        yield s
    finally:
        s.close()
        faults.configure(None)
        jax_faults.configure(None)
        assert s.errors == [], s.errors


def _attempt(fn) -> tuple:
    """What a client saw: ("ok", value) or ("error", the error's class of
    outcome). A connection reset reads as ``disconnected``, whichever of
    the two shapes the kernel delivered it in."""
    try:
        return ("ok", fn())
    except ServeError as e:
        return ("error", e.reason)
    except (ConnectionResetError, BrokenPipeError):
        return ("error", "disconnected")


def _reset(addr):
    t0 = time.monotonic()
    with ServeClient(addr, timeout_s=10) as c:
        got = _attempt(lambda: c.classify("/q/a.fa")["verdict"])
    return {"got": got, "bounded": time.monotonic() - t0 < 8.0}


def _stall(addr):
    t0 = time.monotonic()
    with ServeClient(addr, timeout_s=60) as c:
        try:
            c.classify("/q/a.fa", deadline_ms=400)
            got = ("ok",)
        except ServeError as e:
            got = ("error", e.reason, bool(e.retry_after_s and e.retry_after_s > 0))
    elapsed = time.monotonic() - t0
    return {"got": got, "bounded": 0.3 <= elapsed < 5.0}


def _slow(addr):
    with ServeClient(addr, timeout_s=10) as c:
        return {"got": c.classify("/q/a.fa")["verdict"], "stats": dict(c.wire_stats)}


def _short_read(addr):
    with ServeClient(addr, timeout_s=10) as c:
        single = _attempt(lambda: c.classify("/q/a.fa"))
    with ServeClient(addr, timeout_s=10) as c:
        (resp,) = c.classify_many(["/q/a.fa"])
    return {"single": single[0] == "error" and single[1] in ("wire_corrupt", "disconnected"),
            "pipelined": (resp["ok"], resp["reason"] in ("wire_corrupt", "no_reply"))}


def _garble(addr):
    with ServeClient(addr, timeout_s=10) as c:
        retried = c.classify("/q/a.fa", retries=1)
        return {"verdict": retried["verdict"], "stats": dict(c.wire_stats)}


def _garble_every(addr):
    with ServeClient(addr, timeout_s=10) as c:
        return {"got": _attempt(lambda: c.classify("/q/a.fa"))}


def _dup(addr):
    with ServeClient(addr, timeout_s=10) as c:
        resps = c.classify_many(["/q/a.fa", "/q/b.fa", "/q/c.fa"])
        return {"order": [r["verdict"]["genome"] for r in resps], "ok": [r["ok"] for r in resps],
                "dups_seen": c.wire_stats["dup"] >= 1}


# mode -> (the spec, the client's turn)
MODES = {
    "reset": ("wire:reset", _reset),
    "stall": ("wire:stall:secs=5", _stall),
    "slow": ("wire:slow:secs=0.05", _slow),
    "short_read": ("wire:short_read", _short_read),
    "garble": ("wire:garble:max=1", _garble),
    "garble_every_frame": ("wire:garble", _garble_every),
    "dup": ("wire:dup", _dup),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wire_mode_outcome_equals_jax(stub, mode):
    """One mode through each package's proxy in front of the same line
    server: the client sees the same outcome, and the server stays clean
    (a clean hop answers after)."""
    spec, turn = MODES[mode]
    seen = {}
    for pkg, (proxy_cls, registry) in PACKAGES.items():
        registry.configure(spec)
        try:
            with proxy_cls(stub.address, peer="replica0") as paddr:
                seen[pkg] = turn(paddr)
        finally:
            registry.configure(None)
    assert seen["torch"] == seen["jax"], seen
    want = {
        "reset": {"got": ("error", "disconnected"), "bounded": True},
        "stall": {"got": ("error", "deadline_exceeded", True), "bounded": True},
        "slow": {"got": {"genome": "a.fa", "novel": True}, "stats": {"corrupt": 0, "dup": 0, "wire_retries": 0}},
        "short_read": {"single": True, "pipelined": (False, True)},
        "garble": {"verdict": {"genome": "a.fa", "novel": True},
                   "stats": {"corrupt": 1, "dup": 0, "wire_retries": 1}},
        "garble_every_frame": {"got": ("error", "wire_corrupt")},
        "dup": {"order": ["a.fa", "b.fa", "c.fa"], "ok": [True] * 3, "dups_seen": True},
    }[mode]
    assert seen["torch"] == want
    with ServeClient(stub.address, timeout_s=10) as c:
        assert c.classify("/q/a.fa")["ok"]


def test_wire_path_targets_one_peer_as_jax(stub):
    """``path=``: a proxy whose peer label does not match passes bytes
    through; the one that matches garbles, in both packages."""
    seen = {}
    for pkg, (proxy_cls, registry) in PACKAGES.items():
        registry.configure("wire:garble:path=replica0")
        try:
            with proxy_cls(stub.address, peer="replica1") as clean:
                with ServeClient(clean, timeout_s=10) as c:
                    ok = (c.classify("/q/a.fa")["ok"], c.wire_stats["corrupt"])
            with proxy_cls(stub.address, peer="replica0") as hit:
                with ServeClient(hit, timeout_s=10) as c:
                    bad = _attempt(lambda: c.classify("/q/a.fa"))
        finally:
            registry.configure(None)
        seen[pkg] = (ok, bad)
    assert seen["torch"] == seen["jax"] == ((True, 0), ("error", "wire_corrupt"))


@pytest.mark.parametrize("spec", ["wire:garble", "wire:dup:0.5:seed=3", "wire:slow:skip=2:max=3",
                                  "wire:reset:path=replica0", "wire:short_read:0.3:seed=11:path=replica"])
def test_wire_fault_polls_as_jax(spec):
    """The wire site's poll fires on the same reply lines of the same
    peers in both registries, and counts each fire."""
    peers = ["replica0", "replica1", None, "replica0", "replica10"] * 6
    got = {}
    for pkg, (_proxy, registry) in PACKAGES.items():
        registry.configure(spec)
        try:
            got[pkg] = [None if (r := registry.wire_fault(p)) is None else (r.mode, r.fired) for p in peers]
        finally:
            registry.configure(None)
    assert got["torch"] == got["jax"]
    assert any(got["torch"])


def test_wire_garble_real_daemon_verdict_byte_identical(tmp_path):
    """A real port daemon behind the port proxy under ``garble``: the CRC
    catches the damaged frame, the retry lands, and the verdict is the
    clean wire's and the one-shot classify's, byte for byte; the JAX
    proxy in front of the same daemon gives the same; the daemon keeps
    serving."""
    paths = lib.write_genome_set(str(tmp_path / "g"), [2, 1], seed=19)
    loc = str(tmp_path / "idx")
    build_from_paths(loc, paths, length=0, device=CPU)
    q = paths[0]
    oracle = index_classify(loc, [q], device=CPU)[0]
    srv = IndexServer(ServeConfig(index_loc=loc, batch_window_ms=1.0, max_batch=8, poll_generation_s=60.0,
                                  device=CPU))
    addr = srv.start()
    t = threading.Thread(target=srv.serve_batches, daemon=True)
    t.start()
    try:
        with ServeClient(addr, timeout_s=120) as c:
            clean = c.classify(q)
        for pkg, (proxy_cls, registry) in PACKAGES.items():
            registry.configure("wire:garble:max=1")
            try:
                with proxy_cls(addr, peer="replica0") as paddr:
                    with ServeClient(paddr, timeout_s=120) as c:
                        damaged = c.classify(q, retries=1)
                        assert c.wire_stats == {"corrupt": 1, "dup": 0, "wire_retries": 1}, pkg
            finally:
                registry.configure(None)
            assert damaged["ok"] and clean["ok"]
            assert json.dumps(damaged["verdict"], sort_keys=True) == json.dumps(clean["verdict"], sort_keys=True)
            assert damaged["verdict"] == oracle
            assert damaged["generation"] == clean["generation"] == 0
        with ServeClient(addr, timeout_s=120) as c:
            assert c.classify(q)["ok"]
        assert srv.snapshot()["errors_total"] == 0
    finally:
        faults.configure(None)
        srv.request_drain()
        t.join(timeout=30)
        srv.close()


def test_proxy_refuses_a_socket_path_as_jax(tmp_path):
    """The proxy fronts TCP serve addresses only, in both packages."""
    for proxy_cls in (WireChaos, JaxWireChaos):
        with pytest.raises(ValueError, match="host:port"):
            proxy_cls(str(tmp_path / "r.sock"))


def test_serve_path_does_not_import_the_proxy():
    """Test machinery: the serve package and its daemon, router and
    supervisor import nothing of the proxy."""
    import subprocess

    code = ("import sys\n"
            "import drep_tpu_torch.serve, drep_tpu_torch.serve.router, drep_tpu_torch.serve.supervisor\n"
            "print('PROXY', 'drep_tpu_torch.serve.wirechaos' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "PROXY False" in res.stdout
