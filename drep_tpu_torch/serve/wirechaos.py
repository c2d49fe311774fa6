"""The wire-chaos proxy: TCP bytes behaving badly, on purpose.

Counterpart of drep_tpu/serve/wirechaos.py. Every other fault site of
utils/faults.py fires inside a process; the wire between a client and a
daemon (or a router and a replica) fails in ways no in-process hook can
fake: a connection reset mid-reply, a garbled or doubled frame, a reply
held past any budget. :class:`WireChaos` is an in-process TCP proxy that
sits between any pair of serve-protocol peers and makes those failures,
driven by the ``wire`` fault site (``DREP_TORCH_FAULTS="wire:garble"``;
faults.WIRE_MODES):

- ``reset``: abort the client's connection mid-reply (RST, no FIN);
- ``stall``: hold the reply ``secs`` (default 3600): the client's
  deadline budget must end it, never a daemon thread;
- ``slow``: delay the reply line ``secs`` (default 0.05), then deliver it;
- ``short_read``: deliver half the reply line, then close (EOF mid-frame);
- ``garble``: flip bytes inside the reply frame's JSON body, leaving the
  CRC tail and the newline, so that what is tested is the per-line CRC's
  detection (protocol.seal), not broken framing;
- ``dup``: deliver the reply line twice (the request-id echo dedupes it).

Requests pass through verbatim; replies are read line by line and
:func:`faults.wire_fault` is polled once a reply line, so ``prob``,
``max`` and ``skip`` pick single frames. ``path=`` rules match the
proxy's ``peer`` label, so one spec damages one hop of a fleet
(``wire:garble:path=replica0``).

Test machinery: nothing on the serve path imports this module.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from drep_tpu_torch.utils import faults
from drep_tpu_torch.utils.logger import get_logger

_RECV_CHUNK = 65536


class WireChaos:
    """One listening socket proxying to one upstream ``host:port``
    serve address, applying ``wire`` fault rules per reply line.

    >>> with WireChaos(daemon_address, peer="replica0") as proxy_addr:
    ...     client = ServeClient(proxy_addr)

    ``peer`` is the label ``path=`` rules match; it defaults to the
    upstream address.
    """

    def __init__(self, upstream: str, peer: str | None = None):
        host, _, port = upstream.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"WireChaos proxies TCP serve addresses (host:port), "
                f"got {upstream!r}"
            )
        self._upstream = (host, int(port))
        self.peer = peer if peer is not None else upstream
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.address: str | None = None

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> str:
        """Bind an ephemeral local port and start accepting. Returns the
        proxy's ``host:port`` — the address clients dial instead of the
        upstream's."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(64)
        self._listener = srv
        self.address = f"127.0.0.1:{srv.getsockname()[1]}"
        threading.Thread(
            target=self._accept_loop, daemon=True, name="drep-wirechaos"
        ).start()
        return self.address

    def close(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> str:
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- plumbing --------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                server = socket.create_connection(self._upstream, timeout=10.0)
            except OSError as e:
                get_logger().warning(
                    "wirechaos: upstream %s:%d refused (%s)",
                    *self._upstream, e,
                )
                client.close()
                continue
            with self._lock:
                self._conns.extend((client, server))
            threading.Thread(
                target=self._pump_raw, args=(client, server), daemon=True,
                name="drep-wirechaos-req",
            ).start()
            threading.Thread(
                target=self._pump_replies, args=(server, client), daemon=True,
                name="drep-wirechaos-rep",
            ).start()

    @staticmethod
    def _pump_raw(src: socket.socket, dst: socket.socket) -> None:
        """Request direction: verbatim byte pump (request-side damage is
        the daemon's own check_crc contract, no proxy needed)."""
        try:
            while True:
                chunk = src.recv(_RECV_CHUNK)
                if not chunk:
                    break
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            # half-close ONLY the write side toward the daemon: its
            # reader sees EOF like a real client departure, while
            # replies still in flight keep flowing back through the
            # reply pump until the daemon closes its end
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def _pump_replies(self, src: socket.socket, dst: socket.socket) -> None:
        """Reply direction: line-at-a-time, one wire_fault poll per
        frame. A reset/short_read rule terminates the connection (both
        halves) the way real wire damage does."""
        buf = b""
        try:
            while True:
                chunk = src.recv(_RECV_CHUNK)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not self._deliver(line + b"\n", dst):
                        return
            if buf:
                dst.sendall(buf)  # trailing bytes without a newline
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def _deliver(self, line: bytes, dst: socket.socket) -> bool:
        """Forward one reply frame through the fault rules. Returns
        False when the connection was torn down (reset/short_read) —
        the pump must stop."""
        rule = faults.wire_fault(self.peer)
        if rule is None:
            dst.sendall(line)
            return True
        mode = rule.mode
        if mode == "reset":
            # RST, not FIN: SO_LINGER with a zero timeout makes close()
            # abort the connection — the client sees ECONNRESET, exactly
            # the mid-reply kill a dying middlebox produces. close()
            # alone cannot tear the socket down while _pump_raw sits
            # blocked in recv() on this same fd (the in-flight syscall
            # pins the kernel file, deferring the RST indefinitely);
            # SHUT_RD unblocks that recv locally, putting nothing on the
            # wire, so the lingering close that follows aborts for real.
            dst.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
            try:
                dst.shutdown(socket.SHUT_RD)
            except OSError:
                pass
            dst.close()
            return False
        if mode == "stall":
            # hold the frame; the client's remaining-budget socket bound
            # turns this into a stamped deadline refusal, never a hang
            time.sleep(3600.0 if rule.secs is None else rule.secs)
            dst.sendall(line)
            return True
        if mode == "slow":
            time.sleep(0.05 if rule.secs is None else rule.secs)
            dst.sendall(line)
            return True
        if mode == "short_read":
            dst.sendall(line[: max(1, len(line) // 2)])
            # clean FIN after a partial frame: EOF mid-line. shutdown,
            # not bare close — the FIN must go out NOW, even while
            # _pump_raw's recv() pins this socket's kernel file (a bare
            # close defers teardown until that syscall returns, i.e.
            # never, and the client would hang awaiting bytes)
            try:
                dst.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            dst.close()
            return False
        if mode == "garble":
            dst.sendall(_garble(line))
            return True
        if mode == "dup":
            dst.sendall(line + line)
            return True
        raise AssertionError(f"unhandled wire mode {mode!r}")  # pragma: no cover


def _garble(line: bytes) -> bytes:
    """Flip bytes INSIDE the frame's JSON body — never the trailing
    newline (framing must survive so the damage is a corrupt frame, not
    a stream desync) and never the ``,"crc":N}`` tail (the checksum must
    disagree with the body, not vice versa). XOR mask 0x01: no printable
    ASCII byte maps to ``\\n`` under it (that would need 0x0B on the
    wire, which JSON escapes), so the line count is preserved."""
    body = line.rstrip(b"\n")
    tail = body.rfind(b',"crc":')
    end = tail if tail != -1 else len(body)
    if end <= 2:
        return line  # nothing to damage without breaking framing
    garbled = bytearray(body)
    for pos in (end // 3, end // 2, (2 * end) // 3):
        pos = min(max(1, pos), end - 1)
        garbled[pos] ^= 0x01
    return bytes(garbled) + b"\n"
