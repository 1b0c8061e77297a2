"""Selector-driven writer tier: vectored socket sends off every lock.

A port of ``fluidframework_tpu/fanout/writer.py`` (no JAX in it).

One thread drains EVERY socket-backed fan-out peer: nonblocking sockets, a
``selectors`` readiness loop, and ``sendmsg`` vectored sends so one syscall
ships a whole run of queued frames/directs.  A peer whose kernel buffer is
full simply stays registered for writability — it never blocks the thread,
so a stalled subscriber costs the other N−1 nothing (the plane's ring
eviction + resync bounds its memory).

Claim protocol (see ``plane.FanoutPlane.claim``): the writer claims a run
of buffers under the plane lock, RELEASES the lock, and sends.  Partial
sends keep the remainder in ``peer.outbuf`` (memoryviews over the claimed
bytes) and are always finished before the next claim — a resync can
therefore never split a claimed frame.  When a claim reports the peer is
behind, the writer invokes the plane's resync (which takes the service
lock; the writer holds no plane lock at that point — lock order preserved).
"""

from __future__ import annotations

import contextlib
import selectors
import socket
import threading

from ..observability import instant

# Buffers per sendmsg call: well under every platform's IOV_MAX (1024 on
# Linux) while still amortizing syscalls over a deep backlog.
_IOV_BATCH = 64


class FanoutWriter:
    """The one writer thread over all socket peers of a FanoutPlane."""

    def __init__(self, plane, on_dead=None) -> None:
        self._plane = plane
        self._on_dead = on_dead  # callback(peer): session-layer cleanup
        self._sel = selectors.DefaultSelector()
        # Wake channel: publishers signal new work without touching the
        # selector from their thread (only the writer mutates it).
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()  # guards _pending/_forgotten/_stopped
        self._pending: set = set()     # peers with possibly-new work
        self._registered: set = set()  # peers currently in the selector
        self._forgotten: set = set()   # dropped peers awaiting deregistration
        self._stopped = False
        self.sends = 0
        self.send_bytes = 0
        self.partial_sends = 0
        self.dead_peers = 0
        self._thread = threading.Thread(
            target=self._run, name="fanout-writer", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ wakes
    def wake(self, peers) -> None:
        """Mark peers as having pending outbound work (any thread)."""
        with self._lock:
            if self._stopped:
                return
            before = len(self._pending)
            self._pending.update(p for p in peers if p.is_socket and not p.dead)
            changed = len(self._pending) != before
        if changed:
            with contextlib.suppress(BlockingIOError, OSError):
                # A byte already in flight wakes the loop just the same.
                self._wake_w.send(b"x")

    def forget(self, peer) -> None:
        """Drop a peer (session teardown).  The selector entry is removed
        by the writer thread on its next pass (only it touches the
        selector — and a parked entry MUST be removed, or the stale fd
        blocks a future peer reusing it from ever registering); the
        socket itself is closed by the session layer."""
        with self._lock:
            self._pending.discard(peer)
            self._forgotten.add(peer)
        with contextlib.suppress(BlockingIOError, OSError):
            self._wake_w.send(b"x")

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        with contextlib.suppress(OSError):
            self._wake_w.send(b"x")
        self._thread.join(timeout=5)
        with contextlib.suppress(OSError):
            self._wake_r.close()
        with contextlib.suppress(OSError):
            self._wake_w.close()
        with contextlib.suppress(OSError, RuntimeError):
            self._sel.close()

    # ------------------------------------------------------------------- loop
    def _run(self) -> None:
        while True:
            ready = self._sel.select(timeout=1.0)
            with self._lock:
                if self._stopped:
                    return
                fresh = self._pending
                self._pending = set()
                forgotten = self._forgotten
                self._forgotten = set()
            for peer in forgotten:
                # selectors' unregister falls back to a map scan when the
                # fd is already closed, so parked dead peers always leave.
                self._deregister(peer)
                fresh.discard(peer)
            for key, _ev in ready:
                if key.data is None:  # wake channel
                    with contextlib.suppress(BlockingIOError, OSError):
                        while self._wake_r.recv(4096):
                            pass
                else:
                    fresh.add(key.data)
            for peer in fresh:
                self._service_peer(peer)

    def _service_peer(self, peer) -> None:
        if peer.dead:
            self._deregister(peer)
            return
        progressed = True
        while progressed:
            if not peer.outbuf:
                bufs, needs_resync = self._plane.claim(peer)
                if needs_resync:
                    # No plane lock held here: resync re-enters the
                    # service-lock -> plane-lock order safely.
                    self._plane.resync(peer)
                    bufs, _ = self._plane.claim(peer)
                peer.outbuf = [memoryview(b) for b in bufs if b]
            if not peer.outbuf:
                self._deregister(peer)
                return
            progressed = self._send_some(peer)
            if peer.dead:
                self._deregister(peer)
                self._plane.remove_peer(peer)
                if self._on_dead is not None:
                    self._on_dead(peer)
                return
        # Kernel buffer full: park on writability.
        self._register(peer)

    def _send_some(self, peer) -> bool:
        """One vectored send attempt; True when bytes moved."""
        batch = peer.outbuf[:_IOV_BATCH]
        try:
            if hasattr(peer.sock, "sendmsg"):
                n = peer.sock.sendmsg(batch)
            else:  # non-socket transports in tests
                n = peer.sock.send(b"".join(batch))
        except (BlockingIOError, InterruptedError):
            return False
        except OSError:
            with self._lock:
                peer.dead = True
                self.dead_peers += 1
            instant("fanout_peer_dead", peer=peer.peer_id)
            return False
        with self._lock:
            self.sends += 1
            self.send_bytes += n
            peer.sent_bytes += n
        # Trim fully-sent buffers, slice the partial one.
        i = 0
        while i < len(batch) and n >= len(batch[i]):
            n -= len(batch[i])
            i += 1
        if i < len(batch) and n:
            batch[i] = batch[i][n:]
            with self._lock:
                self.partial_sends += 1
        del peer.outbuf[:i]
        if peer.outbuf and n:
            peer.outbuf[0] = batch[i]
        return True

    # -------------------------------------------------------------- selector
    def _register(self, peer) -> None:
        if peer in self._registered:
            return
        try:
            self._sel.register(peer.sock, selectors.EVENT_WRITE, peer)
        except (KeyError, ValueError, OSError):
            return
        self._registered.add(peer)

    def _deregister(self, peer) -> None:
        if peer not in self._registered:
            return
        self._registered.discard(peer)
        with contextlib.suppress(KeyError, ValueError, OSError):
            self._sel.unregister(peer.sock)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "sends": self.sends,
                "send_bytes": self.send_bytes,
                "partial_sends": self.partial_sends,
                "dead_peers": self.dead_peers,
            }
