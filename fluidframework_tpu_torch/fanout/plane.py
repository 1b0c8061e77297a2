"""The read fan-out hub: a shared frame ring with per-subscriber cursors.

A port of ``fluidframework_tpu/fanout/plane.py`` (no JAX in it).

Publishing a pump's delta batch is O(1) in the subscriber count: the frame
(encoded once, ``frames.DeltaFrame``) is appended to a bounded per-document
ring and every subscriber holds only a CURSOR into that ring — no per-
subscriber queue copies, no per-subscriber encode, no per-message walk.
The per-subscriber cost moves entirely to the drain side (the writer tier's
vectored socket sends, or a virtual drain in bench), where it is inherent.

Slow subscribers never stall the other N−1:

- the ring is bounded (frames + bytes); eviction drops the oldest frames;
- a subscriber whose cursor fell off the ring is BEHIND: at its next drain
  it gets a RESYNC — the missed range rebuilt from the ordered log (same
  cached per-message encodes, so the observed stream stays byte-identical
  to the firehose oracle) — and its cursor jumps to the ring head;
- per-peer direct queues (control messages, catch-up, signals) are bounded
  too; droppable entries (presence/signals: at-most-once by contract) are
  shed past the bound, control entries are session-bounded and never shed.

Locking: ONE plane lock covers ring/cursor/queue state; every operation
under it is O(1)-ish (append, pop, counter).  Socket sends happen on the
writer thread with the lock RELEASED.  Callers that publish under a
service lock (netserver) always take service-lock → plane-lock; the resync
callback is invoked with NO plane lock held so it can re-enter that order.

The presence plane rides the same peers and the same writer: signals are
encoded once per signal, scattered as droppable directs, and never touch
the sequencer — unsequenced, at-most-once, off the ordering path.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Iterable

from ..observability import instant, span
from ..protocol.messages import SequencedMessage
from .frames import (
    FLAVOR_ENVELOPE,
    FLAVOR_WIRE,
    KIND_RESYNC,
    DeltaFrame,
    build_frame,
)

# A resync request larger than the retained log window gets this marker
# instead of ops: the client must boot from a snapshot (historian tier).
# Client contract (FleetConsumer._boot_resync, both engine families via
# models/placement.adopt_boot_snapshot): a snapshot AHEAD of the doc's
# applied floor is adopted and consumption resumes from its seq; one
# at/below the floor is REFUSED (AdoptResult.adopted=False) and the doc
# falls to the supervisor restart path — re-subscribing from the
# engine's own floor would just draw this marker again, an infinite
# resync loop that looks healthy.
RESYNC_BOOT_MARKER = b'{"t":"resync","boot":true}\n'


class _DeltaSub:
    """One peer's delta subscription: a cursor into a doc's frame ring."""

    __slots__ = ("doc_id", "flavor", "cursor", "last_seq")

    def __init__(self, doc_id: str, flavor: str, cursor: int, last_seq: int):
        self.doc_id = doc_id
        self.flavor = flavor
        self.cursor = cursor      # next ring frame index to deliver
        self.last_seq = last_seq  # highest seq delivered/claimed (resync floor)


class FanoutPeer:
    """One outbound endpoint: a real socket (drained by the writer tier)
    or a virtual sink (drained explicitly — bench/tests)."""

    __slots__ = ("peer_id", "sock", "sink", "sub", "directs", "outbuf",
                 "dead", "sent_bytes", "sent_frames", "signal_drops",
                 "resyncs", "signal_docs", "signal_interests")

    def __init__(self, peer_id: int, sock=None, sink=None) -> None:
        self.peer_id = peer_id
        self.sock = sock
        self.sink = sink
        self.sub: _DeltaSub | None = None
        # (watermark_frame_idx, bytes): send once the delta cursor passed
        # the watermark — orders control messages relative to op frames.
        self.directs: deque[tuple[int, bytes]] = deque()
        # Claimed-but-unsent buffers (writer partial-send remainder).
        self.outbuf: list[memoryview] = []
        self.dead = False
        self.sent_bytes = 0
        self.sent_frames = 0
        self.signal_drops = 0
        self.resyncs = 0
        self.signal_docs: set[str] = set()
        # Per-doc scoped-presence interest sets: doc_id -> frozenset of
        # scope keys (None = the unscoped firehose, every signal).
        self.signal_interests: dict[str, frozenset | None] = {}

    @property
    def is_socket(self) -> bool:
        return self.sock is not None


class _DocRing:
    """Per-document frame ring + pending (un-flushed) pump batch."""

    __slots__ = ("doc_id", "frames", "base", "nbytes", "last_seq", "pending",
                 "subs", "socket_subs", "signal_peers")

    def __init__(self, doc_id: str, last_seq: int = 0) -> None:
        self.doc_id = doc_id
        self.frames: deque[DeltaFrame] = deque()
        self.base = 0          # ring index of frames[0]
        self.nbytes = 0
        self.last_seq = last_seq  # seq_hi of the newest published frame
        self.pending: list[SequencedMessage] = []
        self.subs: list[FanoutPeer] = []
        # Socket-backed subscribers only: what a flush must wake.  Kept
        # separately so publishing stays O(1) however many virtual/cursor
        # subscribers ride the ring (the 100k-subscriber bench shape).
        self.socket_subs: list[FanoutPeer] = []
        self.signal_peers: list[FanoutPeer] = []

    @property
    def head(self) -> int:
        return self.base + len(self.frames)


# resync source: (doc_id, from_seq_exclusive) -> ordered SequencedMessages
# with seq > from_seq, or None when the range is no longer retained (the
# subscriber must snapshot-boot).  Called with NO plane lock held; the
# provider takes its own (service) lock.
ResyncSource = Callable[[str, int], "list[SequencedMessage] | None"]


class FanoutPlane:
    """Delta frame ring + presence scatter over a shared peer set."""

    def __init__(
        self,
        resync_source: ResyncSource | None = None,
        ring_frames: int = 512,
        ring_bytes: int = 8 << 20,
        max_directs: int = 4096,
        claim_bytes: int = 1 << 20,
    ) -> None:
        self._lock = threading.RLock()
        self._resync_source = resync_source
        self.ring_frames = ring_frames
        self.ring_bytes = ring_bytes
        self.max_directs = max_directs
        self.claim_bytes = claim_bytes
        self._docs: dict[str, _DocRing] = {}
        self._peer_seq = 0
        self._peers: set[FanoutPeer] = set()
        # Writer tier (writer.FanoutWriter); optional — virtual-only planes
        # (bench at 100k subscribers) never start a thread.
        self._writer = None
        # -------- counters (all mutated under the plane lock) --------
        self.frames_published = 0
        self.frame_bytes = 0
        self.frames_evicted = 0
        self.flushes = 0
        self.resyncs = 0
        self.boot_resyncs = 0
        self.signals_published = 0
        self.signal_deliveries = 0
        self.signal_drops = 0
        self.presence_scope_drops = 0
        self.directs_enqueued = 0

    # ------------------------------------------------------------------ wiring
    def set_writer(self, writer) -> None:
        self._writer = writer

    def new_peer(self, sock=None, sink=None) -> FanoutPeer:
        with self._lock:
            self._peer_seq += 1
            peer = FanoutPeer(self._peer_seq, sock=sock, sink=sink)
            self._peers.add(peer)
            return peer

    def remove_peer(self, peer: FanoutPeer) -> None:
        with self._lock:
            peer.dead = True
            self._peers.discard(peer)
            sub = peer.sub
            if sub is not None:
                ring = self._docs.get(sub.doc_id)
                if ring is not None and peer in ring.subs:
                    ring.subs.remove(peer)
                if ring is not None and peer in ring.socket_subs:
                    ring.socket_subs.remove(peer)
            for doc_id in peer.signal_docs:
                ring = self._docs.get(doc_id)
                if ring is not None and peer in ring.signal_peers:
                    ring.signal_peers.remove(peer)
            peer.signal_docs.clear()
            peer.signal_interests.clear()
            peer.directs.clear()
            peer.outbuf = []
        if self._writer is not None:
            self._writer.forget(peer)

    def _ring(self, doc_id: str) -> _DocRing:
        ring = self._docs.get(doc_id)
        if ring is None:
            ring = self._docs[doc_id] = _DocRing(doc_id)
        return ring

    def ensure_doc(self, doc_id: str, last_seq: int = 0) -> None:
        """Register a document with its current broadcast floor (the seq
        already delivered before the plane tapped the stream): resyncs and
        empty-ring attaches anchor on it."""
        with self._lock:
            ring = self._docs.get(doc_id)
            if ring is None:
                self._docs[doc_id] = _DocRing(doc_id, last_seq=last_seq)

    # ---------------------------------------------------------------- publish
    def tap(self, doc_id: str, msg: SequencedMessage) -> None:
        """Per-message accumulation seam (ONE subscriber per document on the
        ordering core, whatever the subscriber count): O(1) append."""
        with self._lock:
            self._ring(doc_id).pending.append(msg)

    def flush(self, doc_id: str) -> DeltaFrame | None:
        """Frame the pending batch and publish it to the ring: the pump
        boundary.  O(1) in the subscriber count."""
        with self._lock:
            ring = self._docs.get(doc_id)
            if ring is None or not ring.pending:
                return None
            with span("fanout_flush", doc=doc_id, n=len(ring.pending)):
                frame = build_frame(doc_id, ring.pending)
                ring.pending = []
                self._publish(ring, frame)
            socket_peers = list(ring.socket_subs)
        if socket_peers and self._writer is not None:
            # O(socket peers of the doc): the unavoidable per-subscriber
            # half lives on the writer thread, not under the service lock.
            self._writer.wake(socket_peers)
        return frame

    def publish(self, doc_id: str, msgs: Iterable[SequencedMessage]):
        """Tap + flush in one call (lambda pipeline / bench seam)."""
        with self._lock:
            ring = self._ring(doc_id)
            ring.pending.extend(msgs)
        return self.flush(doc_id)

    def _publish(self, ring: _DocRing, frame: DeltaFrame) -> None:
        ring.frames.append(frame)
        ring.nbytes += frame.nbytes
        ring.last_seq = frame.seq_hi
        self.frames_published += 1
        self.frame_bytes += frame.nbytes
        # Bounded ring: evict oldest (keep >=1 so head-1 stays readable).
        while len(ring.frames) > 1 and (
            len(ring.frames) > self.ring_frames or ring.nbytes > self.ring_bytes
        ):
            old = ring.frames.popleft()
            ring.base += 1
            ring.nbytes -= old.nbytes
            self.frames_evicted += 1
        self.flushes += 1

    # ----------------------------------------------------------------- attach
    def attach(
        self, doc_id: str, peer: FanoutPeer, flavor: str = FLAVOR_WIRE,
        last_seq: int | None = None,
    ) -> None:
        """Subscribe a peer at the CURRENT ring head: everything published
        after this call arrives through the cursor; the already-delivered
        prefix is the caller's catch-up problem (direct bytes or snapshot
        boot)."""
        if flavor not in (FLAVOR_WIRE, FLAVOR_ENVELOPE):
            raise ValueError(f"unknown flavor {flavor!r}")
        with self._lock:
            old = peer.sub
            if old is not None:
                # Re-attach replaces the subscription: leave the previous
                # ring's lists or the stale entry outlives the peer there
                # (remove_peer only cleans the CURRENT sub's doc).
                old_ring = self._docs.get(old.doc_id)
                if old_ring is not None:
                    if peer in old_ring.subs:
                        old_ring.subs.remove(peer)
                    if peer in old_ring.socket_subs:
                        old_ring.socket_subs.remove(peer)
            ring = self._ring(doc_id)
            floor = ring.last_seq if last_seq is None else last_seq
            peer.sub = _DeltaSub(doc_id, flavor, ring.head, floor)
            ring.subs.append(peer)
            if peer.is_socket:
                ring.socket_subs.append(peer)

    def add_signal_peer(
        self, doc_id: str, peer: FanoutPeer,
        interests: Iterable[str] | None = None,
    ) -> None:
        """Subscribe a peer to a document's signal scatter.  ``interests``
        narrows it to a scoped presence workspace: only signals published
        with a scope key in the set reach this peer (unscoped signals —
        joins/leaves/broadcast presence — always deliver).  ``None`` is the
        legacy firehose.  Re-calling replaces the interest set in place."""
        with self._lock:
            ring = self._ring(doc_id)
            if peer not in ring.signal_peers:
                ring.signal_peers.append(peer)
                peer.signal_docs.add(doc_id)
            peer.signal_interests[doc_id] = (
                None if interests is None else frozenset(interests)
            )

    # ---------------------------------------------------------------- directs
    def enqueue_direct(
        self, peer: FanoutPeer, data: bytes, droppable: bool = False,
        wake: bool = True,
    ) -> bool:
        """Queue per-peer bytes ordered AFTER every op frame already
        published for the peer's document.  Control messages (joined/nack/
        sync/catch-up) are never shed — they are small and session-bounded;
        droppable entries (signals) shed past the bound (at-most-once).
        ``wake=False`` lets a batch caller issue ONE writer wake for the
        whole scatter instead of one per peer."""
        with self._lock:
            if peer.dead:
                return False
            if droppable and len(peer.directs) >= self.max_directs:
                peer.signal_drops += 1
                self.signal_drops += 1
                instant("fanout_signal_drop", peer=peer.peer_id)
                return False
            sub = peer.sub
            wm = 0
            if sub is not None:
                ring = self._docs.get(sub.doc_id)
                wm = ring.head if ring is not None else 0
            peer.directs.append((wm, data))
            self.directs_enqueued += 1
        if wake and self._writer is not None and peer.is_socket:
            self._writer.wake([peer])
        return True

    # ---------------------------------------------------------------- signals
    def publish_signal(
        self, doc_id: str, client_id: str, contents: Any,
        scope: str | None = None,
    ) -> int:
        """Presence/signal scatter: ONE encode, N droppable enqueues, zero
        sequencer interaction, zero blocking sends under any caller lock.
        A ``scope`` key skips peers whose interest set for the doc excludes
        it (scoped presence workspaces); unscoped signals reach everyone."""
        with self._lock:
            ring = self._docs.get(doc_id)
            peers = list(ring.signal_peers) if ring is not None else []
            self.signals_published += 1
            if scope is not None and peers:
                kept = []
                for p in peers:
                    interests = p.signal_interests.get(doc_id)
                    if interests is None or scope in interests:
                        kept.append(p)
                    else:
                        self.presence_scope_drops += 1
                peers = kept
        if not peers:
            return 0
        data = (json.dumps(
            {"t": "signal", "clientId": client_id, "contents": contents},
            separators=(",", ":"),
        ) + "\n").encode()
        delivered = 0
        woken = []
        for peer in peers:
            if self.enqueue_direct(peer, data, droppable=True, wake=False):
                delivered += 1
                if peer.is_socket:
                    woken.append(peer)
        if woken and self._writer is not None:
            # ONE wake for the whole scatter: per-peer wakes would re-add
            # the very per-subscriber syscall cost this plane removes.
            self._writer.wake(woken)
        with self._lock:
            self.signal_deliveries += delivered
        return delivered

    # ------------------------------------------------------------------ drain
    def claim(self, peer: FanoutPeer, max_bytes: int | None = None):
        """Pop the next run of sendable buffers for a peer (writer tier or
        virtual drain).  Returns ``(buffers, needs_resync)``; when
        ``needs_resync`` the caller must invoke :meth:`resync` (with no
        plane lock held) and claim again.  Cursor/last_seq advance at claim
        time — the caller owns delivering what it claimed."""
        limit = self.claim_bytes if max_bytes is None else max_bytes
        bufs: list[bytes] = []
        total = 0
        with self._lock:
            sub = peer.sub
            ring = self._docs.get(sub.doc_id) if sub is not None else None
            # Behind: the ring evicted frames this cursor never saw.  No
            # partial progress — resync first so ordering (directs included)
            # rebuilds against the post-resync cursor.
            if sub is not None and ring is not None and sub.cursor < ring.base:
                return [], True
            while total < limit:
                if peer.directs and (
                    sub is None or peer.directs[0][0] <= sub.cursor
                ):
                    _wm, data = peer.directs.popleft()
                elif sub is not None and ring is not None and sub.cursor < ring.head:
                    frame = ring.frames[sub.cursor - ring.base]
                    data = frame.payload(sub.flavor)
                    sub.cursor += 1
                    sub.last_seq = frame.seq_hi
                    peer.sent_frames += 1
                else:
                    break
                bufs.append(data)
                total += len(data)
        return bufs, False

    def backlog_of(self, peer: FanoutPeer, head_cap: int | None = None) -> int:
        """Frames-behind + queued directs + claimed-unsent buffers: the
        consumer-pressure signal admission control reads.  Monotone under a
        stall even after ring eviction (the cursor keeps falling behind).
        ``head_cap`` counts ring frames only up to a snapshot head — a
        graceful-disconnect flush waits on what was queued at goodbye
        time, not on frames the doc keeps publishing after it."""
        with self._lock:
            n = len(peer.directs) + len(peer.outbuf)
            sub = peer.sub
            if sub is not None:
                ring = self._docs.get(sub.doc_id)
                if ring is not None:
                    head = ring.head if head_cap is None else min(
                        head_cap, ring.head
                    )
                    n += max(0, head - sub.cursor)
            return n

    def head_of(self, peer: FanoutPeer) -> int:
        """Current ring head for the peer's subscription (0 when none):
        the goodbye-time snapshot ``backlog_of(head_cap=...)`` consumes."""
        with self._lock:
            sub = peer.sub
            if sub is None:
                return 0
            ring = self._docs.get(sub.doc_id)
            return ring.head if ring is not None else 0

    def backlog(self, doc_id: str, wire_only: bool = True) -> int:
        """Deepest subscriber backlog for a document (socket peers; the
        firehose-consumer signal unless ``wire_only=False``)."""
        with self._lock:
            ring = self._docs.get(doc_id)
            if ring is None:
                return 0
            peers = [
                p for p in ring.socket_subs
                if not wire_only
                or (p.sub is not None and p.sub.flavor == FLAVOR_WIRE)
            ]
        return max((self.backlog_of(p) for p in peers), default=0)

    # ----------------------------------------------------------------- resync
    def resync(self, peer: FanoutPeer) -> None:
        """Rebuild a behind peer's missed range from the ordered log and
        jump its cursor to the head.  MUST be called with no plane lock
        held: the resync source takes the service lock (service → plane is
        the plane-wide lock order)."""
        sub = peer.sub
        if sub is None:
            return
        source = self._resync_source
        msgs = source(sub.doc_id, sub.last_seq) if source is not None else None
        with self._lock:
            if peer.dead or peer.sub is not sub:
                return
            ring = self._ring(sub.doc_id)
            if msgs:
                # Cap at the PUBLISHED head: the ordered log also holds
                # ticketed-but-undelivered ops — resyncing past the last
                # published frame would deliver them early AND again when
                # their own frame flushes (engines carry no seq dedupe
                # above the checkpoint floor, so that double-applies).
                msgs = [m for m in msgs if m.seq <= ring.last_seq]
            # The source read its log under the service lock; publishes are
            # serialized by that same lock, so frames that landed before
            # this point are covered by msgs IF their seq <= the read head.
            # Jump the cursor only past frames the rebuilt range covers.
            if msgs:
                frame = DeltaFrame(sub.doc_id, msgs, kind=KIND_RESYNC)
                data = frame.payload(sub.flavor)
                cursor = ring.base
                while (
                    cursor < ring.head
                    and ring.frames[cursor - ring.base].seq_hi <= frame.seq_hi
                ):
                    cursor += 1
                sub.cursor = cursor
                sub.last_seq = max(sub.last_seq, frame.seq_hi)
                peer.directs.appendleft((-1, data))
                peer.resyncs += 1
                self.resyncs += 1
                instant("fanout_resync", doc=sub.doc_id, peer=peer.peer_id,
                        n=frame.n_msgs)
            else:
                # Range no longer retained (or no source): direct the
                # subscriber to snapshot-boot from the historian tier.
                sub.cursor = ring.head
                sub.last_seq = ring.last_seq
                peer.directs.appendleft((-1, RESYNC_BOOT_MARKER))
                peer.resyncs += 1
                self.resyncs += 1
                self.boot_resyncs += 1
                instant("fanout_resync_boot", doc=sub.doc_id,
                        peer=peer.peer_id)

    # ---------------------------------------------------------- virtual drain
    def drain_virtual(self, peer: FanoutPeer, max_rounds: int = 1 << 20) -> int:
        """Drain a sink-backed peer to quiescence (bench/tests): feeds every
        claimed buffer to ``peer.sink`` in order.  Returns bytes drained."""
        drained = 0
        for _ in range(max_rounds):
            bufs, needs_resync = self.claim(peer)
            if needs_resync:
                self.resync(peer)
                continue
            if not bufs:
                break
            for b in bufs:
                if peer.sink is not None:
                    peer.sink(b)
                drained += len(b)
                peer.sent_bytes += len(b)
        return drained

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "peers": len(self._peers),
                "docs": len(self._docs),
                "subscribers": sum(len(r.subs) for r in self._docs.values()),
                "signal_peers": sum(
                    len(r.signal_peers) for r in self._docs.values()
                ),
                "frames_published": self.frames_published,
                "frame_bytes": self.frame_bytes,
                "frames_evicted": self.frames_evicted,
                "flushes": self.flushes,
                "resyncs": self.resyncs,
                "boot_resyncs": self.boot_resyncs,
                "signals_published": self.signals_published,
                "signal_deliveries": self.signal_deliveries,
                "signal_drops": self.signal_drops,
                "presence_scope_drops": self.presence_scope_drops,
                "directs_enqueued": self.directs_enqueued,
            }
