"""Networked service front-ends: TCP delta stream + HTTP storage reads.

A port of ``fluidframework_tpu/server/netserver.py`` (no JAX in it).

Reference parity: the routerlicious front-end plane —

- **nexus** (websocket front, server/routerlicious/packages/lambdas/src/
  nexus/index.ts:127): here a TCP JSON-lines protocol (one JSON object per
  line) carrying the connect_document handshake, op submission, signal
  relay, and the sequenced broadcast back to every connected socket.
- **alfred/historian** (REST front + snapshot storage): an HTTP endpoint
  serving delta ranges, snapshot read/write, and summary uploads.

Both fronts sit over the same in-process ordering core (``LocalService`` —
sequencer, broadcast, snapshot store), which is exactly the reference's
local-server/tinylicious shape: real network fronts, in-memory ordering.
Every mutation of the core runs under one lock; ticketed ops broadcast
immediately (network mode has no test-controlled delivery interleaving —
clients buffer and pump on their side).

Run standalone for cross-process use:

    python -m fluidframework_tpu_torch.server.netserver --port 7070 --http-port 7071
"""

from __future__ import annotations

import argparse
import contextlib
import json
import selectors
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..fanout import FLAVOR_ENVELOPE, FLAVOR_WIRE, FanoutPlane, FanoutWriter
from ..protocol.messages import MessageType, SequencedMessage, UnsequencedMessage
from .local_service import LocalService


def seq_msg_to_dict(msg: SequencedMessage) -> dict:
    return json.loads(msg.to_json())


def seq_msg_from_dict(d: dict) -> SequencedMessage:
    return SequencedMessage.from_json(json.dumps(d))


class _ClientSession:
    """Server-side state for one TCP connection.

    Every connection owns a fan-out peer from the moment it is accepted:
    ALL outbound bytes (handshake acks, errors, nacks, sync echoes, op
    frames, signals) ride the peer's queues and are written by the fan-out
    writer tier — handler threads and the broadcast path never block on a
    socket buffer, and never write the socket concurrently."""

    def __init__(self, handler: "_NexusHandler", peer, plane) -> None:
        self.handler = handler
        self.peer = peer
        self._plane = plane
        self.doc_id: str | None = None
        self.client_id: str | None = None

    def send(self, obj: dict) -> None:
        self.send_raw((json.dumps(obj) + "\n").encode())

    def send_raw(self, data: bytes) -> None:
        self._plane.enqueue_direct(self.peer, data)


class _NexusHandler(socketserver.StreamRequestHandler):
    """One thread per TCP client (ref: one socket.io connection).

    The READ half lives here (blocking in a selector, line-split in
    Python); the WRITE half lives on the shared fan-out writer thread —
    the socket is nonblocking so a full outbound buffer parks the peer in
    the writer's selector instead of stalling anything."""

    def handle(self) -> None:
        server: NetworkServer = self.server.owner  # type: ignore[attr-defined]
        sock = self.connection
        with contextlib.suppress(OSError):  # best-effort latency knob
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setblocking(False)
        peer = server.fanout.new_peer(sock=sock)
        session = _ClientSession(self, peer, server.fanout)
        try:
            self._read_loop(server, session, sock)
        except OSError:
            # Torn peer mid-read (abrupt client death, chaos torn-socket):
            # normal teardown, counted for the overload/chaos surface —
            # the finally broadcasts the leave via drop_session.
            with server.lock:
                server.torn_sockets += 1
        finally:
            server.drop_session(session)

    def _read_loop(self, server: "NetworkServer", session, sock) -> None:
        sel = selectors.DefaultSelector()
        sel.register(sock, selectors.EVENT_READ)
        buf = b""
        try:
            while True:
                sel.select()
                try:
                    data = sock.recv(1 << 16)
                except (BlockingIOError, InterruptedError):
                    continue
                if not data:
                    return  # orderly EOF
                buf += data
                while True:
                    cut = buf.find(b"\n")
                    if cut < 0:
                        break
                    line, buf = buf[:cut].strip(), buf[cut + 1:]
                    if line and not self._dispatch(server, session, line):
                        return
        finally:
            sel.close()

    def _dispatch(self, server: "NetworkServer", session, line: bytes) -> bool:
        """One protocol request; False ends the session (disconnect)."""
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            session.send({"t": "error", "reason": "bad json", "canRetry": False})
            return True
        kind = req.get("t")
        if kind == "connect":
            server.handle_connect(session, req)
        elif kind == "consume":
            server.handle_consume(session, req)
        elif kind == "submit":
            server.handle_submit(session, req)
        elif kind == "signal":
            server.handle_signal(session, req)
        elif kind == "interests":
            server.handle_interests(session, req)
        elif kind == "sync":
            # Echo AFTER everything already broadcast on this socket: the
            # echo rides the peer queue behind every frame already
            # published for the session's document (direct-watermark
            # ordering) — the client's deterministic quiescence marker.
            session.send({"t": "sync", "n": req.get("n", 0)})
        elif kind == "disconnect":
            # Graceful goodbye: everything already queued for this socket
            # (a pipelined sync echo, the tail of the broadcast) must reach
            # the wire before drop_session clears the peer's queues — the
            # old synchronous write loop guaranteed exactly this.
            server.flush_peer(session.peer)
            return False
        else:
            session.send(
                {"t": "error", "reason": f"unknown op {kind!r}", "canRetry": False}
            )
        return True


class NetworkServer:
    """The TCP front over one LocalService core.

    Fronts are STATELESS (§2.6.5): several NetworkServer/HttpFront
    instances may share one core — pass the same ``service`` and ``lock``
    to each (the reference scales nexus/alfred horizontally behind
    Redis/Kafka the same way; here the shared core is in-process)."""

    def __init__(
        self,
        service: LocalService | None = None,
        port: int = 0,
        lock: threading.RLock | None = None,
        admission=None,
    ) -> None:
        self.service = service if service is not None else LocalService()
        self.lock = lock if lock is not None else threading.RLock()
        # Optional submit admission control (server/admission.py): when
        # set, overloaded documents nack submits with a load-derived
        # retryAfter instead of ticketing them (deli's throttling nack).
        self.admission = admission
        # The read fan-out plane: encode-once delta frames on a bounded
        # per-doc ring, per-session peers drained by ONE selector-driven
        # writer thread with vectored sends.  Documents are tapped with a
        # single stream subscriber each (however many sockets), so the
        # broadcast path under the service lock is O(1) per message.
        self.fanout = FanoutPlane(resync_source=self._resync_source)
        self.fanout_writer = FanoutWriter(self.fanout)
        self.fanout.set_writer(self.fanout_writer)
        self._tapped: set[str] = set()
        # Peers that vanished mid-read without a disconnect handshake
        # (abrupt client death / chaos torn sockets) — a fault-visibility
        # counter, surfaced through service_stats.
        self.torn_sockets = 0

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _Srv(("127.0.0.1", port), _NexusHandler)
        self._tcp.owner = self  # type: ignore[attr-defined]
        self.port = self._tcp.server_address[1]
        self._thread = threading.Thread(target=self._tcp.serve_forever, daemon=True)

    def start(self) -> "NetworkServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        self.fanout_writer.stop()

    # --------------------------------------------------------- fanout wiring
    def _ensure_tap(self, doc) -> None:
        """Install the ONE fan-out tap for a document (caller holds the
        lock): a single stream subscriber accumulates each pump's batch,
        and a single signal subscriber scatters presence through the
        writer tier — per-socket callbacks are gone from the ordering
        path."""
        doc_id = doc.doc_id
        if doc_id in self._tapped:
            return
        self._tapped.add(doc_id)
        log = doc.sequencer.log
        delivered = len(log) - doc.pending_count
        self.fanout.ensure_doc(
            doc_id, last_seq=log[delivered - 1].seq if delivered else 0
        )
        plane = self.fanout
        # Tap id is per-FRONT: several stateless fronts may share one core
        # (each with its own fan-out plane), and stream subscriptions are
        # keyed by id — a shared name would let the last front clobber the
        # others' taps.
        tap_id = f"__fanout__{id(self)}"
        doc.subscribe_stream(
            tap_id, lambda msg, d=doc_id: plane.tap(d, msg)
        )
        doc.subscribe_signals(
            tap_id,
            # Scoped presence: a dict signal carrying a "scope" key fans
            # out only to peers whose interest set covers it.
            lambda sig, d=doc_id: plane.publish_signal(
                d, sig.client_id, sig.contents,
                scope=(
                    sig.contents.get("scope")
                    if isinstance(sig.contents, dict) else None
                ),
            ),
        )
        # Pump-boundary flush: ANY driver of process_all (handlers here,
        # harnesses poking the doc under the service lock) publishes the
        # pump's frame — delivery never depends on who pumped.
        doc.on_pump(lambda d=doc_id: plane.flush(d))

    def _pump_doc(self, doc) -> None:
        """Deliver queued sequenced messages (caller holds the lock):
        process_all walks ONE tap per message, and the tap's ``on_pump``
        hook — the single owner of the delivery contract, shared with
        harnesses that drive process_all directly — flushes the frame and
        wakes the writer tier."""
        doc.process_all()

    def _resync_source(self, doc_id: str, from_seq: int):
        """Rebuild a behind subscriber's missed range from the ordered log
        (called by the fan-out plane with no plane lock held)."""
        with self.lock:
            doc = self.service.peek_document(doc_id)
            if doc is None:
                return None
            return doc.ops_range(from_seq + 1, 1 << 60)

    # ----------------------------------------------------------- op handlers
    def handle_connect(self, session: _ClientSession, req: dict) -> None:
        from .auth import AuthError

        doc_id = req["doc"]
        client_id = req["client"]
        mode = req.get("mode", "write")
        with self.lock:
            if session.doc_id is not None:
                session.send({
                    "t": "error",
                    "reason": "session already bound to a document",
                    "canRetry": False,
                })
                return
            doc = self.service.document(doc_id)
            self._ensure_tap(doc)

            def on_nack(nack, s=session) -> None:
                s.send(
                    {
                        "t": "nack",
                        "clientId": nack.client_id,
                        "clientSeq": nack.client_seq,
                        "reason": nack.reason,
                        "retryAfter": nack.retry_after,
                    }
                )

            try:
                # subscriber=None: delivery rides the doc's fan-out tap —
                # the broadcast frame (encoded once per pump) reaches this
                # socket through its peer cursor, not a per-socket callback.
                join, delivered_seq = doc.connect_stream(
                    client_id, None, on_nack, mode=mode, token=req.get("token")
                )
            except (AuthError, ValueError) as e:
                session.send(
                    {"t": "error", "reason": f"connection rejected: {e}", "canRetry": False}
                )
                return
            session.doc_id = doc_id
            session.client_id = client_id
            self.fanout.attach(
                doc_id, session.peer, flavor=FLAVOR_ENVELOPE,
                last_seq=delivered_seq,
            )
            if req.get("signals"):
                # Optional "interests": a scoped presence workspace — only
                # signals published with a scope key in the list (plus all
                # unscoped signals) reach this session.
                self.fanout.add_signal_peer(
                    doc_id, session.peer, interests=req.get("interests"),
                )
                # Audience catch-up: current read membership, self included
                # (the connect handshake's "initialClients") — enqueued
                # without per-member wakes, ONE writer wake for the batch.
                for member_id, details in doc.read_members().items():
                    payload = (json.dumps({
                        "t": "signal",
                        "clientId": "",
                        "contents": {
                            "type": "clientJoin",
                            "clientId": member_id,
                            "details": details,
                        },
                    }) + "\n").encode()
                    self.fanout.enqueue_direct(
                        session.peer, payload, wake=False
                    )
                self.fanout_writer.wake([session.peer])
            session.send(
                {
                    "t": "joined",
                    "join": seq_msg_to_dict(join) if join else None,
                    "deliveredSeq": delivered_seq,
                }
            )
            self._pump_doc(doc)  # broadcast the join immediately

    def handle_consume(self, session: _ClientSession, req: dict) -> None:
        """Firehose subscription: the sequenced stream as BARE message JSON
        lines (SequencedMessage.to_json, one per line) — the deltas-topic
        consumer seam (ref deli produce -> lambdas consume,
        deli/lambda.ts:851).  No quorum join, no audience membership; the
        bytes are exactly what native/ingest.cpp parses, so a device fleet
        consumer forwards them without any per-op Python.  Consumers share
        the SAME once-encoded frames as every other subscriber of the doc
        (one encode per (doc, pump)); a consumer that falls off the
        bounded frame ring is resynced from the log, byte-identically."""
        from .auth import AuthError

        doc_id = req["doc"]
        from_seq = int(req.get("from", 0))
        with self.lock:
            if session.doc_id is not None:
                session.send({
                    "t": "error",
                    "reason": "session already bound to a document",
                    "canRetry": False,
                })
                return
            doc = self.service.document(doc_id)
            if doc.token_manager is not None:
                # The firehose exposes the full op log: same riddler
                # admission control as every other front.
                try:
                    doc.token_manager.validate(
                        req.get("token"), doc_id, "__consumer__"
                    )
                except AuthError as e:
                    session.send({
                        "t": "error",
                        "reason": f"consume rejected: {e}",
                        "canRetry": False,
                    })
                    return
            self._ensure_tap(doc)
            consumer_id = f"__consumer__{id(session)}"
            session.doc_id = doc_id
            session.client_id = consumer_id
            log = doc.sequencer.log
            delivered = len(log) - doc.pending_count
            delivered_seq = log[delivered - 1].seq if delivered else 0
            self.fanout.attach(
                doc_id, session.peer, flavor=FLAVOR_WIRE,
                last_seq=delivered_seq,
            )
            # Envelope ack + catch-up (the already-delivered prefix, cached
            # per-message encodes) as ONE direct buffer: a consumer that
            # just read the ack already has the catch-up behind it in its
            # receive buffer — its first pump stages the history instead of
            # racing the writer tier's next send.  Pending-delivery msgs
            # arrive through the ring, mirroring connect().
            ack = (json.dumps({"t": "consuming", "doc": doc_id}) + "\n").encode()
            catch = b"".join(
                m.wire_line() for m in log[:delivered] if m.seq > from_seq
            )
            session.send_raw(ack + catch)

    def consumer_backlog(self, doc_id: str) -> int:
        """Deepest outbound firehose backlog for the document (frames
        behind + queued directs + claimed-unsent buffers): the
        downstream-credit signal the admission check reads."""
        return self.fanout.backlog(doc_id)

    def flush_peer(self, peer, timeout_s: float = 5.0) -> None:
        """Best-effort drain of a peer's queued outbound bytes (graceful
        disconnect).  Doubly bounded: only work queued at goodbye time
        counts (a hot doc publishing past the goodbye must not extend the
        wait), and a peer that stopped reading forfeits its tail after
        ``timeout_s`` — never a handler-thread stall beyond that."""
        goodbye_head = self.fanout.head_of(peer)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if peer.dead or self.fanout.backlog_of(
                peer, head_cap=goodbye_head
            ) == 0:
                return
            self.fanout_writer.wake([peer])
            time.sleep(0.002)

    @staticmethod
    def doc_pressure(doc) -> int:
        """The admission check's sequencer-side load signal: un-broadcast
        backlog OR the uncompacted collab-window depth (seq - MSN),
        whichever is deeper.  The network front broadcasts synchronously
        (pending_count is ~always 0 here), so the window is the signal
        that actually moves: it grows while any connected client lags
        applying — ingest outrunning the fleet — and recovers as client
        refSeqs (and therefore the MSN) catch up."""
        seqr = doc.sequencer
        return max(doc.pending_count, seqr.seq - seqr.min_seq)

    def handle_submit(self, session: _ClientSession, req: dict) -> None:
        with self.lock:
            if session.doc_id is None:
                session.send({"t": "error", "reason": "submit before connect", "canRetry": False})
                return
            doc = self.service.document(session.doc_id)
            if self.admission is not None and (
                req["msg"].get("type", MessageType.OP) != MessageType.NOOP
            ):
                # NOOPs always admit: they carry no content, advance the
                # sender's refSeq (and therefore the MSN), and are exactly
                # how a backed-off client helps the collab window — and
                # the overload — shrink.  Shedding them would livelock the
                # window signal at its high watermark.
                retry = self.admission.admit(
                    session.doc_id,
                    pending=self.doc_pressure(doc),
                    consumer_backlog=self.consumer_backlog(session.doc_id),
                )
                if retry is not None:
                    # Shed at the door: the op never reaches the sequencer,
                    # so the client's clientSeq is still valid — it backs
                    # off retryAfter and resubmits THE SAME op on the SAME
                    # connection (canRetry; no teardown, no rejoin churn).
                    # The nack needs only the id pair: shedding must stay
                    # cheap under the very overload it exists for, so the
                    # wire decode happens only for ADMITTED ops.
                    wire = req["msg"]
                    session.send({
                        "t": "nack",
                        "clientId": wire.get("clientId"),
                        "clientSeq": wire.get("clientSequenceNumber", 0),
                        "reason": "overloaded: submit shed by admission "
                                  "control",
                        "retryAfter": retry,
                        "canRetry": True,
                    })
                    return
            msg = UnsequencedMessage.from_json(json.dumps(req["msg"]))
            doc.submit(msg)
            self._pump_doc(doc)  # network mode: broadcast as ticketed

    def handle_signal(self, session: _ClientSession, req: dict) -> None:
        with self.lock:
            if session.doc_id is None:
                return
            # Delivery is queue-only under the lock: submit_signal reaches
            # the doc's fan-out tap, which encodes the signal ONCE and
            # appends bounded droppable directs — a slow signal subscriber
            # can no longer stall op ticketing (at-most-once by contract).
            self.service.document(session.doc_id).submit_signal(
                session.client_id, req.get("content")
            )

    def handle_interests(self, session: _ClientSession, req: dict) -> None:
        """Replace the session's scoped-presence interest set in place
        (None = back to the unscoped firehose)."""
        with self.lock:
            if session.doc_id is None:
                return
            self.fanout.add_signal_peer(
                session.doc_id, session.peer, interests=req.get("interests"),
            )

    def drop_session(self, session: _ClientSession) -> None:
        with self.lock:
            self.fanout.remove_peer(session.peer)
            if session.doc_id is not None and session.client_id is not None:
                doc = self.service.document(session.doc_id)
                doc.disconnect(session.client_id)
                self._pump_doc(doc)  # broadcast the leave


class _AlfredHandler(BaseHTTPRequestHandler):
    """REST storage front (alfred delta reads + historian snapshots)."""

    def log_message(self, *a) -> None:  # quiet
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self):
        u = urlparse(self.path)
        parts = [p for p in u.path.split("/") if p]
        return parts, parse_qs(u.query)

    def _doc(self, server: "HttpFront", doc_id: str, create: bool = False):
        """Authenticated document lookup.  Reads are NON-creating (a read
        probe must not instantiate state; alfred 404s unknown docs); writes
        get-or-create (historian creates storage on first write).  When
        tenant auth is on, every front validates (riddler validates all
        fronts)."""
        if create:
            doc = server.service.document(doc_id)
        else:
            doc = server.service.peek_document(doc_id)
            if doc is None:
                self._json(404, {"error": "no such document"})
                return None
        if doc.token_manager is not None:
            from .auth import AuthError

            auth = self.headers.get("Authorization", "")
            token = auth.removeprefix("Bearer ").strip() or None
            try:
                doc.token_manager.validate(token, doc_id, "__storage__")
            except AuthError as e:
                self._json(401, {"error": str(e)})
                return None
        return doc

    def do_GET(self) -> None:  # noqa: N802
        server: HttpFront = self.server.owner  # type: ignore[attr-defined]
        parts, q = self._route()
        with server.lock:
            if parts in (["metrics"], ["status"]):
                # Ordering-tier observability surface: the same /metrics
                # (Prometheus text) + /status (JSON) shape the fleet tier
                # serves, aggregating per-doc sequencer log depth, pending
                # delivery, and connected-client counts.
                from ..observability.metrics_plane import render_prometheus

                stats = server.service_stats()
                if parts == ["status"]:
                    self._json(200, stats)
                else:
                    body = render_prometheus(stats).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                return
            if (
                parts[:1] != ["doc"]
                or len(parts) < 3
                or (len(parts) == 4 and parts[2] not in ("blob", "git"))
                or len(parts) > 4
            ):
                self._json(404, {"error": "bad route"})
                return
            doc = self._doc(server, parts[1])
            if doc is None:
                return
            if len(parts) == 4 and parts[2] == "git":
                # /doc/<id>/git/<sha>: raw git object read (historian's
                # object surface; tree entries are child shas, so a client
                # can walk subtrees without fetching the whole snapshot).
                try:
                    kind, payload = doc.read_git_object(parts[3])
                except KeyError:
                    self._json(404, {"error": "no such object"})
                    return
                self._json(200, {"kind": kind, "payload": payload})
            elif len(parts) == 4:  # /doc/<id>/blob/<blobId>
                try:
                    self._json(200, {"content": doc.read_blob(parts[3])})
                except KeyError:
                    self._json(404, {"error": "no such blob"})
            elif parts[2] == "deltas":
                try:
                    lo = int(q.get("from", ["1"])[0])
                    hi = int(q.get("to", ["0"])[0]) or 1 << 30
                except ValueError:
                    self._json(400, {"error": "non-numeric range"})
                    return
                ops = [seq_msg_to_dict(m) for m in doc.ops_range(lo, hi)]
                self._json(200, {"ops": ops})
            elif parts[2] == "snapshot":
                version = q.get("version", [None])[0]
                snap = (
                    doc.latest_snapshot()
                    if version is None
                    else doc.snapshot_at(version)
                )
                if snap is None:
                    self._json(404, {"error": "no snapshot"})
                else:
                    self._json(200, {"seq": snap[0], "summary": snap[1]})
            elif parts[2] == "versions":
                try:
                    max_count = int(q.get("max", ["5"])[0])
                except ValueError:
                    self._json(400, {"error": "non-numeric max"})
                    return
                if max_count <= 0:
                    self._json(400, {"error": "max must be positive"})
                    return
                self._json(200, {"versions": doc.snapshot_versions(max_count)})
            elif parts[2] == "stats":
                self._json(
                    200,
                    {
                        "logLen": len(doc.sequencer.log),
                        "pending": doc.pending_count,
                        "clients": sorted(doc.sequencer.clients()),
                    },
                )
            else:
                self._json(404, {"error": "bad route"})

    def do_PUT(self) -> None:  # noqa: N802
        server: HttpFront = self.server.owner  # type: ignore[attr-defined]
        parts, _q = self._route()
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            self._json(400, {"error": "missing body"})
            return
        try:
            body = json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            self._json(400, {"error": "bad json"})
            return
        with server.lock:
            if len(parts) == 3 and parts[0] == "doc" and parts[2] == "snapshot":
                doc = self._doc(server, parts[1], create=True)
                if doc is None:
                    return
                doc.save_snapshot(body["seq"], body["summary"])
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": "bad route"})

    def do_POST(self) -> None:  # noqa: N802
        server: HttpFront = self.server.owner  # type: ignore[attr-defined]
        parts, _q = self._route()
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length)) if length else {}
        with server.lock:
            if len(parts) == 3 and parts[0] == "doc" and parts[2] == "summary":
                doc = self._doc(server, parts[1], create=True)
                if doc is None:
                    return
                handle = doc.upload_summary(body["tree"])
                self._json(200, {"handle": handle})
            elif len(parts) == 3 and parts[0] == "doc" and parts[2] == "blob":
                doc = self._doc(server, parts[1], create=True)
                if doc is None:
                    return
                self._json(200, {"id": doc.upload_blob(body["content"])})
            else:
                self._json(404, {"error": "bad route"})


class HttpFront:
    def __init__(
        self,
        service: LocalService,
        lock: threading.RLock,
        port: int = 0,
        nexus: "NetworkServer | None" = None,
    ) -> None:
        self.service = service
        self.lock = lock
        # The co-deployed TCP front (when any): source of the per-doc
        # consumer-backlog and admission/overload surfaces in stats.
        self.nexus = nexus
        self._started = time.monotonic()
        self._http = ThreadingHTTPServer(("127.0.0.1", port), _AlfredHandler)
        self._http.owner = self  # type: ignore[attr-defined]
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    def service_stats(self) -> dict:
        """Ordering-core aggregate for /metrics + /status (caller holds the
        lock): per-doc sequencer log depth, pending delivery, clients —
        the ordered-log depth surface of the metrics plane."""
        docs = {}
        nexus = self.nexus
        admission = nexus.admission if nexus is not None else None
        for doc_id, doc in self.service._docs.items():
            row = {
                "log_depth": len(doc.sequencer.log),
                "pending": doc.pending_count,
                "window": doc.sequencer.seq - doc.sequencer.min_seq,
                "clients": len(doc.sequencer.clients()),
            }
            if nexus is not None:
                row["consumer_backlog"] = nexus.consumer_backlog(doc_id)
            if admission is not None:
                row.update(admission.doc_stats(doc_id))
            docs[doc_id] = row
        out = {
            "uptime_s": round(time.monotonic() - self._started, 3),
            "n_docs": len(docs),
            "docs": docs,
        }
        if nexus is not None:
            out["torn_sockets"] = nexus.torn_sockets
            # Read fan-out surface: frames published/evicted, resyncs,
            # signal deliveries/drops, writer-tier send totals.
            fanout = nexus.fanout.stats()
            fanout["writer"] = nexus.fanout_writer.stats()
            out["fanout"] = fanout
        if admission is not None:
            # Graceful-degradation surface: the front's overload state and
            # shed-op totals, scrapeable (/metrics) and curl-able (/status).
            out["admission"] = admission.stats()
        return out

    def start(self) -> "HttpFront":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()


class ServicePlane:
    """Both fronts over one shared core: the deployable unit (tinylicious
    analog).  ``ports`` are assigned when 0 (tests use ephemeral ports).

    ``historian_port`` additionally serves the snapshot-boot tier
    (fanout.historian): summary commits straight out of the git snapshot
    store behind ETag/304 caching, on its own server so boot storms never
    contend with the ordering lock.  None (default) keeps it off."""

    def __init__(
        self, port: int = 0, http_port: int = 0, admission=None,
        historian_port: int | None = None,
    ) -> None:
        self.nexus = NetworkServer(port=port, admission=admission)
        self.http = HttpFront(
            self.nexus.service, self.nexus.lock, port=http_port,
            nexus=self.nexus,
        )
        self.historian = None
        if historian_port is not None:
            from ..fanout.historian import HistorianTier, service_snapshot_source

            self.historian = HistorianTier(
                service_snapshot_source(self.nexus.service),
                port=historian_port,
            )

    @property
    def service(self) -> LocalService:
        return self.nexus.service

    def start(self) -> "ServicePlane":
        self.nexus.start()
        self.http.start()
        if self.historian is not None:
            self.historian.start()
        return self

    def stop(self) -> None:
        self.nexus.stop()
        self.http.stop()
        if self.historian is not None:
            self.historian.stop()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--http-port", type=int, default=0)
    p.add_argument("--max-pending", type=int, default=0,
                   help="admission control: nack submits with retryAfter "
                        "when a doc's sequencer pressure (un-broadcast "
                        "backlog or uncompacted collab-window depth, "
                        "seq - MSN) exceeds this (0 = no admission "
                        "control)")
    p.add_argument("--max-consumer-backlog", type=int, default=0,
                   help="admission control: nack submits when a doc's "
                        "deepest firehose consumer backlog exceeds this "
                        "(0 = signal disabled)")
    p.add_argument("--historian-port", type=int, default=0,
                   help="snapshot-boot tier port (0 = ephemeral; pass -1 "
                        "to disable): summary commits served from the git "
                        "store behind ETag/304 caching, off the ordering "
                        "lock")
    args = p.parse_args()
    http_port = args.http_port
    if not http_port:
        http_port = args.port + 1 if args.port else 0  # ephemeral stays ephemeral
    admission = None
    if args.max_pending or args.max_consumer_backlog:
        from .admission import AdmissionConfig, AdmissionController

        admission = AdmissionController(AdmissionConfig(
            max_pending=args.max_pending,
            max_consumer_backlog=args.max_consumer_backlog,
        ))
    plane = ServicePlane(
        port=args.port, http_port=http_port, admission=admission,
        historian_port=None if args.historian_port < 0 else args.historian_port,
    )
    plane.start()
    # Readiness line for process supervisors / tests.
    ready = {"port": plane.nexus.port, "httpPort": plane.http.port}
    if plane.historian is not None:
        ready["historianPort"] = plane.historian.port
    print(json.dumps(ready), flush=True)
    threading.Event().wait()  # serve until killed


if __name__ == "__main__":
    main()
