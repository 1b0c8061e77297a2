"""The port's own copy of ``fluidframework_tpu/server/local_service.py`` (no JAX in it).

In-process ordering service for tests and local development.

Reference parity: memory-orderer ``LocalOrderer`` + local-server
``LocalDeltaConnectionServer`` (the full deli pipeline in-process, no
Kafka/Mongo/Redis) — the backbone of the reference's integration tests.

Deterministic delivery control: ops are ticketed immediately but delivery to
subscribers is explicit via ``process_all`` / ``process_some``, mirroring the
reference's ``MockContainerRuntimeFactory.processAllMessages`` pattern that
DDS tests use to control interleaving.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

from ..protocol.messages import MessageType, Nack, SequencedMessage, SignalMessage, UnsequencedMessage
from .sequencer import Sequencer

Subscriber = Callable[[SequencedMessage], None]
SignalSubscriber = Callable[[SignalMessage], None]


class _SnapshotChain:
    """Thin facade over the git-tree snapshot store (gitstore.py): the
    service (and tests) keep appending/clearing/tail-indexing it like the
    old plain list, while every saved version physically shares unchanged
    subtrees.  Only the surface actually used exists — indexing
    materializes a full snapshot, so nothing here invites iteration."""

    def __init__(self) -> None:
        from .gitstore import GitSnapshotStore

        self.git = GitSnapshotStore()

    def append(self, entry: tuple[int, dict]) -> None:
        self.git.save(entry[0], entry[1])

    def clear(self) -> None:
        self.git.versions.clear()  # refs only; objects are immutable

    def __bool__(self) -> bool:
        return bool(self.git.versions)

    def __getitem__(self, i: int) -> tuple[int, dict]:
        seq, commit = self.git.versions[i]
        return seq, self.git.read_commit(commit)[1]

    @property
    def last_seq(self) -> int:
        return self.git.versions[-1][0]


class LocalDocument:
    """One ordered document: a sequencer plus broadcast fan-out."""

    def __init__(self, doc_id: str) -> None:
        self.doc_id = doc_id
        self.sequencer = Sequencer()
        self._subscribers: dict[str, Subscriber] = {}
        self._nack_handlers: dict[str, Callable[[Nack], None]] = {}
        self._pending: deque[SequencedMessage] = deque()
        self.nacks: list[Nack] = []
        # Snapshot store: the GIT-TREE storage model (historian -> gitrest;
        # server/gitstore.py) — every version is a content-addressed tree,
        # unchanged subtrees share objects physically across versions.
        self._snapshots = _SnapshotChain()
        self._signal_subscribers: dict[str, SignalSubscriber] = {}
        # Staged summary uploads awaiting their summarize op (the reference
        # uploads the ISummaryTree to storage, then the op carries a handle).
        self._uploads: dict[str, dict] = {}
        self._upload_counter = 0
        # Attachment blob store (historian blob analog): content-addressed,
        # so identical uploads dedup to one id (ref blobManager.ts dedup).
        self._blobs: dict[str, str] = {}
        # Optional riddler-analog token validation (server/auth.py); set via
        # LocalService.enable_auth.
        self.token_manager = None
        # Read-mode connections: audience membership WITHOUT quorum entry
        # (ref nexus connect_document — read clients never produce a
        # sequenced join; fronts broadcast their join/leave as system
        # signals and hand new subscribers the current list, the
        # "initialClients" of the connect handshake).
        self._read_members: dict[str, dict] = {}
        # Pump-boundary hooks: invoked at the end of every process_all that
        # delivered anything.  The fan-out plane flushes its per-pump frame
        # here, so EVERY delivery driver (network handlers, in-process
        # tests, harnesses calling process_all directly) publishes to
        # subscribers without knowing about the plane.
        self._pump_listeners: list[Callable[[], None]] = []

    def connect(
        self,
        client_id: str,
        subscriber: Subscriber,
        on_nack: Callable[[Nack], None] | None = None,
        token: str | None = None,
    ) -> SequencedMessage:
        """Join a client and subscribe it to the broadcast stream.

        Late joiners are caught up synchronously with the already-delivered
        prefix of the op log (snapshot-free catch-up; the reference loads a
        snapshot plus trailing ops — the trailing-ops path is what this is).
        Messages still queued for delivery arrive through the normal pump.
        """
        if self.token_manager is not None:
            # Admission control applies to EVERY write join, in-process
            # connections included (riddler validates all fronts).
            self.token_manager.validate(token, self.doc_id, client_id)
        already_delivered = len(self.sequencer.log) - len(self._pending)
        for msg in self.sequencer.log[:already_delivered]:
            subscriber(msg)
        join = self.sequencer.join(client_id)
        self._subscribers[client_id] = subscriber
        if on_nack is not None:
            self._nack_handlers[client_id] = on_nack
        self._pending.append(join)
        return join

    def disconnect(self, client_id: str) -> None:
        self._subscribers.pop(client_id, None)
        self._nack_handlers.pop(client_id, None)
        self._signal_subscribers.pop(client_id, None)
        details = self._read_members.pop(client_id, None)
        if details is not None:
            self._broadcast_membership("clientLeave", client_id, details)
        # A client can bail out mid-catch-up, before its join was ticketed
        # (e.g. fork detection closes the container); nothing to leave then.
        if client_id in self.sequencer.clients():
            self._pending.append(self.sequencer.leave(client_id))

    def _broadcast_membership(self, kind: str, client_id: str, details: dict) -> None:
        # Sender "" is the SERVICE identity — connects reject empty client
        # ids and submit_signal stamps the connection's id, so clients
        # cannot forge membership events (the audience trusts only these).
        sig = SignalMessage(
            client_id="",
            contents={"type": kind, "clientId": client_id, "details": details},
        )
        for sub in list(self._signal_subscribers.values()):
            sub(sig)

    def submit(self, msg: UnsequencedMessage) -> SequencedMessage | Nack:
        """Ticket an op; queues the sequenced result for broadcast.

        Nacks are routed back to the submitting client's nack handler (the
        reference sends them on the socket to the offending client only).
        """
        out = self.sequencer.ticket(msg)
        if isinstance(out, Nack):
            self.nacks.append(out)
            handler = self._nack_handlers.get(msg.client_id)
            if handler is not None:
                handler(out)
        else:
            self._pending.append(out)
        return out

    def connect_stream(
        self,
        client_id: str,
        subscriber: Subscriber | None,
        on_nack: Callable[[Nack], None] | None = None,
        mode: str = "write",
        token: str | None = None,
    ) -> tuple[SequencedMessage | None, int]:
        """Driver-style connect: subscribe WITHOUT catch-up replay.

        The reference's ``connect_document`` handshake joins the socket room
        and returns connection details; the client fetches the gap between
        its snapshot and the stream head from delta storage itself. Returns
        ``(join_msg, delivered_seq)``: ``join_msg`` is the ticketed join
        (None in read mode — read clients never enter the quorum,
        ref connectionManager.ts read/write modes), ``delivered_seq`` the
        highest seq already broadcast — everything above it will arrive
        through this subscription.

        ``subscriber=None`` joins/nack-wires the client WITHOUT a
        per-client delivery callback: the fan-out plane's document tap
        (one subscriber per doc, however many sockets) carries delivery —
        the per-socket Python walk in ``process_some`` disappears.
        """
        if not client_id:
            raise ValueError("empty client id (reserved for the service)")
        if self.token_manager is not None:
            # Front-end admission control (riddler token validation).
            self.token_manager.validate(token, self.doc_id, client_id)
        delivered = len(self.sequencer.log) - len(self._pending)
        delivered_seq = self.sequencer.log[delivered - 1].seq if delivered else 0
        join = None
        if mode == "write":
            join = self.sequencer.join(client_id)
            self._pending.append(join)
        if subscriber is not None:
            self._subscribers[client_id] = subscriber
        if on_nack is not None:
            self._nack_handlers[client_id] = on_nack
        if mode != "write":
            details = {"mode": "read"}
            self._read_members[client_id] = details
            self._broadcast_membership("clientJoin", client_id, details)
        return join, delivered_seq

    def subscribe_stream(self, consumer_id: str, subscriber: Subscriber) -> None:
        """Raw sequenced-stream subscription: no quorum join, no audience
        membership — the deltas-topic consumer seam used by server-side
        lambdas and the device fleet consumer."""
        self._subscribers[consumer_id] = subscriber

    def subscribe_signals(self, client_id: str, subscriber: SignalSubscriber) -> None:
        self._signal_subscribers[client_id] = subscriber
        # Audience catch-up: hand the new subscriber the current read
        # membership, its own included (the connect handshake's
        # "initialClients" — a client's audience contains itself,
        # ref audience.ts getSelf).
        for member_id, details in self._read_members.items():
            subscriber(SignalMessage(
                client_id="",
                contents={
                    "type": "clientJoin",
                    "clientId": member_id,
                    "details": details,
                },
            ))

    def submit_signal(self, client_id: str, contents) -> None:
        """Unsequenced broadcast (ref broadcaster signal path / nexus signal
        relay): delivered synchronously to every signal subscriber, sender
        included — per-sender order preserved, no total order, no log."""
        sig = SignalMessage(client_id=client_id, contents=contents)
        for sub in list(self._signal_subscribers.values()):
            sub(sig)

    def read_members(self) -> dict[str, dict]:
        """Current read-mode audience membership (copy): the connect
        handshake's "initialClients" surface, consumed by fronts that hand
        a new signal subscriber its catch-up without reaching into
        private state."""
        return dict(self._read_members)

    def snapshot_store(self):
        """The document's git version chain (``GitSnapshotStore``): the
        snapshot-boot tier serves commits straight from here — reads walk
        immutable content-addressed objects, no sequencer interaction."""
        return self._snapshots.git

    def ops_range(self, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        """Sequenced ops with from_seq <= seq <= to_seq (delta storage read;
        ref deltaStorageService). Seqs are dense (every ticket increments),
        so this is an index slice — O(range), not O(log)."""
        log = self.sequencer.log
        if not log or to_seq < from_seq:
            return []
        base = log[0].seq  # first seq in the log (starting_seq + 1)
        lo = max(from_seq - base, 0)
        hi = min(to_seq - base + 1, len(log))
        return log[lo:hi] if lo < hi else []

    def save_snapshot(self, seq: int, summary: dict) -> None:
        if self._snapshots and seq < self._snapshots.last_seq:
            raise ValueError("snapshot seq regression")
        self._snapshots.append((seq, summary))

    def latest_snapshot(self) -> tuple[int, dict] | None:
        return self._snapshots.git.latest()

    def snapshot_versions(self, max_count: int = 5) -> list[dict]:
        """Newest-first version descriptors (ref AzureClient
        getContainerVersions over historian's version listing).  Version
        ids are git COMMIT shas (unique per version even for identical
        content — the reason git has commit objects)."""
        return self._snapshots.git.version_ids(max_count)

    def snapshot_at(self, version_id: str) -> tuple[int, dict] | None:
        found = self._snapshots.git.at(version_id)
        if found is not None:
            return found
        # Legacy str(seq) ids still resolve for pinned callers (newest
        # matching version wins).
        for seq, commit in reversed(self._snapshots.git.versions):
            if str(seq) == version_id:
                return self._snapshots.git.read_commit(commit)
        return None

    def read_git_object(self, sha: str) -> tuple[str, Any]:
        """Raw object read from the snapshot store (historian's git object
        surface; feeds virtualized partial snapshot fetches)."""
        return self._snapshots.git.store.get(sha)

    # ------------------------------------------------------------------ blobs
    def upload_blob(self, content: str) -> str:
        """Content-addressed attachment blob upload; returns the blob id
        (identical content dedups to the same id)."""
        import hashlib

        blob_id = hashlib.sha256(content.encode()).hexdigest()[:32]
        self._blobs[blob_id] = content
        return blob_id

    def read_blob(self, blob_id: str) -> str:
        if blob_id not in self._blobs:
            raise KeyError(f"no blob {blob_id!r}")
        return self._blobs[blob_id]

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def process_some(self, count: int) -> int:
        """Deliver up to ``count`` queued sequenced ops to all subscribers."""
        delivered = 0
        while self._pending and delivered < count:
            msg = self._pending.popleft()
            if msg.type == MessageType.SUMMARIZE:
                self._scribe_process_summarize(msg)
            for sub in list(self._subscribers.values()):
                sub(msg)
            delivered += 1
        return delivered

    # ------------------------------------------------------------------ scribe
    def upload_summary(self, summary_tree: dict) -> str:
        self._upload_counter += 1
        h = f"upload_{self.doc_id}_{self._upload_counter}"
        self._uploads[h] = summary_tree
        return h

    def _scribe_process_summarize(self, msg: SequencedMessage) -> None:
        """The scribe lambda (scribe/lambda.ts:65): on a sequenced summarize
        op, materialize the uploaded tree (resolving incremental handles
        against the previous snapshot), store it keyed at the summary's
        refSeq, and ack — or nack with the reason."""
        from ..runtime.summary import materialize

        handle = msg.contents.get("handle")
        ref_seq = msg.contents.get("refSeq")
        tree = self._uploads.pop(handle, None)
        if tree is None:
            self._pending.append(
                self.sequencer.mint_service(
                    MessageType.SUMMARY_NACK,
                    {"handle": handle, "error": "unknown upload handle"},
                )
            )
            return
        prev = self._snapshots[-1][1] if self._snapshots else None
        try:
            plain = materialize(tree, prev)
            self.save_snapshot(ref_seq, plain)
        except (ValueError, TypeError) as e:
            # TypeError: the git store canonicalizes to JSON — a summary
            # carrying non-serializable content must NACK, never crash the
            # delivery loop.
            self._pending.append(
                self.sequencer.mint_service(
                    MessageType.SUMMARY_NACK, {"handle": handle, "error": str(e)}
                )
            )
            return
        self._pending.append(
            self.sequencer.mint_service(
                MessageType.SUMMARY_ACK,
                {"handle": handle, "refSeq": ref_seq, "summarySeq": msg.seq},
            )
        )

    def on_pump(self, fn: Callable[[], None]) -> None:
        """Register a pump-boundary hook (see ``_pump_listeners``)."""
        self._pump_listeners.append(fn)

    def process_all(self) -> int:
        """Drain the delivery queue, including messages enqueued by
        subscribers reacting to deliveries (reconnect replay, resubmit)."""
        n = 0
        while self._pending:
            n += self.process_some(len(self._pending))
        if n:
            for fn in list(self._pump_listeners):
                fn()
        return n


class LocalService:
    """A multi-document in-memory service (tinylicious analog)."""

    def __init__(self) -> None:
        self._docs: dict[str, LocalDocument] = {}
        self._token_manager = None

    def document(self, doc_id: str) -> LocalDocument:
        if doc_id not in self._docs:
            self._docs[doc_id] = LocalDocument(doc_id)
            self._docs[doc_id].token_manager = self._token_manager
        return self._docs[doc_id]

    def peek_document(self, doc_id: str) -> LocalDocument | None:
        """Non-creating lookup (read fronts must not instantiate docs)."""
        return self._docs.get(doc_id)

    def enable_auth(self, token_manager) -> None:
        """Require valid tenant tokens on every write connection (riddler)."""
        self._token_manager = token_manager
        for doc in self._docs.values():
            doc.token_manager = token_manager

    def documents(self) -> list[LocalDocument]:
        return list(self._docs.values())

    def process_all(self) -> int:
        n = 0
        for doc in self._docs.values():
            n += doc.process_all()
        return n


# Composition-root binding: importing this module installs LocalService as
# the local-service provider the driver/framework layers resolve through
# (the driver->server inversion; see driver.service_registry).
from ..driver.service_registry import register_local_service  # noqa: E402

register_local_service(LocalService)
