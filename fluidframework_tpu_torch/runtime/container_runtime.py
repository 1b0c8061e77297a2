"""The port's own copy of ``fluidframework_tpu/runtime/container_runtime.py`` (no JAX in it).

ContainerRuntime: per-container orchestration of the full op lifecycle.

Reference parity: container-runtime/src/containerRuntime.ts — inbound
``process`` (:3181) → ungroup/decompress/unchunk → duplicate-batch drop →
pending zip (:3280) → bunching (:3428) → datastore dispatch; outbound submit
→ Outbox → flush-at-turn-end; PendingStateManager replay on reconnect;
getPendingLocalState/rehydrate for offline resume (container.ts:1152 +
pendingStateManager.ts); quorum short-id table from sequenced joins.

Connection identity semantics (the subtle part, mirrored from the
reference's connection state machine): on reconnect the container keeps
matching in-flight ops from its PREVIOUS identity during catch-up (pending
messages record the identity they were flushed under), and only after its
own new join is sequenced — i.e. provably after every old in-flight op —
does it resubmit what's still pending, under the new identity but with the
ORIGINAL batch ids (fork detection).
"""

from __future__ import annotations

from typing import Any

from ..protocol.driver_contracts import DriverError
from ..protocol.messages import MessageType, Nack, SequencedMessage
from ..protocol.channel import MessageEnvelope, bunch_contiguous
from .datastore import DataStoreRuntime
from .op_lifecycle import (
    DuplicateBatchDetector,
    InboundRuntimeMessage,
    Outbox,
    RemoteMessageProcessor,
)
from .pending_state import PendingStateManager


from .errors import ContainerForkError, DataProcessingError  # noqa: F401 (re-export)

# Address reserved for runtime-level ops (datastore/channel attach — the
# reference's attach messages, channelCollection.ts "attach" type): they ride
# the normal outbox/batch machinery but dispatch to the runtime itself.
RUNTIME_ADDRESS = "__runtime__"


class ContainerRuntime:
    """One collaborative container: datastores + op lifecycle + connection."""

    def __init__(
        self,
        registry: dict[str, Any],
        container_id: str = "container",
        track_attribution: bool = False,
    ) -> None:
        self.id = container_id
        self._registry = registry
        self._datastores: dict[str, DataStoreRuntime] = {}
        self._psm = PendingStateManager()
        self._rmp = RemoteMessageProcessor()
        self._detector = DuplicateBatchDetector()
        self._quorum: dict[str, int] = {}
        self._document = None
        self._outbox: Outbox | None = None
        self.client_id: str | None = None
        self.joined = False
        self.ref_seq = 0
        self.min_seq = 0
        self.closed = False
        self.close_error: Exception | None = None
        self._expected_join_seq = -1
        self._detached_counter = 0
        self._stash: dict[str, Any] | None = None
        self._processing_inbound = False
        # Quorum proposals in flight on the current connection; a dropped
        # connection rejects them (the reference rejects the propose promise
        # on disconnect so callers can retry — quorum.ts propose).
        self._inflight_proposals: list[dict] = []
        # (client_id) per sequenced LEAVE — audience-departure consumers
        # (presence attendee tracking) that aren't channels.
        self.member_left_listeners: list = []
        # listener(touched: set[(datastore_id, channel_id)]) after each
        # processed inbound batch — the view-binding invalidation feed.
        self.op_processed_listeners: list = []
        # Runtime attributor (ref framework/attributor mixinAttributor):
        # seq -> {client, timestamp} recorded from the sequenced stream,
        # summarized interned+delta-encoded, restored on load.
        if track_attribution:
            from ..framework.attributor import OpStreamAttributor

            self.attributor = OpStreamAttributor()
        else:
            self.attributor = None
        self.rejected_proposals: list[dict] = []
        # Summarization state (runtime/summary.py): ops since the last acked
        # summary drive the RunningSummarizer heuristics; last_summary_ref_seq
        # is the baseline for incremental handle reuse (refreshLatestSummary).
        self.ops_since_summary_ack = 0
        self.last_summary_ref_seq: int | None = None
        self.on_summary_ack = None
        self.on_summary_nack = None
        # Attachment blobs + GC (runtime/blob_manager.py, runtime/gc.py).
        from .blob_manager import BlobManager
        from .gc import GCState

        self.blobs = BlobManager(
            upload=self._upload_blob_to_storage,
            read=self._read_blob_from_storage,
            submit_attach=lambda blob_id: self._submit_datastore_op(
                RUNTIME_ADDRESS, {"runtimeOp": "attachBlob", "id": blob_id}, None
            ),
        )
        self.gc_state = GCState()
        # Sweep distance in sequence numbers: a node must stay unreferenced
        # this long before a gcDelete op removes it everywhere (the
        # reference ages by wall clock; seq distance is deterministic).
        self.gc_sweep_after_ops = 64

    # ------------------------------------------------------------------- blobs
    def _upload_blob_to_storage(self, content: str) -> str:
        if self._document is None:
            raise RuntimeError("blob upload requires a connected container")
        return self._document.upload_blob(content)

    def _read_blob_from_storage(self, blob_id: str) -> str:
        if self._document is None:
            raise RuntimeError("blob read requires a connected container")
        return self._document.read_blob(blob_id)

    def upload_blob(self, content: str) -> str:
        """Upload an attachment blob; returns its ``blob:<id>`` handle
        (store it in any DDS value to keep the blob referenced)."""
        return self.blobs.create_blob(content)

    def get_blob(self, handle: str) -> str:
        return self.blobs.get_blob(handle)

    # -------------------------------------------------------------- datastores
    def create_datastore(self, ds_id: str, root: bool = True) -> DataStoreRuntime:
        if ds_id in self._datastores:
            raise ValueError(f"datastore {ds_id!r} already exists")
        if ds_id in self.gc_state.tombstoned:
            raise ValueError(f"datastore {ds_id!r} was deleted by GC")

        def submit(
            contents: dict, metadata: Any, internal: bool = False, _ds_id: str = ds_id
        ) -> None:
            self._submit_datastore_op(_ds_id, contents, metadata, internal)

        ds = DataStoreRuntime(
            ds_id,
            self._registry,
            submit,
            lambda cid: self._quorum[cid],
            lambda: self.client_id,
            lambda: list(self._quorum),
            lambda: self.ref_seq,
            root=root,
        )
        self._datastores[ds_id] = ds
        return ds

    def datastore(self, ds_id: str) -> DataStoreRuntime:
        return self._datastores[ds_id]

    def submit_datastore_attach(self, ds_id: str) -> None:
        """Sequence a new datastore's existence + layout so every remote
        replica instantiates it before its ops arrive (ref data store attach
        ops, dataStoreContext.ts). Safe to call for snapshot-baked stores:
        replicas that already have it ignore the op."""
        ds = self._datastores[ds_id]
        self._submit_datastore_op(
            RUNTIME_ADDRESS,
            {"runtimeOp": "attachDataStore", "id": ds_id, "structure": ds.structure_summary()},
            None,
        )

    def submit_channel_attach(self, ds_id: str, channel_id: str) -> None:
        """Sequence a dynamically-created channel on an existing datastore
        (ref channelCollection "attach" message)."""
        ch = self._datastores[ds_id].get_channel(channel_id)
        self._submit_datastore_op(
            RUNTIME_ADDRESS,
            {
                "runtimeOp": "attachChannel",
                "ds": ds_id,
                "id": channel_id,
                "channelType": ch.channel_type,
            },
            None,
        )

    def _apply_runtime_op(self, inner: dict, seq: int) -> None:
        """Apply one attach op (shared by inbound dispatch and stash
        rehydrate). Marks the attached channels dirty at the attach seq so
        summaries don't emit handles into snapshots predating them."""
        op = inner["runtimeOp"]
        if op == "attachDataStore":
            if inner["id"] in self.gc_state.tombstoned:
                # A stale client (pre-sweep snapshot) re-attaching a swept
                # datastore must not poison every replica: drop the op
                # (tombstones win; ref GC tombstone enforcement).
                return
            if inner["id"] not in self._datastores:
                self.create_datastore(
                    inner["id"], root=inner["structure"].get("root", True)
                ).load(inner["structure"])
            ds = self._datastores[inner["id"]]
            for cid in ds.channels:
                ds.changed_seqs[cid] = max(ds.changed_seqs.get(cid, 0), seq)
        elif op == "attachChannel":
            ds = self._datastores[inner["ds"]]
            if inner["id"] not in ds.channels:
                ds.create_channel(inner["channelType"], inner["id"])
            ds.changed_seqs[inner["id"]] = max(
                ds.changed_seqs.get(inner["id"], 0), seq
            )
        elif op == "attachBlob":
            self.blobs.on_attach(inner["id"])
        elif op == "gcDelete":
            # Sequenced sweep (ref GC sweep-ready op): every replica deletes
            # the same nodes at the same point in the total order.
            self._apply_gc_delete(inner["ids"])
        else:
            raise DataProcessingError(f"unknown runtime op {op!r}")

    def _apply_gc_delete(self, node_keys: list[str]) -> None:
        for key in node_keys:
            kind, _, node_id = key.partition("/")
            if kind == "ds":
                self._datastores.pop(node_id, None)
                self.gc_state.tombstoned.add(node_id)
            elif kind == "blob":
                self.blobs.delete(node_id)
            self.gc_state.unreferenced_since.pop(key, None)

    def _handle_runtime_messages(self, env, run) -> None:
        for inner, _local, _md in run:
            self._apply_runtime_op(inner, env.seq)

    @property
    def datastores(self) -> dict[str, DataStoreRuntime]:
        return dict(self._datastores)

    @property
    def has_document(self) -> bool:
        """Whether a document link is live (loader checks before disconnect)."""
        return self._document is not None

    def process_sequenced(self, msg: SequencedMessage) -> None:
        """Public inbound entry for loader-driven read connections."""
        self._on_sequenced(msg)

    # ----------------------------------------------------------------- outbound
    def _submit_datastore_op(
        self, ds_id: str, contents: dict, metadata: Any, internal: bool = False
    ) -> None:
        if self._processing_inbound and not internal:
            # Reentrancy guard (ref ensureNoDataModelChanges,
            # containerRuntime.ts:1500): minting local ops from inside
            # inbound op application breaks ref-seq consistency.
            raise RuntimeError("local edit during inbound op processing")
        if self._outbox is None:
            # Disconnected/detached: stage into a connectionless outbox whose
            # flushes park in the pending list until a connection exists.
            self._outbox = Outbox(client_id="")
        self._outbox.submit({"address": ds_id, "contents": contents}, metadata)

    def flush(self) -> None:
        """End-of-turn flush (ref Outbox.flush at JS microtask end)."""
        if self._outbox is None:
            return
        if self._outbox.client_id == "" or not self.joined:
            # Not connected — or connected but our join hasn't sequenced yet
            # (the reference holds outbound until connected): park staged
            # messages as unsent pending state; they replay on join.
            self._park_outbox(keep_outbox=True)
            return
        batch = self._outbox.flush(self.ref_seq)
        if batch is None:
            return
        self._psm.on_flush_batch(batch.messages, batch.batch_id, self._outbox.client_id)
        for wire in batch.wire_messages:
            if self._document is None:
                break  # a nack mid-batch dropped the connection
            try:
                self._document.submit(wire)
            except DriverError:
                # A failed send invalidates the connection (the reference
                # treats socket submit errors as disconnects).  The batch is
                # already pending under this identity, so reconnect replay
                # re-sends whatever never arrived; sending the REST of the
                # batch now would tear the batch's atomicity.
                self._drop_connection()
                break

    def rollback_staged(self) -> None:
        """Undo every staged-but-unflushed local op, newest first (ref
        Outbox rollback used by transaction abort paths)."""
        if self._outbox is None:
            return
        while True:
            m = self._outbox.peek_staged()
            if m is None:
                break
            # Channel rollback first: if a DDS does not support rollback the
            # op must STAY staged (its effect is still applied locally).
            self._datastores[m.contents["address"]].rollback(
                m.contents["contents"], m.local_metadata
            )
            self._outbox.pop_staged()

    @property
    def pending_op_count(self) -> int:
        return self._psm.pending_count

    # --------------------------------------------------------------- connection
    def connect(self, document, client_id: str, stash: str | None = None) -> None:
        """Join a document. Catch-up is synchronous (the local service replays
        the delivered prefix through our subscriber before ticketing the
        join). A stash (from get_pending_local_state) is applied at the exact
        sequence point it was taken (ref applyStashedOpsAt)."""
        if self._document is not None:
            raise RuntimeError("already connected; disconnect first")
        if stash is not None:
            self._stash = PendingStateManager.parse_local_state(stash)
        self._document = document
        self.client_id = client_id
        self.joined = False
        self._outbox = self._adopt_outbox(client_id)
        self._expected_join_seq = -1  # catch-up must not match any join
        join_msg = document.connect(client_id, self._on_sequenced, self._on_nack)
        if self.closed:
            # Catch-up closed us (e.g. fork detection) but the join was
            # still ticketed: leave cleanly so we don't pin the MSN forever.
            document.disconnect(client_id)
            return
        self._expected_join_seq = join_msg.seq
        self._maybe_apply_stash(catch_up_done=True)

    def _adopt_outbox(self, client_id: str) -> Outbox:
        """A fresh outbox for this connection; anything staged while
        disconnected is parked as pending first (it replays on join)."""
        if self._outbox is not None and not self._outbox.is_empty:
            assert self._outbox.client_id == ""
        self._park_outbox()
        return Outbox(client_id=client_id)

    def disconnect(self) -> None:
        if self._document is None:
            return
        try:
            self.flush()  # anything staged rides out before the leave
        except DriverError:
            # The connection may already be dead (unclean drop — network
            # fault, injected disconnect): staged ops stay in the outbox and
            # park as pending on the next connect instead of crashing the
            # teardown.
            pass
        if self._document is None:
            return  # the flush was nacked; _on_nack already dropped the link
        self._document.disconnect(self.client_id)
        self._document = None
        self._park_outbox()
        self.joined = False
        self._reject_inflight_proposals()

    def _park_outbox(self, keep_outbox: bool = False) -> None:
        """Staged-but-unflushed ops must survive losing the connection: park
        them as pending (client_id "") so the next connect replays them —
        dropping the outbox would orphan the channels' optimistic state
        (their pending bookkeeping has no ack coming).  ``keep_outbox``
        retains the (drained) outbox for continued staging — the
        disconnected-flush path, where the connection identity persists."""
        if self._outbox is not None and not self._outbox.is_empty:
            self._detached_counter += 1
            batch = self._outbox.park(f"unsent_{self.id}_{self._detached_counter}")
            if batch is not None:
                self._psm.on_flush_batch(batch.messages, batch.batch_id, client_id="")
        if not keep_outbox:
            self._outbox = None

    def close(self, error: Exception | None = None) -> None:
        """Terminal: detach from the document and refuse further work (ref
        Container.close on DataProcessingError)."""
        if self._document is not None:
            self._document.disconnect(self.client_id)
            self._document = None
        self._park_outbox()  # keeps the stash (get_pending_local_state) whole
        self.joined = False
        self.closed = True
        self.close_error = error
        self._reject_inflight_proposals()

    def _drop_connection(self) -> None:
        """Sever the document link after a connection-fatal failure: staged
        ops park as pending, in-flight proposals reject, the host reconnects."""
        if self._document is not None:
            self._document.disconnect(self.client_id)
            self._document = None
        self._park_outbox()
        self.joined = False
        self._reject_inflight_proposals()

    def _on_nack(self, nack: Nack) -> None:
        """A nack invalidates the connection: drop it and let the host
        reconnect (ref ConnectionManager reconnect-on-nack)."""
        if self._document is not None:
            self._drop_connection()

    def _reject_inflight_proposals(self) -> None:
        """A dropped connection cannot sequence what it had in flight:
        surface unacked proposals so the host can retry (ref quorum.ts
        rejects the propose promise on disconnect)."""
        inflight, self._inflight_proposals = self._inflight_proposals, []
        for entry in inflight:
            if entry["type"] == MessageType.SUMMARIZE:
                # A dropped summarize surfaces as a nack so the summary
                # manager's heuristics retry on the next connection.
                if self.on_summary_nack is not None:
                    self.on_summary_nack(
                        {
                            "handle": entry["contents"].get("handle"),
                            "error": "connection dropped",
                        }
                    )
            else:
                self.rejected_proposals.append(entry)

    # ----------------------------------------------------------------- inbound
    def _on_sequenced(self, msg: SequencedMessage) -> None:
        if self.closed:
            return
        if msg.seq <= self.ref_seq:
            # Already processed (reconnect catch-up replays the full log;
            # ref DeltaManager drops ops at/below lastProcessedSequenceNumber).
            return
        if self._outbox is not None and not self._outbox.is_empty:
            # Ref-seq consistency (ref containerRuntime.ts:3188): staged
            # local ops must go out stamped with their authoring context
            # before any inbound op advances this container's state.
            self.flush()
        if self._stash is not None and msg.seq > self._stash["refSeq"]:
            self._maybe_apply_stash(catch_up_done=False)
        if self.attributor is not None and msg.type == MessageType.OP:
            # Runtime attribution (ref mixinAttributor/runtimeAttributor):
            # every sequenced op records {client, timestamp}; DDS-level
            # attribution keys (seqs) resolve through this table.
            self.attributor.observe(msg)
        self.ref_seq = msg.seq
        new_min = msg.min_seq > self.min_seq
        self.min_seq = max(self.min_seq, msg.min_seq)

        if msg.type == MessageType.JOIN:
            self._quorum[msg.contents["clientId"]] = msg.contents["short"]
            # Only THIS connection's join (matched by exact seq) flips us to
            # joined — a stale join of the same client id replayed during
            # catch-up must not trigger a premature pending replay.
            if msg.seq == self._expected_join_seq and not self.joined:
                self.joined = True
                self._replay_pending()
        elif msg.type == MessageType.LEAVE:
            self._quorum.pop(msg.contents["clientId"], None)
            for ds in self._datastores.values():
                ds.on_client_leave(msg.contents["clientId"], msg.seq)
            for fn in list(self.member_left_listeners):
                fn(msg.contents["clientId"])
        elif msg.type in (MessageType.PROPOSE, MessageType.SUMMARIZE):
            if (
                msg.client_id == self.client_id
                and self._inflight_proposals
                and self._inflight_proposals[0]["type"] == msg.type
                and self._inflight_proposals[0]["contents"] == msg.contents
            ):
                self._inflight_proposals.pop(0)  # sequenced: no longer at risk
        elif msg.type == MessageType.SUMMARY_ACK:
            # A summary is durable: advance the incremental baseline and
            # reset the heuristics counter (ref refreshLatestSummary).
            self.last_summary_ref_seq = msg.contents["refSeq"]
            self.ops_since_summary_ack = 0
            if self.on_summary_ack is not None:
                self.on_summary_ack(msg.contents)
        elif msg.type == MessageType.SUMMARY_NACK:
            if self.on_summary_nack is not None:
                self.on_summary_nack(msg.contents)
        elif msg.type == MessageType.OP:
            try:
                self._process_op(msg)
            except DataProcessingError as e:
                # Close THIS container only; other replicas keep receiving
                # the broadcast (the reference closes the faulted container,
                # not the service).
                self.close(e)
                return

        if new_min:
            for ds in self._datastores.values():
                ds.on_min_seq(self.min_seq)

    def _process_op(self, msg: SequencedMessage) -> None:
        inbound = self._rmp.process(msg)
        if not inbound:
            return  # partial chunk
        batch_id = inbound[0].batch_id
        # "Our own op" matching is by submitting identity: stashed entries
        # carry the identity they were flushed under, so a batch sequenced
        # under the PREVIOUS identity before the stash was taken acks the
        # stashed ops on rehydrate (ref pendingStateManager.ts matches
        # savedOps by clientId/clientSequenceNumber), while the same batch
        # id arriving under a DIFFERENT identity is a rehydrated twin's
        # replay — a fork.
        local = (
            self._psm.has_pending and self._psm.head_client_id == msg.client_id
        )
        if not local:
            if batch_id is not None and batch_id in self._psm.pending_batch_ids():
                raise ContainerForkError(
                    f"remote batch {batch_id!r} matches a pending local batch: "
                    "container fork detected"
                )
            if self._detector.observe(batch_id, msg.seq, msg.min_seq):
                return  # duplicate resubmission of an already-sequenced batch
        else:
            self._detector.observe(batch_id, msg.seq, msg.min_seq)

        # Summary heuristics count runtime ops, not wire messages: a grouped
        # batch contributes its full op count (ref opsSinceLastSummary) —
        # counted only after duplicate-batch drops, so resubmitted ops that
        # never mutate state don't inflate the summarizer's trigger.
        self.ops_since_summary_ack += len(inbound)

        # Outbound-reference detection (ref addedGCOutboundReference): any
        # sequenced op carrying a handle string resets that node's
        # unreferenced age — without this, a node re-referenced and
        # re-unreferenced BETWEEN two GC runs would keep its stale age and
        # sweep early.
        if self.gc_state.unreferenced_since:
            from .gc import scan_handles

            ds_refs: set[str] = set()
            blob_refs: set[str] = set()
            for m in inbound:
                scan_handles(m.contents, ds_refs, blob_refs)
            for ref in ds_refs:
                self.gc_state.unreferenced_since.pop(f"ds/{ref}", None)
            for ref in blob_refs:
                self.gc_state.unreferenced_since.pop(f"blob/{ref}", None)
        zipped: list[tuple[InboundRuntimeMessage, Any]] = []
        for m in inbound:
            md = self._psm.match_inbound(m.contents) if local else None
            zipped.append((m, md))

        # Bunch contiguous same-datastore messages (containerRuntime.ts:3428).
        self._processing_inbound = True
        touched: set[tuple[str, str]] = set()
        try:
            env = MessageEnvelope(
                client_id=msg.client_id,
                seq=msg.seq,
                min_seq=msg.min_seq,
                ref_seq=msg.ref_seq,
            )

            def dispatch(addr, run):
                if addr == RUNTIME_ADDRESS:
                    self._handle_runtime_messages(env, run)
                    return
                if addr in self.gc_state.tombstoned:
                    # Tombstone drop (ref GC tombstone routing): ops from a
                    # stale client to a swept datastore are discarded.
                    return
                for contents, _local, _md in run:
                    touched.add((addr, contents.get("address", "")))
                self._datastores[addr].process_messages(env, run)

            bunch_contiguous(
                (
                    (m.contents["address"], (m.contents["contents"], local, md))
                    for m, md in zipped
                ),
                dispatch,
            )
        finally:
            self._processing_inbound = False
        if touched:
            # View-binding invalidation (framework/bindings.py): which
            # (datastore, channel) addresses this batch changed.
            for fn in list(self.op_processed_listeners):
                fn(touched)

    # --------------------------------------------------------------- reconnect
    def _replay_pending(self) -> None:
        """Resubmit everything still pending, under the current identity but
        with original batch ids (ref replayPendingStates).  A send failure
        mid-replay drops the connection; groups not yet re-staged go back
        into the pending set untouched so the NEXT reconnect replays them
        (take_pending_for_replay removed them up front)."""
        groups = self._psm.take_pending_for_replay()
        for gi, group in enumerate(groups):
            if self._document is None:
                # Connection died mid-replay: restore the untouched tail
                # verbatim for the next reconnect's replay.
                self._psm.restore([p for later in groups[gi:] for p in later])
                return
            for p in group:
                if p.contents["address"] == RUNTIME_ADDRESS:
                    # Attach ops resubmit verbatim (position-free).
                    self._submit_datastore_op(
                        RUNTIME_ADDRESS, p.contents["contents"], p.local_metadata
                    )
                    continue
                self._datastores[p.contents["address"]].resubmit(
                    p.contents["contents"], p.local_metadata
                )
            batch = self._outbox.flush(self.ref_seq, batch_id=group[0].batch_id)
            if batch is None:
                continue  # squashed/cancelled out entirely
            self._psm.on_flush_batch(batch.messages, batch.batch_id, self.client_id)
            for wire in batch.wire_messages:
                if self._document is None:
                    break
                try:
                    self._document.submit(wire)
                except DriverError:
                    # Same policy as flush(): a failed send invalidates the
                    # connection; this group is already pending under the
                    # current identity, so the next replay re-sends it.
                    self._drop_connection()
                    break

    # ---------------------------------------------------------------- protocol
    def submit_protocol_message(self, mtype: str, contents: Any) -> None:
        """Send a protocol-level message (e.g. quorum propose) through the
        current connection, sharing the op clientSeq counter (the reference
        routes proposals through the same DeltaManager outbound path)."""
        if (
            self._outbox is None
            or self._outbox.client_id == ""
            or self._document is None
            or not self.joined
        ):
            raise RuntimeError("protocol message requires a joined write connection")
        self.flush()
        if self._document is None:
            raise RuntimeError("connection dropped during flush")
        self._inflight_proposals.append({"type": mtype, "contents": contents})
        self._document.submit(self._outbox.mint_direct(mtype, contents, self.ref_seq))

    # --------------------------------------------------------------------- gc
    def run_gc(self) -> dict[str, Any]:
        """One GC round (ref container-runtime/src/gc/): mark reachability
        from root datastores through handle strings, age unreferenced
        nodes, and submit a sequenced gcDelete op for sweep-ready ones.
        Returns {"unreferenced": {...}, "swept": [...]}."""
        from .gc import mark

        result = mark(self)
        self.gc_state.unreferenced_since = result.unreferenced
        sweep_ready = [
            key
            for key, since in result.unreferenced.items()
            if self.ref_seq - since >= self.gc_sweep_after_ops
        ]
        if sweep_ready and self._document is not None:
            self._submit_datastore_op(
                RUNTIME_ADDRESS,
                {"runtimeOp": "gcDelete", "ids": sorted(sweep_ready)},
                None,
            )
            self.flush()
        return {"unreferenced": dict(result.unreferenced), "swept": sweep_ready}

    # -------------------------------------------------------------- checkpoint
    def summarize(self) -> dict[str, Any]:
        """Runtime state checkpoint: quorum short-id table + every datastore
        (ref ContainerRuntime.summarize; incremental tree walk lives in
        runtime/summary.py)."""
        out = {
            "seq": self.ref_seq,
            "minSeq": self.min_seq,
            "quorum": dict(self._quorum),
            "datastores": {k: ds.summarize() for k, ds in self._datastores.items()},
            "blobs": self.blobs.summarize(),
            "gc": self.gc_state.to_json(),
        }
        if self.attributor is not None:
            out["attribution"] = self.attributor.summarize()
        return out

    def load_snapshot(self, summary: dict[str, Any]) -> None:
        """Boot from a checkpoint (ref Container.load snapshot path). Must be
        called before any datastore creation or op processing."""
        if self._datastores or self.ref_seq != 0:
            raise RuntimeError("load_snapshot on a non-fresh runtime")
        from .gc import GCState

        self.last_summary_ref_seq = summary["seq"]
        self.ref_seq = summary["seq"]
        self.min_seq = summary.get("minSeq", 0)
        self._quorum = dict(summary["quorum"])
        self.blobs.load(summary.get("blobs", {}))
        self.gc_state = GCState.from_json(summary.get("gc", {}))
        if "attribution" in summary:
            # A snapshot carrying attribution implies the document tracks
            # it: enable and restore regardless of this client's option.
            from ..framework.attributor import OpStreamAttributor

            self.attributor = OpStreamAttributor()
            self.attributor.load(summary["attribution"])
        for ds_id, ds_summary in summary["datastores"].items():
            self.create_datastore(ds_id).load(ds_summary)

    @property
    def quorum_table(self) -> dict[str, int]:
        """client id -> short (join-order) id for current write clients."""
        return dict(self._quorum)

    def build_summary_tree(self) -> dict[str, Any]:
        """The incremental runtime summary subtree (ref SummarizerNode walk,
        summarizerNode.ts:61): channels untouched since the last acked
        summary emit handles into it instead of content."""
        from .summary import blob, tree

        covered = self.last_summary_ref_seq
        entries = {
            "seq": blob(self.ref_seq),
            "minSeq": blob(self.min_seq),
            "quorum": blob(dict(self._quorum)),
            "blobs": blob(self.blobs.summarize()),
            "gc": blob(self.gc_state.to_json()),
            "datastores": tree(
                {
                    ds_id: ds.summary_tree(
                        covered, f"runtime/datastores/{ds_id}"
                    )
                    for ds_id, ds in self._datastores.items()
                }
            ),
        }
        if self.attributor is not None:
            entries["attribution"] = blob(self.attributor.summarize())
        return tree(entries)

    # ------------------------------------------------------------------- stash
    def get_pending_local_state(self) -> str:
        """Serialize pending-op state for offline resume (container.ts:1152)."""
        self.flush()
        return self._psm.get_local_state(self.ref_seq)

    def _maybe_apply_stash(self, catch_up_done: bool) -> None:
        if self._stash is None:
            return
        if not catch_up_done and self.ref_seq < self._stash["refSeq"]:
            return
        if catch_up_done and self.ref_seq < self._stash["refSeq"]:
            raise RuntimeError(
                f"stash taken at seq {self._stash['refSeq']} but the op log "
                f"only reaches {self.ref_seq}; stale service?"
            )
        stash, self._stash = self._stash, None
        for entry in stash["pending"]:
            contents = entry["contents"]
            if contents["address"] == RUNTIME_ADDRESS:
                # Stashed attach op: re-create the structure locally, then
                # let the pending replay resubmit it verbatim.
                self._apply_runtime_op(contents["contents"], self.ref_seq)
                self._psm.add_stashed(
                    contents, None, entry["batchId"], entry.get("clientId", "")
                )
                continue
            md = self._datastores[contents["address"]].apply_stashed(
                contents["contents"]
            )
            self._psm.add_stashed(
                contents, md, entry["batchId"], entry.get("clientId", "")
            )
