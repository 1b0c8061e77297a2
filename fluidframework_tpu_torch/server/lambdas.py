"""The ordering-service lambda pipeline over the ordered log.

A port of ``fluidframework_tpu/server/lambdas.py`` (no JAX in it).

Reference parity (SURVEY §2.5, §3.4): stateless fronts write raw client ops
to the ``rawdeltas`` topic; per-partition micro-services consume:

- ``DeliLambda``  (deli/lambda.ts:245): THE sequencer — tickets raw ops
  (seq, MSN, nacks) per document and produces to ``deltas``; its state
  (per-doc sequencer + input offset) checkpoints and restarts losslessly
  (checkpointManager.ts).
- ``ScriptoriumLambda`` (scriptorium/lambda.ts:40): batched persistence of
  sequenced ops into the op store (Mongo analog) — the delta-storage read
  path serves from here.
- ``BroadcasterLambda`` (broadcaster/lambda.ts:51): fan-out of sequenced
  ops to per-document subscribers (Redis pub/sub analog).
- ``ScribeLambda`` (scribe/lambda.ts:65): watches for summarize ops,
  materializes + stores snapshots, and emits summary acks back through the
  ingestion path as service messages.

``PipelineService.pump()`` drives every lambda to quiescence — the
single-process form of the reference's independently-scaled consumers, with
the same at-least-once + checkpoint semantics.
"""

from __future__ import annotations

from typing import Any, Callable

import json
import os

from ..protocol.messages import MessageType, Nack, SequencedMessage, UnsequencedMessage
from .ordered_log import DurableTopic, Topic, atomic_json_dump
from .sequencer import Sequencer


def _make_sequencer(use_native: bool):
    if use_native:
        from ..native import NativeSequencer, native_available

        if native_available():
            return NativeSequencer()
    return Sequencer()


class DeliLambda:
    """Sequencer lambda for ONE rawdeltas partition (may host many docs)."""

    def __init__(self, rawdeltas: Topic, deltas: Topic, partition: int, use_native: bool = False):
        self._in = rawdeltas.partition(partition)
        self._deltas = deltas
        self._partition = partition
        self._use_native = use_native
        self.offset = 0
        self.sequencers: dict[str, Any] = {}
        self.nacks: list[tuple[str, Nack]] = []
        # Idempotent re-produce guard for durable deployments: deli p is the
        # SOLE producer into deltas partition p, so on recovery-by-replay
        # the first ``dedup_until - produced`` produces are already in the
        # log (deterministic sequencing re-creates them identically) and
        # are skipped instead of appended twice.
        self.produced = 0
        self.dedup_until = 0
        # Replay-response drop set, STATIC per recovery: (doc, handle,
        # type) of every summary response already TICKETED into the
        # durable deltas log before this restart (populated by the durable
        # service at restore; always empty for in-memory deployments). A
        # crash-replayed scribe re-emits responses for SUMMARIZE ops it
        # could not know it had handled; those exact duplicates are
        # dropped — clients already receive the originals via catch-up.
        # Live traffic is never suppressed: this set never grows at
        # runtime, so a genuine retry always gets its fresh response.
        # ``replay_boundary`` separates replayed originals (below: must
        # re-ticket to rebuild sequencer state) from re-emitted duplicates
        # (at/above: dropped).
        self.replay_responses: set[tuple[str, str, int]] = set()
        self.replay_boundary = 0

    def _sequencer(self, doc_id: str):
        if doc_id not in self.sequencers:
            self.sequencers[doc_id] = _make_sequencer(self._use_native)
        return self.sequencers[doc_id]

    def pump(self) -> int:
        n = 0
        for rec in self._in.read(self.offset):
            seqr = self._sequencer(rec.doc_id)
            kind, payload = rec.payload
            if kind == "join":
                out = seqr.join(payload)
            elif kind == "leave":
                out = seqr.leave(payload)
            elif kind == "service":
                mtype, contents = payload
                handle = contents.get("handle") if isinstance(contents, dict) else None
                if (
                    handle is not None
                    and rec.offset >= self.replay_boundary
                    and (rec.doc_id, handle, mtype) in self.replay_responses
                ):
                    self.replay_responses.discard((rec.doc_id, handle, mtype))
                    self.offset = rec.offset + 1
                    n += 1
                    continue
                out = seqr.mint_service(mtype, contents)
            else:  # op
                out = seqr.ticket(payload)
                if isinstance(out, Nack):
                    self.nacks.append((rec.doc_id, out))
                    out = None
            if out is not None:
                if self.produced >= self.dedup_until:
                    self._deltas.produce(rec.doc_id, out)
                self.produced += 1
            self.offset = rec.offset + 1
            n += 1
        return n

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> dict:
        """Full restartable state keyed at the input offset (deli
        checkpointManager: state rides with the Kafka offset)."""
        docs = {}
        for doc_id, s in self.sequencers.items():
            if hasattr(s, "checkpoint_bytes"):
                docs[doc_id] = {"native": s.checkpoint_bytes().hex()}
            else:
                docs[doc_id] = {"py": s.checkpoint()}
        return {
            "offset": self.offset,
            "docs": docs,
            "useNative": self._use_native,
            "produced": self.produced,
        }

    @staticmethod
    def restore(state: dict, rawdeltas: Topic, deltas: Topic, partition: int) -> "DeliLambda":
        lam = DeliLambda(
            rawdeltas, deltas, partition, use_native=state.get("useNative", False)
        )
        lam.offset = state["offset"]
        lam.produced = state.get("produced", 0)
        for doc_id, entry in state["docs"].items():
            if "native" in entry:
                from ..native import NativeSequencer

                lam.sequencers[doc_id] = NativeSequencer.restore_bytes(
                    bytes.fromhex(entry["native"])
                )
            else:
                lam.sequencers[doc_id] = Sequencer.restore(entry["py"])
        return lam


class ScriptoriumLambda:
    """Persists sequenced ops per document with batched inserts."""

    def __init__(self, deltas: Topic, partition: int, batch_size: int = 32):
        self._in = deltas.partition(partition)
        self.offset = 0
        self.batch_size = batch_size
        self.store: dict[str, list[SequencedMessage]] = {}
        self._staged: list = []
        self.insert_batches = 0

    def pump(self) -> int:
        n = 0
        for rec in self._in.read(self.offset):
            self._staged.append((rec.doc_id, rec.payload))
            if len(self._staged) >= self.batch_size:
                self._flush()
            self.offset = rec.offset + 1
            n += 1
        self._flush()
        return n

    def _flush(self) -> None:
        if not self._staged:
            return
        for doc_id, msg in self._staged:
            self.store.setdefault(doc_id, []).append(msg)
        self._staged.clear()
        self.insert_batches += 1

    def ops(self, doc_id: str, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        return [m for m in self.store.get(doc_id, []) if from_seq <= m.seq <= to_seq]


class BroadcasterLambda:
    """Fans sequenced ops out to per-document subscribers.

    Three delivery shapes: per-message ``subscribe`` (the classic client
    seam), ``subscribe_batch``, which hands each pump's decoded messages
    for a document as ONE list — the columnar-ingest seam (engines feed
    the whole batch to ``ingest_batch`` instead of paying per-message
    Python through the fan-out) — and ``subscribe_frames``, which hands
    each pump's batch as ONE encoded ``fanout.DeltaFrame``: every frame
    subscriber (and every firehose consumer downstream) shares the SAME
    bytes, so the wire encode happens once per (doc, pump) however many
    subscribers fan it out."""

    def __init__(self, deltas: Topic, partition: int):
        self._in = deltas.partition(partition)
        self.offset = 0
        self._subs: dict[str, list[Callable[[SequencedMessage], None]]] = {}
        self._batch_subs: dict[
            str, list[Callable[[list[SequencedMessage]], None]]
        ] = {}
        self._frame_subs: dict[str, list[Callable]] = {}
        self.frames_built = 0

    def subscribe(self, doc_id: str, fn: Callable[[SequencedMessage], None]) -> None:
        self._subs.setdefault(doc_id, []).append(fn)

    def subscribe_batch(
        self, doc_id: str, fn: Callable[[list[SequencedMessage]], None]
    ) -> None:
        self._batch_subs.setdefault(doc_id, []).append(fn)

    def subscribe_frames(self, doc_id: str, fn: Callable) -> None:
        """fn(frame: fanout.DeltaFrame): one call per (doc, pump), the
        frame object shared by every subscriber — encode-once fan-out."""
        self._frame_subs.setdefault(doc_id, []).append(fn)

    def pump(self) -> int:
        n = 0
        batches: dict[str, list[SequencedMessage]] = {}
        for rec in self._in.read(self.offset):
            for fn in self._subs.get(rec.doc_id, []):
                fn(rec.payload)
            if rec.doc_id in self._batch_subs or rec.doc_id in self._frame_subs:
                batches.setdefault(rec.doc_id, []).append(rec.payload)
            self.offset = rec.offset + 1
            n += 1
        for doc_id, msgs in batches.items():
            for fn in self._batch_subs.get(doc_id, []):
                # Failure contract: a raising batch subscriber (e.g.
                # ingest_batch's loud NotImplementedError on an unsupported
                # wire form) forfeits this pump's remaining messages for
                # the doc, exactly as if the consumer process had crashed
                # mid-batch — redelivery is owned by durable recovery
                # (checkpoint floor + replay), never by an offset rewind:
                # the subscriber may have landed a PREFIX of the batch
                # before raising, and engines deliberately carry no seq
                # dedupe above the checkpoint floor, so rewinding here
                # would double-apply that prefix on the retry.
                fn(msgs)
            frame_fns = self._frame_subs.get(doc_id)
            if frame_fns:
                from ..fanout.frames import build_frame

                frame = build_frame(doc_id, msgs)
                self.frames_built += 1
                for fn in frame_fns:
                    # Same failure contract as batch subscribers; the frame
                    # OBJECT is shared, so N subscribers cost one encode.
                    fn(frame)
        return n


class ScribeLambda:
    """Summary handling: materialize + store snapshots, ack via ingestion."""

    def __init__(
        self,
        deltas: Topic,
        rawdeltas: Topic,
        partition: int,
        uploads: dict,
        snapshots: dict | None = None,
    ):
        self._in = deltas.partition(partition)
        self._raw = rawdeltas
        self.offset = 0
        self._uploads = uploads  # handle -> summary tree (storage staging)
        # Snapshot store; pass a shared dict to make it external durable
        # storage (the git/historian analog) that outlives this instance.
        self.snapshots: dict[str, list[tuple[int, dict]]] = (
            {} if snapshots is None else snapshots
        )
        # SUMMARIZE records fully processed by a previous incarnation
        # (snapshot stored, response emitted) that this replay must skip —
        # their upload handles are legitimately consumed and their
        # responses already ride the logs (partition handoff arming).
        self.replay_skip: set[tuple[str, str]] = set()

    def pump(self) -> int:
        from ..runtime.summary import materialize

        n = 0
        for rec in self._in.read(self.offset):
            msg: SequencedMessage = rec.payload
            if msg.type == MessageType.SUMMARIZE:
                handle = msg.contents.get("handle")
                if (rec.doc_id, handle) in self.replay_skip:
                    self.replay_skip.discard((rec.doc_id, handle))
                    self.offset = rec.offset + 1
                    n += 1
                    continue
                ref_seq = msg.contents.get("refSeq")
                tree = self._uploads.pop(handle, None)
                snaps = self.snapshots.setdefault(rec.doc_id, [])
                if tree is None:
                    self._raw.produce(
                        rec.doc_id,
                        ("service", (MessageType.SUMMARY_NACK,
                                     {"handle": handle, "error": "unknown upload handle"})),
                    )
                else:
                    prev = snaps[-1][1] if snaps else None
                    try:
                        plain = materialize(tree, prev)
                        snaps.append((ref_seq, plain))
                        self._raw.produce(
                            rec.doc_id,
                            ("service", (MessageType.SUMMARY_ACK,
                                         {"handle": handle, "refSeq": ref_seq,
                                          "summarySeq": msg.seq})),
                        )
                    except ValueError as e:
                        self._raw.produce(
                            rec.doc_id,
                            ("service", (MessageType.SUMMARY_NACK,
                                         {"handle": handle, "error": str(e)})),
                        )
            self.offset = rec.offset + 1
            n += 1
        return n


class CopierLambda:
    """Raw-op archival: copies every RAW ingestion record (pre-sequencing)
    into a per-document archive (ref copier/lambda.ts — raw deltas land in
    Mongo for audit/debugging before deli tickets them)."""

    def __init__(self, rawdeltas: Topic, partition: int):
        self._in = rawdeltas.partition(partition)
        self.offset = 0
        self.archive: dict[str, list] = {}

    def pump(self) -> int:
        n = 0
        for rec in self._in.read(self.offset):
            self.archive.setdefault(rec.doc_id, []).append(rec.payload)
            self.offset = rec.offset + 1
            n += 1
        return n


class MoiraLambda:
    """External sync: streams sequenced ops to a pluggable external sink
    with at-least-once delivery and a committed offset (ref moira/lambda.ts
    — Fluid-to-external-system bridging off the deltas topic). A failing
    sink leaves the offset in place; the next pump retries."""

    def __init__(self, deltas: Topic, partition: int, sink=None):
        self._in = deltas.partition(partition)
        self.offset = 0
        # sink(doc_id, SequencedMessage) -> None; raising aborts the pump
        # at the current offset (retry next pump).
        self.sink = sink if sink is not None else (lambda doc, msg: None)
        self.delivered = 0

    def pump(self) -> int:
        n = 0
        for rec in self._in.read(self.offset):
            try:
                self.sink(rec.doc_id, rec.payload)
            except Exception:
                break  # offset uncommitted: redelivered next pump
            self.delivered += 1
            self.offset = rec.offset + 1
            n += 1
        return n


class PipelineService:
    """The assembled ordering service: rawdeltas -> deli -> deltas -> fans.

    The document-sharded scale-out axis is the partition count: each
    partition owns a disjoint document set and its own lambda instances —
    exactly the reference's per-partition deployment (SURVEY §2.6.2).
    """

    def __init__(
        self,
        n_partitions: int = 4,
        use_native_sequencer: bool = False,
        rawdeltas: Topic | None = None,
        deltas: Topic | None = None,
        uploads: dict | None = None,
    ):
        self.rawdeltas = rawdeltas if rawdeltas is not None else Topic("rawdeltas", n_partitions)
        self.deltas = deltas if deltas is not None else Topic("deltas", n_partitions)
        self.uploads: dict[str, Any] = uploads if uploads is not None else {}
        self._upload_counter = 0
        self.deli = [
            DeliLambda(self.rawdeltas, self.deltas, p, use_native_sequencer)
            for p in range(n_partitions)
        ]
        self.scriptorium = [
            ScriptoriumLambda(self.deltas, p) for p in range(n_partitions)
        ]
        self.broadcaster = [
            BroadcasterLambda(self.deltas, p) for p in range(n_partitions)
        ]
        self.scribe = [
            ScribeLambda(self.deltas, self.rawdeltas, p, self.uploads)
            for p in range(n_partitions)
        ]
        self.copier = [CopierLambda(self.rawdeltas, p) for p in range(n_partitions)]
        self.moira = [MoiraLambda(self.deltas, p) for p in range(n_partitions)]

    # -------------------------------------------------------------- front-end
    def submit_op(self, doc_id: str, msg: UnsequencedMessage) -> None:
        self.rawdeltas.produce(doc_id, ("op", msg))

    def join(self, doc_id: str, client_id: str) -> None:
        self.rawdeltas.produce(doc_id, ("join", client_id))

    def leave(self, doc_id: str, client_id: str) -> None:
        self.rawdeltas.produce(doc_id, ("leave", client_id))

    def upload_summary(self, tree: dict) -> str:
        self._upload_counter += 1
        h = f"upload_{self._upload_counter}"
        self.uploads[h] = tree
        return h

    def subscribe(self, doc_id: str, fn: Callable[[SequencedMessage], None]) -> None:
        p = self.deltas.partition_for(doc_id)
        self.broadcaster[p].subscribe(doc_id, fn)

    # ------------------------------------------------------------------ drive
    def pump(self, max_rounds: int = 64) -> int:
        """Run every lambda until the whole pipeline is quiescent (scribe
        acks feed back into rawdeltas, so multiple rounds may be needed)."""
        total = 0
        for _ in range(max_rounds):
            moved = 0
            for lam in (
                *self.deli, *self.scriptorium, *self.broadcaster,
                *self.scribe, *self.copier, *self.moira,
            ):
                moved += lam.pump()
            total += moved
            if moved == 0:
                return total
        raise RuntimeError("pipeline failed to quiesce")

    # ------------------------------------------------------------ introspect
    def ops_of(self, doc_id: str) -> list[SequencedMessage]:
        p = self.deltas.partition_for(doc_id)
        return self.scriptorium[p].store.get(doc_id, [])

    def snapshots_of(self, doc_id: str) -> list[tuple[int, dict]]:
        p = self.deltas.partition_for(doc_id)
        return self.scribe[p].snapshots.get(doc_id, [])

    def raw_of(self, doc_id: str) -> list:
        p = self.rawdeltas.partition_for(doc_id)
        return self.copier[p].archive.get(doc_id, [])

    def set_external_sink(self, sink) -> None:
        """Route every partition's sequenced stream to one external sink
        (moira configuration)."""
        for lam in self.moira:
            lam.sink = sink


# ---------------------------------------------------------------------------
# Durable deployment: topics on disk + deli checkpoints, crash-recoverable
# ---------------------------------------------------------------------------

def _encode_raw(payload) -> dict:
    kind, body = payload
    if kind == "op":
        return {"k": "op", "m": body.to_json()}
    if kind in ("join", "leave"):
        return {"k": kind, "c": body}
    mtype, contents = body
    return {"k": "service", "t": mtype, "c": contents}


def _decode_raw(d: dict):
    if d["k"] == "op":
        return ("op", UnsequencedMessage.from_json(d["m"]))
    if d["k"] in ("join", "leave"):
        return (d["k"], d["c"])
    return ("service", (d["t"], d["c"]))


def _encode_delta(msg: SequencedMessage) -> str:
    return msg.to_json()


def _decode_delta(raw: str) -> SequencedMessage:
    return SequencedMessage.from_json(raw)


class DurableUploads(dict):
    """Staged summary uploads, persisted on upload (the reference's
    historian staging is durable): a crash between upload and checkpoint
    replays the SUMMARIZE against the same tree. Pops (consumption) stay
    in-memory — a no-checkpoint replay must re-consume the same handles —
    and the file is compacted to the live set at every checkpoint, so
    consumed handles cannot accrete across restarts."""

    def __init__(self, path: str) -> None:
        super().__init__()
        self._path = path
        self.counter = 0
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            super().update(data["uploads"])
            self.counter = data["counter"]
        # The replay set: everything known at open, including handles a
        # pre-crash scribe consumed after the last compaction.
        self._persisted = dict(self)

    def _flush(self) -> None:
        atomic_json_dump(
            {"uploads": self._persisted, "counter": self.counter}, self._path
        )

    def compact(self) -> None:
        """At checkpoint: scribe resumes past every consumption, so only
        live (unconsumed) uploads need to survive."""
        self._persisted = dict(self)
        self._flush()

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._persisted[key] = value
        self._flush()


def apply_replay_dedup(
    deli, scribe_offset: int, rawdeltas, deltas, uploads, p: int,
    arm_responses: bool = True,
) -> set[tuple[str, str]]:
    """Arm one partition's at-least-once dedup for a resume-by-replay.

    Whatever already reached the deltas log (possibly beyond the
    checkpoint) must not re-append; summary responses already ticketed must
    not re-sequence when the replaying scribe re-emits them; and upload
    handles consumed by SUMMARIZE ops the scribe is already past must not
    resurrect.  Shared by the durable-restart path and partition-ownership
    handoff (lambdas-driver partitionManager.ts analog).

    Returns the (doc, handle) pairs whose SUMMARIZE was already FULLY
    processed by the previous incarnation — its response is present in the
    deltas log or still pending in rawdeltas — for ``ScribeLambda.
    replay_skip``: re-processing one would find its consumed upload handle
    missing and sequence a spurious nack after the real response."""
    deli.dedup_until = deltas.partition(p).head
    deli.replay_boundary = rawdeltas.partition(p).head
    # Handles whose SUMMARIZE the resumed scribe WILL re-process (at/after
    # its checkpoint offset) — only their responses can be re-emitted, so
    # only those may be dropped as duplicates; a stale entry would swallow
    # a live post-resume retry.
    re_emittable: set[tuple[str, str]] = set()
    for rec in deltas.partition(p).read(0):
        msg: SequencedMessage = rec.payload
        contents = msg.contents if isinstance(msg.contents, dict) else {}
        handle = contents.get("handle")
        if handle is None or msg.type != MessageType.SUMMARIZE:
            continue
        if rec.offset >= scribe_offset:
            re_emittable.add((rec.doc_id, handle))
        else:
            uploads.pop(handle, None)
    processed: set[tuple[str, str]] = set()
    for rec in deltas.partition(p).read(0):
        msg = rec.payload
        contents = msg.contents if isinstance(msg.contents, dict) else {}
        handle = contents.get("handle")
        if (
            handle is not None
            and msg.type in (MessageType.SUMMARY_ACK, MessageType.SUMMARY_NACK)
            and (rec.doc_id, handle) in re_emittable
        ):
            if arm_responses:
                # Durable-restart path: the restored scribe re-emits these
                # responses and deli must drop the duplicates.  A resume
                # that instead arms ScribeLambda.replay_skip skips the
                # re-emission entirely and passes arm_responses=False — a
                # lingering drop entry could swallow a future live
                # response for a reused handle.
                deli.replay_responses.add((rec.doc_id, handle, msg.type))
            processed.add((rec.doc_id, handle))
    # Responses emitted but not yet ticketed ride rawdeltas (it survives
    # the crash): their SUMMARIZE was fully processed too.
    for rec in rawdeltas.partition(p).read(0):
        kind, payload = rec.payload
        if kind != "service":
            continue
        mtype, contents = payload
        handle = contents.get("handle") if isinstance(contents, dict) else None
        if handle is not None and mtype in (
            MessageType.SUMMARY_ACK, MessageType.SUMMARY_NACK
        ):
            if (rec.doc_id, handle) in re_emittable:
                processed.add((rec.doc_id, handle))
    return processed


class DurablePipelineService(PipelineService):
    """PipelineService over file-backed topics with checkpointed deli state
    (the reference's production shape: Kafka retains the log, deli rides a
    checkpoint {state, input offset} so a crashed sequencer restarts
    losslessly — deli/checkpointManager.ts; scriptorium/broadcaster are
    rebuilt by replaying the durable deltas topic, which is deterministic;
    scribe resumes from its checkpoint so consumed uploads never re-ack
    divergently)."""

    def __init__(
        self,
        directory: str,
        n_partitions: int = 4,
        use_native_sequencer: bool = False,
        external_sink=None,
    ):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        rawdeltas = DurableTopic(
            "rawdeltas", n_partitions, directory, _encode_raw, _decode_raw
        )
        deltas = DurableTopic(
            "deltas", n_partitions, directory, _encode_delta, _decode_delta
        )
        rawdeltas.open_all()
        deltas.open_all()
        super().__init__(
            n_partitions,
            use_native_sequencer,
            rawdeltas=rawdeltas,
            deltas=deltas,
            uploads=DurableUploads(os.path.join(directory, "uploads.json")),
        )
        # The external sink must be live BEFORE the restore pump, or the
        # replayed stream drains through the default no-op sink; moira
        # offsets checkpoint, so a restored service resumes delivery where
        # the last checkpoint left off (at-least-once from there).
        if external_sink is not None:
            self.set_external_sink(external_sink)
        self._restore()

    def upload_summary(self, tree: dict) -> str:
        h = super().upload_summary(tree)
        self.uploads.counter = self._upload_counter
        self.uploads._flush()
        return h

    # ------------------------------------------------------------ checkpoint
    def _ckpt_path(self) -> str:
        return os.path.join(self._dir, "deli-checkpoint.json")

    def checkpoint(self) -> None:
        """Persist the stateful lambdas: deli (sequencer state + input
        offset) and scribe (snapshots + offset). Scriptorium and
        broadcaster rebuild from the deltas topic side-effect-free."""
        state = {
            "deli": {str(p): lam.checkpoint() for p, lam in enumerate(self.deli)},
            "scribe": {
                str(p): {"offset": lam.offset, "snapshots": lam.snapshots}
                for p, lam in enumerate(self.scribe)
            },
            "moira": {str(p): lam.offset for p, lam in enumerate(self.moira)},
        }
        atomic_json_dump(state, self._ckpt_path())
        self.uploads.compact()

    def _restore(self) -> None:
        self._upload_counter = self.uploads.counter
        path = self._ckpt_path()
        if os.path.exists(path):
            with open(path) as f:
                state = json.load(f)
            self.deli = [
                DeliLambda.restore(
                    state["deli"][str(p)], self.rawdeltas, self.deltas, p
                )
                for p in range(len(self.deli))
            ]
            for p, lam in enumerate(self.scribe):
                entry = state["scribe"][str(p)]
                lam.offset = entry["offset"]
                lam.snapshots = {
                    doc: [(s, snap) for s, snap in snaps]
                    for doc, snaps in entry["snapshots"].items()
                }
            for p, lam in enumerate(self.moira):
                lam.offset = state.get("moira", {}).get(str(p), 0)
        # Whatever already reached the durable deltas log (possibly beyond
        # the checkpoint — flushes keep running between checkpoints) must
        # not replay with side effects twice (see apply_replay_dedup; a
        # crash between the checkpoint write and the uploads compaction
        # leaves consumed handles behind).
        for p in range(len(self.deli)):
            apply_replay_dedup(
                self.deli[p], self.scribe[p].offset,
                self.rawdeltas, self.deltas, self.uploads, p,
            )
        # Scriptorium/broadcaster replay the durable deltas topic from zero
        # — deterministic rebuild of the op store; broadcaster has no
        # subscribers yet (stateless fronts re-register on reconnect).
        self.pump()

    def close(self) -> None:
        self.rawdeltas.close()
        self.deltas.close()
