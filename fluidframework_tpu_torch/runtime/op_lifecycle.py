"""The port's own copy of ``fluidframework_tpu/runtime/op_lifecycle.py`` (no JAX in it).

Outbound batching / grouping / compression / chunking and inbound inverse.

Reference parity: container-runtime/src/opLifecycle — ``Outbox.flush``
(outbox.ts:196,339), ``OpGroupingManager.groupBatch/ungroupOp``
(opGroupingManager.ts:66,125,181), ``OpCompressor.compressBatch``
(opCompressor.ts:27,40 — lz4 there; zlib here, the algorithm is a config
knob, the wire shape is what matters), ``OpSplitter`` chunking of oversized
payloads (opSplitter.ts:45), inbound reassembly
``RemoteMessageProcessor.process`` (remoteMessageProcessor.ts:94,130), and
fork detection via batch ids (duplicateBatchDetector.ts).

A *batch* is the atomicity unit: all ops minted in one JS-turn/host-step
flush together, are sequenced contiguously (the sequencer does not interleave
within a grouped message), and are applied by replicas as one unit.

Wire shapes (all JSON-compatible, carried in ``UnsequencedMessage.contents``):

    grouped batch: {"type": "groupedBatch", "contents": [op, op, ...]}
    compressed:    {"type": "compressed", "data": <base64 zlib(json(list))>}
    chunk:         {"type": "chunk", "chunkId": i, "total": n, "data": str}

Compression wraps the whole grouped batch; chunking wraps the (possibly
compressed) serialized payload when it exceeds the service's max message
size (reference: 716,800 B client cap vs 1 MB socket limit).
"""

from __future__ import annotations

import base64
import json
import zlib
from dataclasses import dataclass, field
from typing import Any

from ..protocol.messages import MessageType, SequencedMessage, UnsequencedMessage

GROUPED_BATCH_TYPE = "groupedBatch"
COMPRESSED_TYPE = "compressed"
CHUNK_TYPE = "chunk"


@dataclass
class BatchMessage:
    """One runtime message staged for the next flush."""

    contents: dict[str, Any]
    local_metadata: Any = None


@dataclass
class FlushedBatch:
    """What a flush produced: wire messages + the local bookkeeping record."""

    wire_messages: list[UnsequencedMessage]
    # The pre-grouping runtime messages, for pending-state replay.
    messages: list[BatchMessage]
    batch_id: str = ""


class Outbox:
    """Stages runtime messages during a host turn; flush emits wire batches.

    Grouping: a multi-message batch becomes ONE wire message (grouped batch)
    so the sequencer stamps it one sequence number and replicas ungroup it
    into per-op messages with synthetic contiguous ordering — exactly the
    reference's op-grouping design (opGroupingManager.ts:66).
    """

    def __init__(
        self,
        client_id: str,
        *,
        compression_threshold: int = 4096,
        max_chunk_size: int = 716_800,
        group_single: bool = False,
    ) -> None:
        self.client_id = client_id
        self.compression_threshold = compression_threshold
        self.max_chunk_size = max_chunk_size
        self.group_single = group_single
        self._staged: list[BatchMessage] = []
        self._client_seq = 0
        self._batch_counter = 0

    # ------------------------------------------------------------------ stage
    def submit(self, contents: dict[str, Any], local_metadata: Any = None) -> None:
        self._staged.append(BatchMessage(contents, local_metadata))

    @property
    def is_empty(self) -> bool:
        return not self._staged

    def _next_client_seq(self) -> int:
        self._client_seq += 1
        return self._client_seq

    def peek_staged(self) -> BatchMessage | None:
        """Newest staged message without removing it (atomic rollback:
        the channel-level undo must succeed BEFORE the op leaves the
        outbox, or a failed rollback would orphan applied state)."""
        return self._staged[-1] if self._staged else None

    def pop_staged(self) -> BatchMessage | None:
        """Remove and return the most recently staged message (rollback path,
        ref Outbox/BatchManager rollback for ensureNoDataModelChanges)."""
        return self._staged.pop() if self._staged else None

    # ------------------------------------------------------------------ flush
    def flush(self, ref_seq: int, batch_id: str | None = None) -> FlushedBatch | None:
        """Emit everything staged as one atomic batch (or None if empty).

        ``batch_id`` overrides the generated id — used by reconnect replay,
        which must preserve the ORIGINAL batch id for fork detection.
        """
        if not self._staged:
            return None
        staged, self._staged = self._staged, []
        self._batch_counter += 1
        # Batch id = (client, first clientSeq of the batch): stable across
        # resubmit-dedup, mirroring the reference's batchId fork detection.
        first_seq = self._client_seq + 1
        if batch_id is None:
            batch_id = f"{self.client_id}_[{first_seq}]"

        if len(staged) == 1 and not self.group_single:
            payload: dict[str, Any] = staged[0].contents
        else:
            payload = {
                "type": GROUPED_BATCH_TYPE,
                "contents": [m.contents for m in staged],
            }

        serialized = json.dumps(payload, separators=(",", ":"))
        if len(serialized) >= self.compression_threshold:
            data = base64.b64encode(zlib.compress(serialized.encode())).decode()
            payload = {"type": COMPRESSED_TYPE, "data": data}
            serialized = json.dumps(payload, separators=(",", ":"))

        wire: list[UnsequencedMessage] = []
        if len(serialized) > self.max_chunk_size:
            chunks = [
                serialized[i : i + self.max_chunk_size]
                for i in range(0, len(serialized), self.max_chunk_size)
            ]
            for i, chunk in enumerate(chunks):
                wire.append(
                    UnsequencedMessage(
                        client_id=self.client_id,
                        client_seq=self._next_client_seq(),
                        ref_seq=ref_seq,
                        type=MessageType.OP,
                        contents={
                            "type": CHUNK_TYPE,
                            "chunkId": i,
                            "total": len(chunks),
                            "data": chunk,
                        },
                        metadata={"batchId": batch_id} if i == len(chunks) - 1 else None,
                    )
                )
        else:
            wire.append(
                UnsequencedMessage(
                    client_id=self.client_id,
                    client_seq=self._next_client_seq(),
                    ref_seq=ref_seq,
                    type=MessageType.OP,
                    contents=payload,
                    metadata={"batchId": batch_id},
                )
            )
        return FlushedBatch(wire_messages=wire, messages=staged, batch_id=batch_id)

    def park(self, batch_id: str) -> FlushedBatch | None:
        """Drain staged messages WITHOUT minting wire messages or consuming
        clientSeq numbers — used when disconnected or pre-join, where the
        batch goes straight to pending state and replays later (wire
        identity is assigned by the replay flush)."""
        if not self._staged:
            return None
        staged, self._staged = self._staged, []
        return FlushedBatch(wire_messages=[], messages=staged, batch_id=batch_id)

    def mint_direct(self, mtype: str, contents: Any, ref_seq: int) -> UnsequencedMessage:
        """A standalone non-OP wire message (protocol propose/summarize)
        sharing this connection's clientSeq counter — the sequencer enforces
        per-client contiguity, so ALL outbound traffic must thread through
        one counter. Caller must flush staged ops first to keep submission
        order consistent."""
        assert not self._staged, "flush before minting a direct message"
        return UnsequencedMessage(
            client_id=self.client_id,
            client_seq=self._next_client_seq(),
            ref_seq=ref_seq,
            type=mtype,
            contents=contents,
        )


@dataclass
class InboundRuntimeMessage:
    """One ungrouped runtime message with its sequencing info.

    ``seq`` is the wire sequence number of the carrying message; ``index``
    disambiguates position within a grouped batch (the reference synthesizes
    fractional clientSequenceNumbers; an explicit index is cleaner).
    """

    contents: dict[str, Any]
    client_id: str
    seq: int
    min_seq: int
    ref_seq: int
    index: int
    batch_id: str | None = None


class RemoteMessageProcessor:
    """Inbound inverse: unchunk -> decompress -> ungroup.

    Stateful only for chunk reassembly (per sending client), like the
    reference's OpSplitter chunk cache.
    """

    def __init__(self) -> None:
        self._chunks: dict[str, list[str]] = {}

    def process(self, msg: SequencedMessage) -> list[InboundRuntimeMessage]:
        contents = msg.contents
        batch_id = (msg.metadata or {}).get("batchId") if msg.metadata else None

        if isinstance(contents, dict) and contents.get("type") == CHUNK_TYPE:
            buf = self._chunks.setdefault(msg.client_id, [])
            if contents["chunkId"] != len(buf):
                raise ValueError(
                    f"out-of-order chunk {contents['chunkId']} from "
                    f"{msg.client_id!r} (expected {len(buf)})"
                )
            buf.append(contents["data"])
            if len(buf) < contents["total"]:
                return []
            del self._chunks[msg.client_id]
            contents = json.loads("".join(buf))

        if isinstance(contents, dict) and contents.get("type") == COMPRESSED_TYPE:
            raw = zlib.decompress(base64.b64decode(contents["data"]))
            contents = json.loads(raw)

        if isinstance(contents, dict) and contents.get("type") == GROUPED_BATCH_TYPE:
            inner = contents["contents"]
        else:
            inner = [contents]

        return [
            InboundRuntimeMessage(
                contents=c,
                client_id=msg.client_id,
                seq=msg.seq,
                min_seq=msg.min_seq,
                ref_seq=msg.ref_seq,
                index=i,
                batch_id=batch_id,
            )
            for i, c in enumerate(inner)
        ]


class DuplicateBatchDetector:
    """Container fork detection via batch ids (duplicateBatchDetector.ts).

    Two containers rehydrated from the same stashed pending state would
    resubmit the same batch id; the second sequenced copy must be dropped
    (and signals a fork). Tracks ids above the collab-window floor only.
    """

    def __init__(self) -> None:
        self._seen: dict[str, int] = {}

    def observe(self, batch_id: str | None, seq: int, min_seq: int) -> bool:
        """Returns True if this batch is a duplicate (must be ignored)."""
        # Evict ids at/below the new collab-window floor: no correctly
        # behaving client can resubmit a batch older than the MSN.
        for bid in [b for b, s in self._seen.items() if s <= min_seq]:
            del self._seen[bid]
        if batch_id is None:
            return False
        if batch_id in self._seen:
            return True
        self._seen[batch_id] = seq
        return False
