"""Wire message contracts.

The port's own copy of ``fluidframework_tpu/protocol/messages.py``, plus
the obliterate place decoder of ``fluidframework_tpu/dds/shared_string.py``
(``decode_obliterate_places``) that the fleet engines and the scribe read.

Reference parity: common/lib/protocol-definitions ``IDocumentMessage`` /
``ISequencedDocumentMessage`` (op envelope stamped by the ordering service),
``MessageType`` (op/join/leave/noop/summarize), and merge-tree
``MergeTreeDeltaType`` (merge-tree/src/ops.ts:61).

Field names keep the reference's JSON wire names (camelCase) in
``to_json``/``from_json`` so op traces are interchangeable; in-memory we use
snake_case dataclasses.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any

# Obliterate endpoint sides (reference sequencePlace.ts Side).
SIDE_BEFORE = 0
SIDE_AFTER = 1


# Count of actual wire encodes (``json.dumps`` in ``wire_line``): bumped
# once per message EVER, however many subscribers fan the bytes out.  The
# read-fanout plane's tests and bench assert the encode-once contract on
# deltas of this counter (a plain int under the GIL: a stats counter, not
# a synchronization primitive).
_wire_encodes = 0


def wire_encode_count() -> int:
    """Total ``SequencedMessage`` wire encodes performed by this process."""
    return _wire_encodes


class MessageType:
    """Protocol-level message types (subset the framework uses)."""

    OP = "op"
    NOOP = "noop"
    JOIN = "join"
    LEAVE = "leave"
    PROPOSE = "propose"
    REJECT = "reject"
    SUMMARIZE = "summarize"
    SUMMARY_ACK = "summaryAck"
    SUMMARY_NACK = "summaryNack"
    SIGNAL = "signal"  # unsequenced broadcast (presence)


class DeltaType(IntEnum):
    """Merge-tree op types (reference MergeTreeDeltaType, ops.ts:61)."""

    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2
    GROUP = 3
    OBLITERATE = 4
    OBLITERATE_SIDED = 5


@dataclass
class UnsequencedMessage:
    """A client op before ordering (reference IDocumentMessage)."""

    client_id: str
    client_seq: int  # clientSequenceNumber: per-client monotone counter
    ref_seq: int  # referenceSequenceNumber: last seq client had applied
    type: str = MessageType.OP
    contents: Any = None
    # Op metadata (reference IDocumentMessage.metadata): batch markers /
    # batch ids ride here, opaque to the sequencer.
    metadata: Any = None

    def to_json(self) -> str:
        return json.dumps(
            {
                "clientId": self.client_id,
                "clientSequenceNumber": self.client_seq,
                "referenceSequenceNumber": self.ref_seq,
                "type": self.type,
                "contents": self.contents,
                "metadata": self.metadata,
            },
            separators=(",", ":"),
        )

    @staticmethod
    def from_json(raw: str) -> "UnsequencedMessage":
        d = json.loads(raw)
        return UnsequencedMessage(
            client_id=d["clientId"],
            client_seq=d["clientSequenceNumber"],
            ref_seq=d["referenceSequenceNumber"],
            type=d.get("type", MessageType.OP),
            contents=d.get("contents"),
            metadata=d.get("metadata"),
        )


@dataclass
class SequencedMessage:
    """An op after the sequencer stamped a total order position.

    Reference ISequencedDocumentMessage: sequenceNumber is the total-order
    position; minimumSequenceNumber (MSN) is the collab-window floor — every
    connected client has applied at least this seq, so state below it may be
    compacted (zamboni / trunk eviction).
    """

    client_id: str
    client_seq: int
    ref_seq: int
    seq: int
    min_seq: int
    type: str = MessageType.OP
    contents: Any = None
    metadata: Any = None
    timestamp: float = 0.0
    # Short numeric client id assigned by quorum join order (the id used in
    # stamps; reference attributes ops via the quorum's client table).
    short_client: int = -1

    def to_json(self) -> str:
        return json.dumps(
            {
                "clientId": self.client_id,
                "clientSequenceNumber": self.client_seq,
                "referenceSequenceNumber": self.ref_seq,
                "sequenceNumber": self.seq,
                "minimumSequenceNumber": self.min_seq,
                "type": self.type,
                "contents": self.contents,
                "metadata": self.metadata,
                "timestamp": self.timestamp,
                "shortClient": self.short_client,
            },
            separators=(",", ":"),
        )

    def wire_line(self) -> bytes:
        """``to_json() + "\\n"`` encoded ONCE and cached on the message.

        Sequenced messages are immutable after minting, so the deli->
        firehose hot path encodes each message a single time at sequencing
        and every subscriber fans out the same buffer — no per-op
        ``json.dumps`` per consumer under the service lock (ref deli
        produce, server/routerlicious/packages/lambdas/src/deli/
        lambda.ts:851, which stringifies once into the Kafka produce)."""
        b = self.__dict__.get("_wire_line")
        if b is None:
            global _wire_encodes
            _wire_encodes += 1
            b = (self.to_json() + "\n").encode()
            self.__dict__["_wire_line"] = b
        return b

    def op_envelope(self) -> bytes:
        """The nexus broadcast frame ``{"t":"op","msg":<this>}`` as cached
        bytes: composed textually around ``wire_line`` so a thousand
        connected sockets share one encode (ref nexus emit fan-out)."""
        b = self.__dict__.get("_op_env")
        if b is None:
            b = b'{"t":"op","msg":' + self.wire_line()[:-1] + b"}\n"
            self.__dict__["_op_env"] = b
        return b

    @staticmethod
    def from_json(raw: str) -> "SequencedMessage":
        d = json.loads(raw)
        return SequencedMessage(
            client_id=d["clientId"],
            client_seq=d["clientSequenceNumber"],
            ref_seq=d["referenceSequenceNumber"],
            seq=d["sequenceNumber"],
            min_seq=d["minimumSequenceNumber"],
            type=d.get("type", MessageType.OP),
            contents=d.get("contents"),
            metadata=d.get("metadata"),
            timestamp=d.get("timestamp", 0.0),
            short_client=d.get("shortClient", -1),
        )


@dataclass
class Nack:
    """Rejection of a client op (reference INack): bad refSeq / not joined."""

    client_id: str
    client_seq: int
    reason: str
    retry_after: float = 0.0


@dataclass
class SignalMessage:
    """Unsequenced broadcast (presence path; reference ISignalMessage)."""

    client_id: str
    contents: Any = None


def decode_obliterate_places(c: dict) -> tuple[int, int, int, int]:
    """Wire op -> (pos1, side1, pos2, side2) endpoint places.  The plain
    OBLITERATE form {pos1, pos2} is the sided range (pos1, Before) ..
    (pos2-1, After) (ref mergeTree.ts obliterateRange:2282)."""
    if c["type"] == int(DeltaType.OBLITERATE):
        return c["pos1"], SIDE_BEFORE, c["pos2"] - 1, SIDE_AFTER
    p1, p2 = c["pos1"], c["pos2"]
    return (
        p1["pos"], SIDE_BEFORE if p1["before"] else SIDE_AFTER,
        p2["pos"], SIDE_BEFORE if p2["before"] else SIDE_AFTER,
    )
