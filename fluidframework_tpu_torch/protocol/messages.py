"""Wire message contracts: the subset the fleet engines read.

A copy of ``fluidframework_tpu/protocol/messages.py`` (``MessageType``,
``DeltaType``, ``UnsequencedMessage``, ``SequencedMessage`` with its JSON
wire codec) plus the obliterate place decoder of
``fluidframework_tpu/dds/shared_string.py``.  The engines read messages by
attribute only (``type``, ``seq``, ``min_seq``, ``ref_seq``, ``client_id``,
``contents``), so a message minted by the JAX package's sequencer ingests
here unchanged, and ``to_json`` writes the same bytes as the reference's
(camelCase wire names), so a JSON-lines feed decodes identically in both.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from enum import IntEnum
from typing import Any

# Obliterate endpoint sides (reference sequencePlace.ts Side).
SIDE_BEFORE = 0
SIDE_AFTER = 1


class MessageType:
    """Protocol-level message types (subset the engine reads)."""

    OP = "op"
    NOOP = "noop"
    JOIN = "join"
    LEAVE = "leave"
    SUMMARY_ACK = "summaryAck"


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
    ref_seq: int  # referenceSequenceNumber: last seq the client had applied
    type: str = MessageType.OP
    contents: Any = None
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
    """An op after the sequencer stamped its total-order position
    (reference ISequencedDocumentMessage); ``min_seq`` is the collab-window
    floor below which state may be compacted."""

    client_id: str
    client_seq: int
    ref_seq: int
    seq: int
    min_seq: int
    type: str = MessageType.OP
    contents: Any = None
    metadata: Any = None
    timestamp: float = 0.0
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
        """``to_json() + "\\n"`` encoded once and cached on the message
        (sequenced messages are immutable after minting)."""
        b = self.__dict__.get("_wire_line")
        if b is None:
            b = (self.to_json() + "\n").encode()
            self.__dict__["_wire_line"] = b
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
