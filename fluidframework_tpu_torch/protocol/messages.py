"""Wire message contracts: the subset the fleet engine reads.

A copy of ``fluidframework_tpu/protocol/messages.py`` (``MessageType``,
``DeltaType``, ``SequencedMessage``) plus the obliterate place decoder of
``fluidframework_tpu/dds/shared_string.py``.  The engine reads messages by
attribute only (``type``, ``seq``, ``min_seq``, ``ref_seq``, ``client_id``,
``contents``), so a message minted by the JAX package's sequencer ingests
here unchanged.
"""

from __future__ import annotations

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


class DeltaType(IntEnum):
    """Merge-tree op types (reference MergeTreeDeltaType, ops.ts:61)."""

    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2
    GROUP = 3
    OBLITERATE = 4
    OBLITERATE_SIDED = 5


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
