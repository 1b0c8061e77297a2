"""Columnar delta wire frames: encode once per (doc, pump), scatter bytes.

A port of ``fluidframework_tpu/fanout/frames.py`` (no JAX in it).

The write path already encodes each ``SequencedMessage`` exactly once
(``wire_line``/``op_envelope`` cache the bytes on the message).  What the
read path still paid per subscriber was the PYTHON WALK: one callback, one
queue append, one socket write *per message per subscriber*.  A
``DeltaFrame`` collapses a whole pump's sequenced batch for one document
into ONE immutable bytes payload per wire flavor, built from the cached
per-message encodes — so fan-out to N subscribers is N buffer references to
the same object, not N x B encodes or N x B callbacks.

Two flavors of the same frame, both composed from the single cached encode:

- ``wire``     — bare ``SequencedMessage`` JSON lines (the firehose /
  deltas-topic consumer seam; exactly what ``native/ingest.cpp`` parses);
- ``envelope`` — the nexus client broadcast form, each line wrapped as
  ``{"t":"op","msg":<line>}`` (textual wrap around the SAME cached encode;
  no re-``json.dumps``).

``protocol.messages.wire_encode_count()`` counts actual ``json.dumps``
calls, so tests and the fanout bench can assert the ≤1-encode-per-
(doc, pump) contract regardless of subscriber count.
"""

from __future__ import annotations

from typing import Sequence

from ..protocol.messages import SequencedMessage

# Wire flavors a subscriber may attach with.
FLAVOR_WIRE = "wire"
FLAVOR_ENVELOPE = "envelope"

# Frame kinds: a live pump batch vs. a catch-up rebuild from the ordered
# log after a drop (byte-identical content, flagged for observability).
KIND_DELTA = "delta"
KIND_RESYNC = "resync"


class DeltaFrame:
    """One document's sequenced batch for one pump, encoded once."""

    __slots__ = ("doc_id", "seq_lo", "seq_hi", "n_msgs", "wire", "kind",
                 "_msgs", "_envelope")

    def __init__(
        self,
        doc_id: str,
        msgs: Sequence[SequencedMessage],
        kind: str = KIND_DELTA,
    ) -> None:
        if not msgs:
            raise ValueError("empty delta frame")
        self.doc_id = doc_id
        self._msgs = tuple(msgs)
        self.n_msgs = len(self._msgs)
        self.seq_lo = self._msgs[0].seq
        self.seq_hi = self._msgs[-1].seq
        self.kind = kind
        # The bare firehose payload is built eagerly (every deployment has
        # at least one wire-flavor consumer: the device fleet); the client
        # envelope lazily on first envelope subscriber.
        self.wire = b"".join(m.wire_line() for m in self._msgs)
        self._envelope: bytes | None = None

    @property
    def envelope(self) -> bytes:
        b = self._envelope
        if b is None:
            b = b"".join(m.op_envelope() for m in self._msgs)
            self._envelope = b
        return b

    def payload(self, flavor: str) -> bytes:
        return self.wire if flavor == FLAVOR_WIRE else self.envelope

    @property
    def nbytes(self) -> int:
        return len(self.wire)

    def __repr__(self) -> str:  # debugging/trace labels
        return (f"DeltaFrame({self.doc_id!r}, seq {self.seq_lo}-{self.seq_hi},"
                f" n={self.n_msgs}, kind={self.kind})")


def build_frame(
    doc_id: str, msgs: Sequence[SequencedMessage], kind: str = KIND_DELTA
) -> DeltaFrame:
    """Frame one pump's batch (the ``BroadcasterLambda.subscribe_frames``
    seam and the hub's flush both land here)."""
    return DeltaFrame(doc_id, msgs, kind=kind)
