"""SharedString: host-side client over a merge-tree backend.

The port's own copy of ``fluidframework_tpu/dds/shared_string.py``; the
obliterate place decoder lives in ``protocol/messages.py`` (the fleet
engines read it there) and is re-exported here.

Reference parity: merge-tree ``Client`` (client.ts — applyMsg:1358, local op
mint + pending-ack bookkeeping) and sequence ``SharedStringClass``.  The
backend is pluggable (the channel-boundary analog, ref
datastore-definitions/src/channel.ts): the pure-Python oracle
(``RefMergeTree``) or the device backend (``KernelMergeTree``).

Wire op format (contents of a SequencedMessage for this channel):
    {"type": 0, "pos1": P, "seg": "text"}              insert
    {"type": 1, "pos1": A, "pos2": B}                  set-remove
    {"type": 2, "pos1": A, "pos2": B, "props": {...}}  annotate
mirroring merge-tree/src/ops.ts IMergeTreeOp (JSON-compatible so traces can
be replayed across implementations).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Protocol

from ..protocol.messages import (  # noqa: F401 (decode_obliterate_places: re-export)
    DeltaType,
    MessageType,
    Nack,
    SequencedMessage,
    UnsequencedMessage,
    decode_obliterate_places,
)
from ..protocol.stamps import ALL_ACKED, encode_stamp
from .mergetree_ref import SIDE_AFTER, SIDE_BEFORE, RefMergeTree


def validate_obliterate_places(
    pos1: int, side1: int, pos2: int, side2: int, vis_len: int
) -> None:
    """Reject invalid sided places BEFORE submission: a backend that only
    latches error flags (the kernel) must not broadcast an op that would
    make every oracle-backed remote raise."""
    start = pos1 + (1 if side1 == SIDE_AFTER else 0)
    end = pos2 + (1 if side2 == SIDE_AFTER else 0)
    if not (0 <= pos1 <= pos2 < vis_len and start <= end):
        raise ValueError(
            f"obliterate places ({pos1},{side1})..({pos2},{side2}) invalid "
            f"for visible length {vis_len}"
        )


class MergeTreeBackend(Protocol):
    """What a merge-tree replica must support (oracle or device kernel)."""

    def apply_insert(self, pos: int, text: str, op_key: int, op_client: int, ref_seq: int) -> None: ...
    def apply_remove(self, pos1: int, pos2: int, op_key: int, op_client: int, ref_seq: int) -> None: ...
    def apply_annotate(self, pos1: int, pos2: int, prop: int, value: int, op_key: int, op_client: int, ref_seq: int) -> None: ...
    def apply_obliterate(self, pos1: int, side1: int, pos2: int, side2: int, op_key: int, op_client: int, ref_seq: int) -> None: ...
    def ack(self, local_seq: int, seq: int) -> None: ...
    def update_min_seq(self, min_seq: int) -> None: ...
    def visible_text(self, ref_seq: int = ALL_ACKED, view_client: int | None = None) -> str: ...


@dataclass
class PendingOp:
    local_seq: int
    contents: dict[str, Any]


class SharedString:
    """One client replica of a collaborative string.

    Local edits apply optimistically with pending stamps and are queued for
    the ordering service; sequenced messages flow back through ``process``
    (own ops ack, remote ops apply under the sender's perspective).
    """

    def __init__(self, client_id: str, backend: MergeTreeBackend | None = None) -> None:
        self.client_id = client_id
        self.short_client = -1  # assigned by our join message
        self.backend: MergeTreeBackend = backend if backend is not None else RefMergeTree()
        self._local_seq = 0
        self._client_seq = 0
        self._pending: deque[PendingOp] = deque()
        self._ref_seq = 0
        # clientId -> short numeric id, built from sequenced join messages
        # (the quorum table; reference derives stamp client ids the same way).
        self._quorum: dict[str, int] = {}
        self.outbox: list[UnsequencedMessage] = []

    def _require_joined(self) -> None:
        if self.short_client < 0:
            raise RuntimeError(
                f"client {self.client_id!r} cannot edit before its join is "
                "sequenced and delivered (short client id unassigned)"
            )

    # ------------------------------------------------------------- local edits
    def insert_text(self, pos: int, text: str) -> None:
        assert text
        from .markers import assert_no_marker_plane

        assert_no_marker_plane(text)
        self._require_joined()
        self._local_seq += 1
        self.backend.apply_insert(
            pos, text, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit({"type": int(DeltaType.INSERT), "pos1": pos, "seg": text})

    def remove_range(self, pos1: int, pos2: int) -> None:
        assert pos1 < pos2
        self._require_joined()
        self._local_seq += 1
        self.backend.apply_remove(
            pos1, pos2, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit({"type": int(DeltaType.REMOVE), "pos1": pos1, "pos2": pos2})

    def obliterate_range(self, pos1: int, pos2: int) -> None:
        """Slice-remove [pos1, pos2): also swallows concurrent inserts into
        the range (ref client.ts applyObliterateRangeOp:558)."""
        assert pos1 < pos2
        self._require_joined()
        self._local_seq += 1
        self.backend.apply_obliterate(
            pos1, SIDE_BEFORE, pos2 - 1, SIDE_AFTER,
            encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED,
        )
        self._submit(
            {"type": int(DeltaType.OBLITERATE), "pos1": pos1, "pos2": pos2}
        )

    def obliterate_range_sided(
        self, start: tuple[int, bool], end: tuple[int, bool]
    ) -> None:
        """Sided obliterate: endpoints are (char pos, before) places
        (ref ops.ts OBLITERATE_SIDED, client.ts:568)."""
        self._require_joined()
        s1 = SIDE_BEFORE if start[1] else SIDE_AFTER
        s2 = SIDE_BEFORE if end[1] else SIDE_AFTER
        validate_obliterate_places(
            start[0], s1, end[0], s2,
            self.backend.visible_length(ALL_ACKED, self.short_client),
        )
        self._local_seq += 1
        self.backend.apply_obliterate(
            start[0], s1, end[0], s2,
            encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED,
        )
        self._submit(
            {
                "type": int(DeltaType.OBLITERATE_SIDED),
                "pos1": {"pos": start[0], "before": start[1]},
                "pos2": {"pos": end[0], "before": end[1]},
            }
        )

    def annotate_range(self, pos1: int, pos2: int, prop: int, value: int) -> None:
        assert pos1 < pos2
        self._require_joined()
        self._local_seq += 1
        self.backend.apply_annotate(
            pos1, pos2, prop, value,
            encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED,
        )
        self._submit(
            {"type": int(DeltaType.ANNOTATE), "pos1": pos1, "pos2": pos2,
             "props": {str(prop): value}}
        )

    def _submit(self, contents: dict[str, Any]) -> None:
        self._client_seq += 1
        self._pending.append(PendingOp(self._local_seq, contents))
        self.outbox.append(
            UnsequencedMessage(
                client_id=self.client_id,
                client_seq=self._client_seq,
                ref_seq=self._ref_seq,
                type=MessageType.OP,
                contents=contents,
            )
        )

    def take_outbox(self) -> list[UnsequencedMessage]:
        out = self.outbox
        self.outbox = []
        return out

    # --------------------------------------------------------------- inbound
    def process(self, msg: SequencedMessage) -> None:
        """Apply one sequenced message (ref Client.applyMsg)."""
        if msg.type == MessageType.JOIN:
            self._quorum[msg.contents["clientId"]] = msg.contents["short"]
            if msg.client_id == self.client_id and self.short_client < 0:
                self.short_client = msg.contents["short"]
            self._after_apply(msg)
            return
        if msg.type != MessageType.OP:
            self._after_apply(msg)
            return

        if msg.client_id == self.client_id:
            pending = self._pending.popleft()
            self.backend.ack(pending.local_seq, msg.seq)
        else:
            self._apply_remote(msg)
        self._after_apply(msg)

    def process_nack(self, nack: Nack) -> None:
        """A nacked op invalidates this replica's pending state.

        The reference reacts by disconnecting and replaying pending ops on a
        fresh connection (PendingStateManager.replayPendingStates); until the
        resubmit path lands in the runtime layer, fail fast rather than wedge
        with a permanently mismatched pending queue.
        """
        raise RuntimeError(
            f"op nacked for {self.client_id!r} (clientSeq {nack.client_seq}): "
            f"{nack.reason}; reconnect/resubmit is required"
        )

    def _after_apply(self, msg: SequencedMessage) -> None:
        self._ref_seq = msg.seq
        self.backend.update_min_seq(msg.min_seq)

    def _apply_remote(self, msg: SequencedMessage) -> None:
        c = msg.contents
        kind = c["type"]
        key = msg.seq
        # Stamp client comes from the quorum table (join order), not from any
        # out-of-band field — keeps replicas wire-faithful for trace replay.
        client = self._quorum[msg.client_id]
        ref_seq = msg.ref_seq
        if kind == DeltaType.INSERT:
            self.backend.apply_insert(c["pos1"], c["seg"], key, client, ref_seq)
        elif kind == DeltaType.REMOVE:
            self.backend.apply_remove(c["pos1"], c["pos2"], key, client, ref_seq)
        elif kind == DeltaType.ANNOTATE:
            for prop, value in c["props"].items():
                self.backend.apply_annotate(
                    c["pos1"], c["pos2"], int(prop), value, key, client, ref_seq
                )
        elif kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
            p1, s1, p2, s2 = decode_obliterate_places(c)
            self.backend.apply_obliterate(p1, s1, p2, s2, key, client, ref_seq)
        else:
            raise ValueError(f"unsupported merge-tree op type {kind}")

    # ----------------------------------------------------------------- views
    @property
    def text(self) -> str:
        return self.backend.visible_text(ALL_ACKED, self.short_client)

    @property
    def current_seq(self) -> int:
        """Last sequence number this replica has applied (reference
        Client.getCurrentSeq)."""
        return self._ref_seq
