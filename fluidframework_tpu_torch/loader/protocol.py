"""Protocol handler: quorum membership and consensus proposals.

A port of ``fluidframework_tpu/loader/protocol.py`` (no JAX in it).

Reference parity: container-loader/src/protocol.ts (:105) over protocol-base
``ProtocolOpHandler`` (protocol.ts:52) and ``Quorum`` (quorum.ts:449):

- joins/leaves are sequenced system messages maintaining the member table;
- a *proposal* (``MessageType.PROPOSE``) is a (key, value) pair that becomes
  **accepted once the MSN reaches its sequence number** — at that point every
  connected client has processed it, so all replicas commit it at the same
  op-stream position (the reference's zero-vote approval model);
- accepted values are a consistent key→value map used for container-level
  consensus (e.g. the "code" proposal selecting the runtime package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..protocol.messages import MessageType, SequencedMessage


@dataclass
class QuorumMember:
    client_id: str
    short_client: int
    join_seq: int


@dataclass
class PendingProposal:
    seq: int
    key: str
    value: Any
    client_id: str


class Quorum:
    """Member table + accepted-value map (ref quorum.ts:449)."""

    def __init__(self) -> None:
        self.members: dict[str, QuorumMember] = {}
        self.values: dict[str, tuple[Any, int]] = {}  # key -> (value, accept seq)
        self.pending: list[PendingProposal] = []  # ordered by seq

    def get(self, key: str) -> Any:
        entry = self.values.get(key)
        return entry[0] if entry else None

    def has(self, key: str) -> bool:
        return key in self.values


class ProtocolHandler:
    """Applies protocol-level sequenced messages; tracks quorum state.

    ``on_accept(key, value, seq)`` callbacks fire when a proposal commits.
    ``attributes`` carries (seq, min_seq) for summary/restore
    (ref IProtocolState).
    """

    def __init__(self) -> None:
        self.quorum = Quorum()
        self.seq = 0
        self.min_seq = 0
        self._accept_listeners: list[Callable[[str, Any, int], None]] = []
        self._member_listeners: list[Callable[[str, str], None]] = []

    def on_accept(self, listener: Callable[[str, Any, int], None]) -> None:
        self._accept_listeners.append(listener)

    def on_member_change(self, listener: Callable[[str, str], None]) -> None:
        """``listener(kind, client_id)`` with kind "join"/"leave" — fires on
        sequenced quorum membership changes (the Audience's write-member
        feed; container.ts wires audience off protocol the same way)."""
        self._member_listeners.append(listener)

    # ------------------------------------------------------------------ apply
    def process_message(self, msg: SequencedMessage) -> None:
        if msg.seq <= self.seq:
            return  # catch-up replay duplicate
        self.seq = msg.seq
        self.min_seq = max(self.min_seq, msg.min_seq)

        if msg.type == MessageType.JOIN:
            cid = msg.contents["clientId"]
            self.quorum.members[cid] = QuorumMember(
                client_id=cid,
                short_client=msg.contents["short"],
                join_seq=msg.seq,
            )
            for fn in list(self._member_listeners):
                fn("join", cid)
        elif msg.type == MessageType.LEAVE:
            if self.quorum.members.pop(msg.contents["clientId"], None) is not None:
                for fn in list(self._member_listeners):
                    fn("leave", msg.contents["clientId"])
        elif msg.type == MessageType.PROPOSE:
            self.quorum.pending.append(
                PendingProposal(
                    seq=msg.seq,
                    key=msg.contents["key"],
                    value=msg.contents["value"],
                    client_id=msg.client_id,
                )
            )

        # Accept every pending proposal the MSN has passed (quorum.ts
        # "commit on msn >= sequenceNumber").
        while self.quorum.pending and self.quorum.pending[0].seq <= self.min_seq:
            p = self.quorum.pending.pop(0)
            self.quorum.values[p.key] = (p.value, p.seq)
            for listener in self._accept_listeners:
                listener(p.key, p.value, p.seq)

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        """Protocol state for the snapshot (ref IProtocolState / scribe's
        protocol tree): members, accepted values, still-pending proposals."""
        return {
            "seq": self.seq,
            "minSeq": self.min_seq,
            "members": [
                {"clientId": m.client_id, "short": m.short_client, "joinSeq": m.join_seq}
                for m in self.quorum.members.values()
            ],
            "values": {k: [v, s] for k, (v, s) in self.quorum.values.items()},
            "pending": [
                {"seq": p.seq, "key": p.key, "value": p.value, "clientId": p.client_id}
                for p in self.quorum.pending
            ],
        }

    def load(self, state: dict[str, Any]) -> None:
        self.seq = state["seq"]
        self.min_seq = state["minSeq"]
        for m in state["members"]:
            self.quorum.members[m["clientId"]] = QuorumMember(
                client_id=m["clientId"],
                short_client=m["short"],
                join_seq=m["joinSeq"],
            )
        self.quorum.values = {k: (v[0], v[1]) for k, v in state["values"].items()}
        self.quorum.pending = [
            PendingProposal(
                seq=p["seq"], key=p["key"], value=p["value"], client_id=p["clientId"]
            )
            for p in state["pending"]
        ]
