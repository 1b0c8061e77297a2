"""The port's own copy of ``fluidframework_tpu/server/sequencer.py`` (no JAX in it).

The ordering kernel: a pure integer state machine assigning total order.

Reference parity: deli's ``ticket()`` (server/routerlicious/packages/lambdas/
src/deli/lambda.ts:851) and its ``ClientSequenceNumberManager`` MSN
computation (deli/clientSeqManager.ts): every inbound client op receives the
next ``sequenceNumber``; the **minimum sequence number** (MSN) is the minimum
reference sequence number over all connected write clients and is stamped on
every outgoing op — it is the collab-window floor used for compaction.

Join/leave are themselves sequenced system messages, exactly as deli tickets
client joins before any of that client's ops (unjoined clients are nacked).

This is deliberately host-side CPU code: sequencing is a tiny serial integer
state machine; the device work is op *application*, which consumes this stream.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..protocol.messages import (
    MessageType,
    Nack,
    SequencedMessage,
    UnsequencedMessage,
)


@dataclass
class ClientEntry:
    """Per-connected-client sequencing state (ref deli IClientSequenceNumber)."""

    client_id: str
    short_client: int  # numeric id in join order; used in op stamps
    ref_seq: int  # last refSeq observed from this client
    client_seq: int  # last clientSequenceNumber (dup detection)
    can_evict: bool = True


class Sequencer:
    """Deli-equivalent per-document sequencer.

    Usage: ``join`` clients, feed ``UnsequencedMessage``s through ``ticket``,
    fan the returned ``SequencedMessage`` out to every replica (including the
    sender, which treats it as its ack).
    """

    def __init__(self, starting_seq: int = 0) -> None:
        self._seq = starting_seq
        self._clients: dict[str, ClientEntry] = {}
        self._next_short = 0
        self.log: list[SequencedMessage] = []  # scriptorium analog (op log)
        # Highest summary-acked refSeq the scribe has externalized through
        # this sequencer (mint_service tracks it): the durable floor that
        # drives consumer-side zamboni on acks instead of timers.
        self._ack_floor = 0

    # ------------------------------------------------------------------ admin
    @property
    def seq(self) -> int:
        return self._seq

    @property
    def min_seq(self) -> int:
        """MSN: min refSeq over connected clients, or current seq if none."""
        if not self._clients:
            return self._seq
        return min(c.ref_seq for c in self._clients.values())

    def clients(self) -> dict[str, ClientEntry]:
        return dict(self._clients)

    # ------------------------------------------------------------------ joins
    def join(self, client_id: str) -> SequencedMessage:
        """Sequence a join; assigns the short numeric id used in stamps."""
        if client_id in self._clients:
            raise ValueError(f"duplicate join: {client_id}")
        entry = ClientEntry(
            client_id=client_id,
            short_client=self._next_short,
            ref_seq=self._seq,
            client_seq=0,
        )
        self._next_short += 1
        self._clients[client_id] = entry
        out = self._stamp(
            UnsequencedMessage(
                client_id=client_id,
                client_seq=0,
                ref_seq=self._seq,
                type=MessageType.JOIN,
                contents={"clientId": client_id, "short": entry.short_client},
            ),
            entry,
        )
        # The joining client observes the stream from its own join onward.
        entry.ref_seq = out.seq
        return out

    def leave(self, client_id: str) -> SequencedMessage:
        entry = self._clients.pop(client_id, None)
        if entry is None:
            raise ValueError(f"leave of unjoined client: {client_id}")
        return self._stamp(
            UnsequencedMessage(
                client_id=client_id,
                client_seq=entry.client_seq + 1,
                ref_seq=entry.ref_seq,
                type=MessageType.LEAVE,
                contents={"clientId": client_id},
            ),
            entry,
        )

    # ----------------------------------------------------------------- ticket
    def ticket(self, msg: UnsequencedMessage) -> SequencedMessage | Nack:
        """Assign the next sequence number, or nack (ref deli lambda.ts:851).

        Nack rules mirror deli: ops from unjoined clients are rejected, as are
        ops whose refSeq is below the current MSN (the sender fell out of the
        collab window and must reconnect/catch up).
        """
        entry = self._clients.get(msg.client_id)
        if entry is None:
            return Nack(msg.client_id, msg.client_seq, "client not joined")
        if msg.ref_seq < self.min_seq:
            return Nack(msg.client_id, msg.client_seq, "refSeq below MSN")
        if msg.ref_seq > self._seq:
            return Nack(msg.client_id, msg.client_seq, "refSeq from the future")
        if msg.client_seq != entry.client_seq + 1:
            # Duplicate or gap in the client's own op stream (exactly-once).
            return Nack(msg.client_id, msg.client_seq, "clientSeq out of order")
        entry.client_seq = msg.client_seq
        entry.ref_seq = max(entry.ref_seq, msg.ref_seq)
        return self._stamp(msg, entry)

    def _stamp(self, msg: UnsequencedMessage, entry: ClientEntry) -> SequencedMessage:
        self._seq += 1
        out = SequencedMessage(
            client_id=msg.client_id,
            client_seq=msg.client_seq,
            ref_seq=msg.ref_seq,
            seq=self._seq,
            min_seq=self.min_seq,
            type=msg.type,
            contents=msg.contents,
            metadata=msg.metadata,
            timestamp=time.time(),
            short_client=entry.short_client,
        )
        self.log.append(out)
        return out

    @property
    def ack_msn(self) -> int:
        """Scribe-driven MSN: the compaction floor an ack authorizes.
        Bounded by the collab-window MSN — the ack proves durability below
        its refSeq, but state inside the live window must survive for
        rebase regardless of what the scribe persisted."""
        return min(self._ack_floor, self.min_seq)

    def mint_service(self, mtype: str, contents) -> SequencedMessage:
        """Service-originated sequenced message (summary acks/nacks — the
        scribe's voice in the stream, ref scribe/lambda.ts sendSummaryAck).

        Summary acks carry the ack-derived MSN (``contents["msn"]``): the
        signal device fleets compact (zamboni) on — the scribe's durable
        floor plumbed back through the sequencer into the op stream."""
        if mtype == MessageType.SUMMARY_ACK and isinstance(contents, dict):
            ref = contents.get("refSeq")
            if isinstance(ref, int):
                self._ack_floor = max(self._ack_floor, ref)
            contents.setdefault("msn", self.ack_msn)
        self._seq += 1
        out = SequencedMessage(
            client_id="__service__",
            client_seq=0,
            ref_seq=self._seq - 1,
            seq=self._seq,
            min_seq=self.min_seq,
            type=mtype,
            contents=contents,
            metadata=None,
            timestamp=time.time(),
            short_client=-1,
        )
        self.log.append(out)
        return out

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> dict:
        """Serializable sequencer state (ref deli checkpointManager)."""
        return {
            "seq": self._seq,
            "nextShort": self._next_short,
            "ackFloor": self._ack_floor,
            "clients": [
                {
                    "clientId": c.client_id,
                    "short": c.short_client,
                    "refSeq": c.ref_seq,
                    "clientSeq": c.client_seq,
                }
                for c in self._clients.values()
            ],
        }

    @staticmethod
    def restore(state: dict) -> "Sequencer":
        s = Sequencer(starting_seq=state["seq"])
        s._next_short = state["nextShort"]
        s._ack_floor = state.get("ackFloor", 0)
        for c in state["clients"]:
            s._clients[c["clientId"]] = ClientEntry(
                client_id=c["clientId"],
                short_client=c["short"],
                ref_seq=c["refSeq"],
                client_seq=c["clientSeq"],
            )
        return s
