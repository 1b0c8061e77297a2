"""The port's own copy of ``fluidframework_tpu/dds/shared_map.py`` (no JAX in it).

SharedMap: host-side LWW key-value DDS with optimistic pending overlay.

Reference parity: map's ``MapKernel`` (packages/dds/map/src/mapKernel.ts).
The *sequenced* (converged) state applies every set/delete/clear in sequence
order; the local optimistic view overlays the client's pending ops — a
pending set/delete/clear masks remote values until acked
(mapKernel.ts:707-852 message handlers), which is exactly LWW given that a
pending op will be sequenced after everything currently acked.

Wire op format: {"type": "set"|"delete"|"clear", "key"?: str, "value"?: any}
(matching the reference's IMapOperation JSON shape).
"""

from __future__ import annotations

from collections import deque
from typing import Any

from ..protocol.messages import MessageType, Nack, SequencedMessage, UnsequencedMessage


class SharedMap:
    """One client replica of a collaborative LWW map."""

    def __init__(self, client_id: str) -> None:
        self.client_id = client_id
        self.sequenced: dict[str, Any] = {}
        self._pending: deque[dict] = deque()
        self._client_seq = 0
        self._ref_seq = 0
        self.outbox: list[UnsequencedMessage] = []

    # ------------------------------------------------------------- local edits
    def set(self, key: str, value: Any) -> None:
        self._submit({"type": "set", "key": key, "value": value})

    def delete(self, key: str) -> None:
        self._submit({"type": "delete", "key": key})

    def clear(self) -> None:
        self._submit({"type": "clear"})

    def _submit(self, contents: dict) -> None:
        self._client_seq += 1
        self._pending.append(contents)
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
        self._ref_seq = msg.seq
        if msg.type != MessageType.OP:
            return
        if msg.client_id == self.client_id:
            pending = self._pending.popleft()
            assert pending["type"] == msg.contents["type"], "pending skew"
            self._apply(msg.contents)
        else:
            self._apply(msg.contents)

    def process_nack(self, nack: Nack) -> None:
        raise RuntimeError(
            f"map op nacked for {self.client_id!r}: {nack.reason}; "
            "reconnect/resubmit is required"
        )

    def _apply(self, op: dict) -> None:
        kind = op["type"]
        if kind == "set":
            self.sequenced[op["key"]] = op["value"]
        elif kind == "delete":
            self.sequenced.pop(op["key"], None)
        elif kind == "clear":
            self.sequenced.clear()
        else:
            raise ValueError(f"unknown map op {kind}")

    # ----------------------------------------------------------------- views
    def get(self, key: str) -> Any:
        """Optimistic local read: pending ops mask the sequenced state."""
        for op in reversed(self._pending):
            if op["type"] == "clear":
                return None
            if op.get("key") == key:
                return op["value"] if op["type"] == "set" else None
        return self.sequenced.get(key)

    def keys(self) -> set[str]:
        """Optimistic key set."""
        out = set(self.sequenced)
        for op in self._pending:  # in issue order
            if op["type"] == "set":
                out.add(op["key"])
            elif op["type"] == "delete":
                out.discard(op["key"])
            else:  # clear
                out.clear()
        return out

    def items(self) -> dict[str, Any]:
        return {k: self.get(k) for k in self.keys()}
