"""The port's own copy of ``fluidframework_tpu/runtime/pending_state.py`` (no JAX in it).

PendingStateManager: local-op bookkeeping across sequencing and reconnect.

Reference parity: container-runtime/src/pendingStateManager.ts:283 —
tracks every flushed-but-unsequenced runtime message with its local
metadata; when the client's own messages come back sequenced, zips the
stored metadata onto them (processInboundMessages, containerRuntime.ts:3280);
on reconnect, replays the whole pending list through per-channel resubmit
(replayPendingStates, run only after catch-up so in-flight ops from the old
connection identity ack normally first); serializes to a stash for offline
resume (initialMessages, pendingStateManager.ts:291).

Batch ids are preserved across resubmission (derived from the ORIGINAL
flush identity, pendingStateManager.ts:476-492) so container forks are
detectable: a rehydrated twin resubmitting the same stash produces batches
with identical ids under a different client id.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

from .errors import DataProcessingError
from .op_lifecycle import BatchMessage


@dataclass
class PendingMessage:
    contents: dict[str, Any]
    local_metadata: Any
    batch_id: str
    # Connection identity the message was flushed under ("" if never sent —
    # stashed ops awaiting first submission).
    client_id: str


class PendingStateManager:
    def __init__(self) -> None:
        self._pending: list[PendingMessage] = []

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def head_client_id(self) -> str | None:
        return self._pending[0].client_id if self._pending else None

    def pending_batch_ids(self) -> set[str]:
        return {p.batch_id for p in self._pending}

    # ----------------------------------------------------------------- flush
    def on_flush_batch(
        self, messages: list[BatchMessage], batch_id: str, client_id: str
    ) -> None:
        for m in messages:
            self._pending.append(
                PendingMessage(m.contents, m.local_metadata, batch_id, client_id)
            )

    # --------------------------------------------------------------- inbound
    def match_inbound(self, contents: dict[str, Any]) -> Any:
        """Pop the head pending message for an own sequenced op; returns its
        local metadata. Mismatched content means a forked/corrupt op stream —
        fail fast (the reference closes the container with a
        DataProcessingError)."""
        if not self._pending:
            raise DataProcessingError(
                "own op sequenced but no pending message recorded"
            )
        head = self._pending.pop(0)
        if head.contents != contents:
            raise DataProcessingError(
                "pending state mismatch: sequenced own op does not match the "
                f"next pending message (expected {head.contents!r}, got {contents!r})"
            )
        return head.local_metadata

    # ------------------------------------------------------------- reconnect
    def restore(self, messages: list[PendingMessage]) -> None:
        """Put taken-but-not-replayed messages back verbatim (a replay
        aborted by a connection failure re-stages the untouched tail)."""
        self._pending.extend(messages)

    def take_pending_for_replay(self) -> list[list[PendingMessage]]:
        """Remove and return all pending messages grouped by original batch
        (order preserved); the caller re-stages each group through channel
        resubmit and flushes it under the ORIGINAL batch id."""
        pending, self._pending = self._pending, []
        groups: list[list[PendingMessage]] = []
        for p in pending:
            if groups and groups[-1][0].batch_id == p.batch_id:
                groups[-1].append(p)
            else:
                groups.append([p])
        return groups

    # ------------------------------------------------------------------ stash
    def add_stashed(
        self,
        contents: dict[str, Any],
        local_metadata: Any,
        batch_id: str,
        client_id: str = "",
    ) -> None:
        self._pending.append(
            PendingMessage(contents, local_metadata, batch_id, client_id)
        )

    def get_local_state(self, ref_seq: int) -> str:
        """Serialize pending messages for offline stash. Metadata is dropped:
        stashed ops are re-applied via apply_stashed on rehydrate, which
        regenerates it (the reference's applyStashedOp contract). ``ref_seq``
        records the sequence number the pending state is relative to, so
        rehydration can apply the stash at the exact same point in the
        op stream (ref applyStashedOpsAt). ``clientId`` records the identity
        each entry was flushed under ("" = never sent): rehydration uses it
        to recognize stashed ops that were ALREADY sequenced before the
        stash was taken (ref savedOps matching in pendingStateManager.ts)."""
        return json.dumps(
            {
                "refSeq": ref_seq,
                "pending": [
                    {
                        "contents": p.contents,
                        "batchId": p.batch_id,
                        "clientId": p.client_id,
                    }
                    for p in self._pending
                ],
            }
        )

    @staticmethod
    def parse_local_state(state: str) -> dict[str, Any]:
        return json.loads(state)
