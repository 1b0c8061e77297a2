"""The port's own copy of ``fluidframework_tpu/framework/oldest_client.py`` (no JAX in it).

Oldest-client observer: deterministic leader hint from the quorum.

Reference parity: packages/framework/oldest-client-observer — every client
computes "am I the oldest (earliest-joined) write client?" from the quorum;
used to elect one client for singleton duties without extra coordination
(the SummaryManager uses the same rule internally)."""

from __future__ import annotations


class OldestClientObserver:
    def __init__(self, runtime) -> None:
        self._runtime = runtime

    @property
    def oldest_client_id(self) -> str | None:
        q = self._runtime.quorum_table
        return min(q, key=lambda cid: q[cid]) if q else None

    def is_oldest(self) -> bool:
        return (
            self._runtime.joined
            and self.oldest_client_id == self._runtime.client_id
        )
