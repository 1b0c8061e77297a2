"""The port's own copy of ``fluidframework_tpu/framework/attributor.py`` (no JAX in it).

Attributor: who-wrote-what, derived from the op stream.

Reference parity: packages/framework/attributor — ``OpStreamAttributor``
(src/attributor.ts:87) maps sequence numbers to {user, timestamp} as ops are
processed, and the summary codecs (src/encoders.ts, lz4Encoder.ts) compress
the table with client-id interning plus timestamp delta-encoding before it
rides a summary blob. DDSes store attribution KEYS (seq numbers) — e.g.
merge-tree segments already carry their insert/remove stamps — and resolve
them through this table.
"""

from __future__ import annotations

from typing import Any


class OpStreamAttributor:
    """seq -> {client, timestamp} for every sequenced op observed."""

    def __init__(self) -> None:
        # seq -> (client, timestamp in INTEGER ms): one quantization, done
        # at record time — re-deriving ms from a float at summarize time
        # can disagree with the stored value by 1ms (float truncation), so
        # the integer IS the stored truth everywhere.
        self._entries: dict[int, tuple[str, int]] = {}

    def record(self, seq: int, client_id: str, timestamp: float) -> None:
        self._entries[seq] = (client_id, int(timestamp * 1000))

    def observe(self, msg) -> None:
        """Feed one SequencedMessage (wire shape)."""
        self.record(msg.seq, msg.client_id, msg.timestamp or 0.0)

    def get(self, seq: int) -> dict[str, Any] | None:
        e = self._entries.get(seq)
        return {"client": e[0], "timestamp": e[1] / 1000} if e else None

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------ summary
    def summarize(self) -> dict:
        """Interned + delta-encoded table (ref encoders.ts: string interning
        for client ids, delta encoding for timestamps/seqs — the dominant
        size terms in long sessions)."""
        seqs = sorted(self._entries)
        clients: list[str] = []
        index: dict[str, int] = {}
        seq_deltas: list[int] = []
        client_ids: list[int] = []
        ts_deltas: list[int] = []
        prev_seq = 0
        prev_ts = 0
        for s in seqs:
            client, ts_ms = self._entries[s]
            if client not in index:
                index[client] = len(clients)
                clients.append(client)
            seq_deltas.append(s - prev_seq)
            prev_seq = s
            ts_deltas.append(ts_ms - prev_ts)
            prev_ts = ts_ms
            client_ids.append(index[client])
        return {
            "clients": clients,
            "seqDeltas": seq_deltas,
            "clientIdx": client_ids,
            "tsDeltas": ts_deltas,
        }

    def load(self, data: dict) -> None:
        self._entries = {}
        seq = 0
        ts_ms = 0
        for d_seq, ci, d_ts in zip(
            data["seqDeltas"], data["clientIdx"], data["tsDeltas"]
        ):
            seq += d_seq
            ts_ms += d_ts
            self._entries[seq] = (data["clients"][ci], ts_ms)

    def trim(self, min_seq: int) -> None:
        """Drop entries at or below the collab-window floor — a HOST POLICY
        hook, deliberately not automatic: attribution keys on long-lived
        content reference arbitrarily old seqs, so the default (like the
        reference's attributor) retains the full table and lets summaries
        carry it; hosts that only need in-window attribution bound memory
        here."""
        self._entries = {s: e for s, e in self._entries.items() if s > min_seq}
