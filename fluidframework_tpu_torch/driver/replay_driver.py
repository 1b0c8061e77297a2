"""Replay and file drivers: boot containers from recorded histories.

A port of ``fluidframework_tpu/driver/replay_driver.py`` (no JAX in it).

Reference parity:
- ``replay-driver`` (packages/drivers/replay-driver): a read-only document
  service that replays the stored op log through the normal inbound path up
  to a target sequence number — the backbone of the replay tool and
  time-travel debugging.
- ``file-driver`` (packages/drivers/file-driver): snapshot + ops serialized
  to a plain file; load offline, no service.
- debugger-style interposition is covered by the storage/connection
  adapters accepting any underlying service.
"""

from __future__ import annotations

import json
from typing import Any, Callable

from ..protocol.messages import SequencedMessage
from .definitions import (
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)


class _StaticDeltaStorage(DeltaStorageService):
    def __init__(self, ops: list[SequencedMessage]) -> None:
        self._ops = sorted(ops, key=lambda m: m.seq)

    def get_deltas(self, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        return [m for m in self._ops if from_seq <= m.seq <= to_seq]


class _StaticStorage(StorageService):
    def __init__(self, snapshot: tuple[int, dict] | None) -> None:
        self._snapshot = snapshot

    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        return self._snapshot

    def write_snapshot(self, seq: int, summary: dict) -> None:
        raise DriverError("replay storage is read-only", can_retry=False)

    def upload_summary(self, summary_tree: dict) -> str:
        raise DriverError("replay storage is read-only", can_retry=False)


class _ReplayConnection(DeltaConnection):
    """Read-only 'connection': pushes the recorded ops through the listener
    up to the replay target; never joins the quorum, never submits."""

    def __init__(self, ops: list[SequencedMessage], listener, to_seq: int | None):
        self.client_id = "__replay__"
        self.mode = "read"
        self.join_msg = None
        self.checkpoint_seq = 0
        self._connected = True
        self._listener = listener
        self._ops = [m for m in ops if to_seq is None or m.seq <= to_seq]
        self._cursor = 0

    def replay_to(self, seq: int | None = None) -> int:
        """Deliver recorded ops up to ``seq`` (all if None); returns count."""
        n = 0
        while self._cursor < len(self._ops):
            m = self._ops[self._cursor]
            if seq is not None and m.seq > seq:
                break
            self._listener(m)
            self._cursor += 1
            n += 1
        return n

    def submit(self, message: Any) -> None:
        raise DriverError("replay connection cannot submit ops", can_retry=False)

    def submit_signal(self, content: Any) -> None:
        raise DriverError("replay connection cannot signal", can_retry=False)

    def disconnect(self) -> None:
        self._connected = False

    @property
    def connected(self) -> bool:
        return self._connected


class ReplayDocumentService(DocumentService):
    """Serves one recorded document history (ref ReplayDocumentService)."""

    def __init__(
        self,
        ops: list[SequencedMessage],
        snapshot: tuple[int, dict] | None = None,
        to_seq: int | None = None,
    ) -> None:
        self._ops = sorted(ops, key=lambda m: m.seq)
        self._snapshot = snapshot
        self._to_seq = to_seq
        self.connections: list[_ReplayConnection] = []

    def connect_to_delta_stream(
        self, client_id, listener, nack_listener=None, signal_listener=None,
        mode: str = "read",
    ) -> DeltaConnection:
        if mode != "read":
            raise DriverError("replay documents are read-only", can_retry=False)
        conn = _ReplayConnection(self._ops, listener, self._to_seq)
        self.connections.append(conn)
        return conn

    def connect_to_delta_storage(self) -> DeltaStorageService:
        return _StaticDeltaStorage(self._ops)

    def connect_to_storage(self) -> StorageService:
        return _StaticStorage(self._snapshot)


class ReplayDocumentServiceFactory(DocumentServiceFactory):
    """Replays any live service's recorded history (ref replay-driver
    wrapping a real driver's delta storage)."""

    def __init__(
        self,
        history_fn: Callable[[str], tuple[list[SequencedMessage], tuple[int, dict] | None]],
        to_seq: int | None = None,
    ) -> None:
        self._history = history_fn
        self._to_seq = to_seq

    @staticmethod
    def from_local_service(service, to_seq: int | None = None) -> "ReplayDocumentServiceFactory":
        def history(doc_id: str):
            doc = service.document(doc_id)
            return list(doc.sequencer.log), doc.latest_snapshot()

        return ReplayDocumentServiceFactory(history, to_seq)

    def create_document_service(self, doc_id: str) -> ReplayDocumentService:
        ops, snapshot = self._history(doc_id)
        return ReplayDocumentService(ops, snapshot, self._to_seq)


# ---------------------------------------------------------------------------
# file driver
# ---------------------------------------------------------------------------


def save_document_file(path: str, ops: list[SequencedMessage], snapshot: tuple[int, dict] | None) -> None:
    """Serialize a document history to one JSON file (ref file-driver)."""
    data = {
        "snapshot": None if snapshot is None else [snapshot[0], snapshot[1]],
        "ops": [
            {
                "clientId": m.client_id,
                "clientSeq": m.client_seq,
                "refSeq": m.ref_seq,
                "seq": m.seq,
                "minSeq": m.min_seq,
                "type": m.type,
                "contents": m.contents,
                "metadata": m.metadata,
                "short": m.short_client,
            }
            for m in ops
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def load_document_file(path: str) -> tuple[list[SequencedMessage], tuple[int, dict] | None]:
    with open(path) as f:
        data = json.load(f)
    ops = [
        SequencedMessage(
            client_id=e["clientId"],
            client_seq=e["clientSeq"],
            ref_seq=e["refSeq"],
            seq=e["seq"],
            min_seq=e["minSeq"],
            type=e["type"],
            contents=e["contents"],
            metadata=e["metadata"],
            timestamp=0.0,
            short_client=e["short"],
        )
        for e in data["ops"]
    ]
    snap = data["snapshot"]
    return ops, None if snap is None else (snap[0], snap[1])


class FileDocumentServiceFactory(DocumentServiceFactory):
    """Read-only boot from a saved document file (ref file-driver)."""

    def __init__(self, path: str, to_seq: int | None = None) -> None:
        self._path = path
        self._to_seq = to_seq

    def create_document_service(self, doc_id: str) -> ReplayDocumentService:
        ops, snapshot = load_document_file(self._path)
        return ReplayDocumentService(ops, snapshot, self._to_seq)
