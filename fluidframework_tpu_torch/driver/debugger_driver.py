"""Debugger driver: an interposing document service for op-by-op replay.

Reference parity: packages/drivers/debugger (FluidDebugger.createFromService
/ createFromServiceFactory + DebugReplayController): wraps any document
service so inbound sequenced ops are HELD by a controller and released
under debugger control — step N ops, play to a sequence number, or resume
live pass-through. The controller here is programmatic (the reference pops
a debugger window; same control surface, no UI). Optionally starts from
no snapshot so the whole history replays through the debugger.

A port of ``fluidframework_tpu/driver/debugger_driver.py`` (no JAX in it).
Each released op reaches the container as the live stream's would, so a
string backed by ``KernelMergeTree`` on the card applies each stepped op
as one launch of its one-document program.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import Nack, SequencedMessage, SignalMessage
from .definitions import (
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    StorageService,
)


class DebugController:
    """Holds inbound ops; releases them on command (DebugReplayController).

    Modes: paused (default) buffers everything; live passes through.
    ``step``/``play_to_seq`` release from the buffer in order."""

    def __init__(self, start_paused: bool = True) -> None:
        self.paused = start_paused
        # Each held entry is (listener, msg): an op arriving on one
        # connection's stream is delivered only to THAT connection's
        # listener — sharing a controller across connections must not
        # fan each op out to every sink.
        self._buffer: list[tuple[Callable[[SequencedMessage], None], SequencedMessage]] = []
        self.released = 0

    # ----------------------------------------------------------- wiring
    def _on_op(
        self, sink: Callable[[SequencedMessage], None], msg: SequencedMessage
    ) -> None:
        if self.paused:
            self._buffer.append((sink, msg))
        else:
            self._deliver(sink, msg)

    def _deliver(
        self, sink: Callable[[SequencedMessage], None], msg: SequencedMessage
    ) -> None:
        self.released += 1
        sink(msg)

    # ---------------------------------------------------------- control
    @property
    def pending(self) -> int:
        return len(self._buffer)

    def next_seq(self) -> int | None:
        return self._buffer[0][1].seq if self._buffer else None

    def step(self, n: int = 1) -> int:
        """Release up to n buffered ops; returns how many were released."""
        released = 0
        while self._buffer and released < n:
            self._deliver(*self._buffer.pop(0))
            released += 1
        return released

    def play_to_seq(self, seq: int) -> int:
        """Release every buffered op with seq <= the target."""
        released = 0
        while self._buffer and self._buffer[0][1].seq <= seq:
            self._deliver(*self._buffer.pop(0))
            released += 1
        return released

    def resume(self) -> None:
        """Drain the buffer and go live (pass-through)."""
        self.paused = False
        while self._buffer:
            self._deliver(*self._buffer.pop(0))

    def pause(self) -> None:
        self.paused = True


class _DebugConnection(DeltaConnection):
    def __init__(self, inner: DeltaConnection, controller: DebugController) -> None:
        self._inner = inner
        self._controller = controller
        self.client_id = inner.client_id
        self.mode = inner.mode
        self.join_msg = inner.join_msg
        self.checkpoint_seq = inner.checkpoint_seq

    def submit(self, message: Any) -> None:
        self._inner.submit(message)

    def submit_signal(self, content: Any) -> None:
        self._inner.submit_signal(content)

    def disconnect(self) -> None:
        self._inner.disconnect()

    @property
    def connected(self) -> bool:
        return self._inner.connected


class _EmptyStorage(StorageService):
    """No-snapshot start: the debugger replays history from seq 0
    (the reference's 'start with any snapshot' choice)."""

    def __init__(self, inner: StorageService) -> None:
        self._inner = inner

    def get_latest_snapshot(self):
        return None

    def write_snapshot(self, seq: int, summary: dict) -> None:
        self._inner.write_snapshot(seq, summary)

    def upload_blob_content(self, content: str) -> str:
        return self._inner.upload_blob_content(content)

    def read_blob_content(self, blob_id: str) -> str:
        return self._inner.read_blob_content(blob_id)

    def upload_summary(self, summary_tree: dict) -> str:
        return self._inner.upload_summary(summary_tree)

    def get_versions(self, max_count: int = 5) -> list[dict]:
        return self._inner.get_versions(max_count)

    def get_snapshot_version(self, version_id: str) -> tuple[int, dict] | None:
        return self._inner.get_snapshot_version(version_id)


class DebuggerDocumentService(DocumentService):
    def __init__(
        self,
        inner: DocumentService,
        controller: DebugController,
        from_snapshot: bool = True,
    ) -> None:
        self._inner = inner
        self.controller = controller
        self._from_snapshot = from_snapshot

    def connect_to_delta_stream(
        self,
        client_id: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
    ) -> DeltaConnection:
        controller = self.controller
        conn = self._inner.connect_to_delta_stream(
            client_id,
            lambda msg: controller._on_op(listener, msg),
            nack_listener,
            signal_listener,
            mode=mode,
        )
        return _DebugConnection(conn, self.controller)

    def connect_to_delta_storage(self) -> DeltaStorageService:
        return self._inner.connect_to_delta_storage()

    def connect_to_storage(self) -> StorageService:
        storage = self._inner.connect_to_storage()
        return storage if self._from_snapshot else _EmptyStorage(storage)


class DebuggerDocumentServiceFactory(DocumentServiceFactory):
    """Wrap a factory so every created service is debugger-interposed; the
    per-document controllers are exposed for the host to drive."""

    def __init__(self, inner: DocumentServiceFactory, from_snapshot: bool = True) -> None:
        self._inner = inner
        self._from_snapshot = from_snapshot
        self.controllers: dict[str, DebugController] = {}

    def controller_for(self, doc_id: str) -> DebugController:
        if doc_id not in self.controllers:
            self.controllers[doc_id] = DebugController()
        return self.controllers[doc_id]

    def create_document_service(self, doc_id: str) -> DocumentService:
        return DebuggerDocumentService(
            self._inner.create_document_service(doc_id),
            self.controller_for(doc_id),
            from_snapshot=self._from_snapshot,
        )
