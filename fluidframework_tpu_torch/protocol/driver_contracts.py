"""The port's own copy of ``fluidframework_tpu/protocol/driver_contracts.py`` (no JAX in it).

Driver/service abstraction contracts (ref packages/common/driver-definitions).

The loader talks only to these interfaces; concrete drivers bind them to a
transport (in-memory local service, the TCP/HTTP network driver).  Error
taxonomy mirrors the reference's DriverError categories enough for retry
logic (can_retry).

Moved here from ``driver.definitions`` (which re-exports for callers):
the reference keeps driver-definitions in a low contracts tier precisely
so the runtime can name ``DriverError`` without an upward edge into the
driver layer — same treatment the channel contracts got with
``protocol.channel``.
"""

from __future__ import annotations

from typing import Any, Callable

from .messages import Nack, SequencedMessage, SignalMessage


class DriverError(Exception):
    """Driver-layer failure (ref IDriverErrorBase): carries retryability."""

    def __init__(self, message: str, can_retry: bool = True) -> None:
        super().__init__(message)
        self.can_retry = can_retry


class AuthRejection(Exception):
    """Connection-admission rejection contract: a service's auth layer
    raises a subclass of this (``server.auth.AuthError``), and drivers map
    it to a non-retryable ``DriverError`` without importing the service
    tier — the driver->server interface split."""


class DeltaConnection:
    """A live ordered-op stream connection (ref IDocumentDeltaConnection).

    ``join_msg`` is the ticketed join for write connections (None for read).
    ``checkpoint_seq`` is the newest seq already broadcast before this
    connection opened — the gap [last_known+1, checkpoint_seq] must be
    fetched from delta storage; everything above arrives via the listener.
    """

    client_id: str
    mode: str  # "write" | "read"
    join_msg: SequencedMessage | None
    checkpoint_seq: int

    def submit(self, message: Any) -> None:
        raise NotImplementedError

    def submit_signal(self, content: Any) -> None:
        raise NotImplementedError

    def disconnect(self) -> None:
        raise NotImplementedError

    @property
    def connected(self) -> bool:
        raise NotImplementedError


class DeltaStorageService:
    """Historical sequenced-op reads (ref IDocumentDeltaStorageService)."""

    def get_deltas(self, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        """Inclusive range; may return fewer (caller re-requests)."""
        raise NotImplementedError


class StorageService:
    """Snapshot/blob storage (ref IDocumentStorageService)."""

    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        raise NotImplementedError

    def write_snapshot(self, seq: int, summary: dict) -> None:
        raise NotImplementedError

    def upload_blob_content(self, content: str) -> str:
        """Content-addressed attachment blob upload; returns the blob id."""
        raise NotImplementedError

    def read_blob_content(self, blob_id: str) -> str:
        raise NotImplementedError

    def upload_summary(self, summary_tree: dict) -> str:
        """Stage an ISummaryTree upload; returns the handle a summarize op
        carries (ref uploadSummaryWithContext)."""
        raise NotImplementedError

    def get_versions(self, max_count: int = 5) -> list[dict]:
        """Newest-first snapshot version descriptors ({id, seq}; ref
        IDocumentStorageService.getVersions)."""
        raise NotImplementedError

    def get_snapshot_version(self, version_id: str) -> tuple[int, dict] | None:
        """A specific stored snapshot version (ref getSnapshotTree with a
        version header)."""
        raise NotImplementedError


class DocumentService:
    """One document's service endpoints (ref IDocumentService)."""

    def connect_to_delta_stream(
        self,
        client_id: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
    ) -> DeltaConnection:
        raise NotImplementedError

    def connect_to_delta_storage(self) -> DeltaStorageService:
        raise NotImplementedError

    def connect_to_storage(self) -> StorageService:
        raise NotImplementedError


class DocumentServiceFactory:
    """Resolves a document id to its service (ref IDocumentServiceFactory)."""

    def create_document_service(self, doc_id: str) -> DocumentService:
        raise NotImplementedError
