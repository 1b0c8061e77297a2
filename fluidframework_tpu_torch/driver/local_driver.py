"""In-memory driver binding the service abstraction to LocalService.

A port of ``fluidframework_tpu/driver/local_driver.py`` (no JAX in it).

Reference parity: packages/drivers/local-driver — LocalDocumentServiceFactory
/ LocalDocumentService / LocalDeltaStorageService wrapping
LocalDeltaConnectionServer. The test backbone: full loader+runtime stacks
drive the in-process deli pipeline through exactly the interfaces a
networked driver would implement.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

from ..protocol.messages import Nack, SequencedMessage, SignalMessage, UnsequencedMessage
from .definitions import (
    AuthRejection,
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)

if TYPE_CHECKING:
    # Annotation-only: the driver binds to whatever service the registry
    # (driver.service_registry) resolved; the per-document backend surface
    # it wraps is LocalDocument's.  No runtime edge into the server tier.
    from ..server.local_service import LocalDocument, LocalService


class LocalDeltaConnection(DeltaConnection):
    def __init__(
        self,
        doc: LocalDocument,
        client_id: str,
        mode: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None,
        signal_listener: Callable[[SignalMessage], None] | None,
        token: str | None = None,
    ) -> None:
        self._doc = doc
        self.client_id = client_id
        self.mode = mode
        self._connected = True

        def on_nack(nack: Nack) -> None:
            # A nack invalidates the connection (ref: server closes the
            # socket after a nack; client must reconnect).
            self.disconnect()
            if nack_listener is not None:
                nack_listener(nack)

        try:
            self.join_msg, self.checkpoint_seq = doc.connect_stream(
                client_id, listener, on_nack, mode=mode, token=token
            )
        except AuthRejection as e:
            raise DriverError(f"connection rejected: {e}", can_retry=False) from e
        if signal_listener is not None:
            doc.subscribe_signals(client_id, signal_listener)

    def submit(self, message: Any) -> None:
        if not self._connected:
            raise DriverError("submit on disconnected connection")
        if self.mode != "write":
            raise DriverError("read connection cannot submit ops", can_retry=False)
        assert isinstance(message, UnsequencedMessage)
        self._doc.submit(message)

    def submit_signal(self, content: Any) -> None:
        if not self._connected:
            raise DriverError("signal on disconnected connection")
        self._doc.submit_signal(self.client_id, content)

    def disconnect(self) -> None:
        if self._connected:
            self._connected = False
            self._doc.disconnect(self.client_id)

    @property
    def connected(self) -> bool:
        return self._connected


class LocalDeltaStorageService(DeltaStorageService):
    def __init__(self, doc: LocalDocument) -> None:
        self._doc = doc

    def get_deltas(self, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        return self._doc.ops_range(from_seq, to_seq)


class LocalStorageService(StorageService):
    def __init__(self, doc: LocalDocument) -> None:
        self._doc = doc

    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        return self._doc.latest_snapshot()

    def write_snapshot(self, seq: int, summary: dict) -> None:
        self._doc.save_snapshot(seq, summary)

    def upload_blob_content(self, content: str) -> str:
        return self._doc.upload_blob(content)

    def read_blob_content(self, blob_id: str) -> str:
        return self._doc.read_blob(blob_id)

    def upload_summary(self, summary_tree: dict) -> str:
        return self._doc.upload_summary(summary_tree)

    def get_versions(self, max_count: int = 5) -> list[dict]:
        return self._doc.snapshot_versions(max_count)

    def get_snapshot_version(self, version_id: str) -> tuple[int, dict] | None:
        return self._doc.snapshot_at(version_id)


class LocalDocumentService(DocumentService):
    def __init__(self, doc: LocalDocument, token_provider=None) -> None:
        self._doc = doc
        self._token_provider = token_provider

    def connect_to_delta_stream(
        self,
        client_id: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
    ) -> DeltaConnection:
        token = None
        if self._token_provider is not None:
            token = self._token_provider(self._doc.doc_id, client_id)
        return LocalDeltaConnection(
            self._doc, client_id, mode, listener, nack_listener, signal_listener,
            token=token,
        )

    def connect_to_delta_storage(self) -> DeltaStorageService:
        return LocalDeltaStorageService(self._doc)

    def connect_to_storage(self) -> StorageService:
        return LocalStorageService(self._doc)


class LocalDocumentServiceFactory(DocumentServiceFactory):
    def __init__(self, service: LocalService, token_provider=None) -> None:
        """``token_provider(doc_id, client_id) -> token`` supplies tenant
        credentials when the service enforces auth (riddler analog)."""
        self._service = service
        self._token_provider = token_provider

    def create_document_service(self, doc_id: str) -> DocumentService:
        return LocalDocumentService(
            self._service.document(doc_id), self._token_provider
        )
