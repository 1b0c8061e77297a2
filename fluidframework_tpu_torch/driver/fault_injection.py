"""Fault-injection driver decorator: wrap any driver, inject failures.

A port of ``fluidframework_tpu/driver/fault_injection.py`` (no JAX in it).

Reference parity: test-service-load's FaultInjectionDocumentServiceFactory
(packages/test/test-service-load/src/faultInjectionDriver.ts:40) — a
decorator over a REAL driver whose connections expose ``injectNack``
(:294), ``injectError`` (:309), and ``injectDisconnect`` (:327), so stress
runs exercise the host's recovery machinery (reconnect, backoff, pending
replay) against deterministic failures instead of waiting for real ones.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import Nack, SequencedMessage, SignalMessage
from .definitions import (
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)


class FaultInjectionConnection(DeltaConnection):
    """Delegating connection with injectable failures."""

    def __init__(
        self,
        inner: DeltaConnection,
        nack_listener: Callable[[Nack], None] | None,
    ) -> None:
        self._inner = inner
        self._nack_listener = nack_listener
        self._error_armed: bool | None = None  # None = disarmed, else can_retry
        self.client_id = inner.client_id
        self.mode = inner.mode
        self.join_msg = inner.join_msg
        self.checkpoint_seq = inner.checkpoint_seq

    # ------------------------------------------------------------- injection
    def inject_nack(self, reason: str = "injected nack") -> None:
        """Synthesize a server nack: tears the connection down, then fires
        the nack listener — exactly the real nack path (:294)."""
        nack = Nack(client_id=self.client_id, client_seq=0, reason=reason)
        self._inner.disconnect()
        if self._nack_listener is not None:
            self._nack_listener(nack)

    def inject_error(self, can_retry: bool = True) -> None:
        """Arm a one-shot submit failure with the given retryability (:309)."""
        self._error_armed = can_retry

    def inject_disconnect(self) -> None:
        """Synthetic socket drop (:327): the connection dies without a
        leave handshake; the host discovers on its next use."""
        self._inner.disconnect()

    # ------------------------------------------------------------- delegate
    def submit(self, message: Any) -> None:
        if self._error_armed is not None:
            can_retry, self._error_armed = self._error_armed, None
            raise DriverError("injected submit error", can_retry=can_retry)
        self._inner.submit(message)

    def submit_signal(self, content: Any) -> None:
        self._inner.submit_signal(content)

    def disconnect(self) -> None:
        self._inner.disconnect()

    @property
    def connected(self) -> bool:
        return self._inner.connected


class FaultInjectionDocumentService(DocumentService):
    def __init__(self, factory: "FaultInjectionDocumentServiceFactory", inner: DocumentService) -> None:
        self._factory = factory
        self._inner = inner

    def connect_to_delta_stream(
        self,
        client_id: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
    ) -> DeltaConnection:
        inner = self._inner.connect_to_delta_stream(
            client_id, listener, nack_listener, signal_listener, mode=mode
        )
        conn = FaultInjectionConnection(inner, nack_listener)
        self._factory.connections.append(conn)
        return conn

    def connect_to_delta_storage(self) -> DeltaStorageService:
        return self._inner.connect_to_delta_storage()

    def connect_to_storage(self) -> StorageService:
        return self._inner.connect_to_storage()


class FaultInjectionDocumentServiceFactory(DocumentServiceFactory):
    """Decorator factory (:40): every connection it hands out is
    injectable; ``connections`` lists them newest-last for the stress
    harness to pick victims from."""

    def __init__(self, inner: DocumentServiceFactory) -> None:
        self._inner = inner
        self.connections: list[FaultInjectionConnection] = []

    def create_document_service(self, doc_id: str) -> DocumentService:
        return FaultInjectionDocumentService(
            self, self._inner.create_document_service(doc_id)
        )

    def live(self) -> list[FaultInjectionConnection]:
        self.connections = [c for c in self.connections if c.connected]
        return self.connections
