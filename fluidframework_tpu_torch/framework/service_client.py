"""The port's own copy of ``fluidframework_tpu/framework/service_client.py`` (no JAX in it).

Service-client façade: create/get containers against a service.

Reference parity: packages/service-clients —
- ``TinyliciousClient``/``AzureClient`` (AzureClient.ts): createContainer /
  getContainer hiding loader+driver wiring behind a ContainerSchema,
  container services (audience), getContainerVersions, and
  viewContainerVersion (a paused, read-only container at a stored version);
- ``OdspClient``: the same surface over a virtualizing storage path.

Three deployment shapes share one base:
- ``LocalServiceClient`` — in-process service (unit tests, single process);
- ``NetworkServiceClient`` — a real service plane over TCP/HTTP with
  token-provider auth (the AzureClient/TinyliciousClient deployment shape);
- either with ``virtualize=True`` — storage reads/writes go through
  odsp-style snapshot virtualization with a persistent cache (OdspClient).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from ..driver.local_driver import LocalDocumentServiceFactory
from ..driver.service_registry import local_service_class
from ..driver.virtual_storage import VirtualizedDocumentServiceFactory
from .fluid_static import ContainerSchema, FluidContainer

if TYPE_CHECKING:
    from ..server.local_service import LocalService


class Audience:
    """Joined write clients of a container (ref IServiceAudience)."""

    def __init__(self, container) -> None:
        self._container = container

    def members(self) -> dict[str, int]:
        """client id -> join-order short id."""
        return self._container.runtime.quorum_table

    @property
    def my_id(self) -> str | None:
        return self._container.runtime.client_id


class _ServiceClientBase:
    """Shared create/get/version surface; subclasses supply the driver
    factory (the only thing that differs between deployments — the same
    swap the reference makes between Tinylicious/Azure/Odsp clients)."""

    def __init__(self, factory, virtualize: bool = False, cache_dir: str | None = None) -> None:
        self._factory = (
            VirtualizedDocumentServiceFactory(factory, cache_dir=cache_dir)
            if virtualize
            else factory
        )
        self._counter = 0

    # ------------------------------------------------------------- lifecycle
    def create_container(
        self, schema: ContainerSchema, doc_id: str, client_id: str = "creator"
    ) -> tuple[FluidContainer, dict[str, Any]]:
        fc = FluidContainer.create_detached(schema, client_id=client_id)
        fc.attach(doc_id, self._factory, client_id)
        return fc, self._services(fc)

    def get_container(
        self, doc_id: str, schema: ContainerSchema, client_id: str | None = None
    ) -> tuple[FluidContainer, dict[str, Any]]:
        if client_id is None:
            self._counter += 1
            client_id = f"client-{self._counter}"
        fc = FluidContainer.load(doc_id, self._factory, schema, client_id)
        return fc, self._services(fc)

    # -------------------------------------------------------------- versions
    def _storage(self, doc_id: str):
        return self._factory.create_document_service(doc_id).connect_to_storage()

    def get_container_versions(self, doc_id: str, max_count: int = 5) -> list[dict]:
        """Newest-first stored snapshot versions (ref getContainerVersions)."""
        return self._storage(doc_id).get_versions(max_count)

    def view_container_version(
        self, doc_id: str, schema: ContainerSchema, version_id: str
    ) -> FluidContainer:
        """Read-only container at a specific stored version, never
        connected (ref viewContainerVersion/loadContainerPaused)."""
        snap = self._storage(doc_id).get_snapshot_version(version_id)
        if snap is None:
            raise KeyError(f"no snapshot version {version_id!r} for {doc_id!r}")
        _seq, summary = snap
        return FluidContainer.view_version(schema, summary)

    def _services(self, fc: FluidContainer) -> dict[str, Any]:
        return {"audience": Audience(fc.container)}


class LocalServiceClient(_ServiceClientBase):
    """Client for the in-process service (ref TinyliciousClient shape; a
    networked deployment swaps the DocumentServiceFactory, nothing else)."""

    def __init__(
        self,
        service: LocalService | None = None,
        virtualize: bool = False,
        cache_dir: str | None = None,
    ) -> None:
        # Default service resolves through the provider seam
        # (driver.service_registry), not a direct server-tier import.
        self.service = service or local_service_class()()
        super().__init__(
            LocalDocumentServiceFactory(self.service),
            virtualize=virtualize,
            cache_dir=cache_dir,
        )


class NetworkServiceClient(_ServiceClientBase):
    """Client bound to a network service plane (ref AzureClient: endpoint +
    token provider; here host + nexus/alfred ports). ``sync()`` pumps the
    underlying connections to quiescence — the deterministic stand-in for
    background dispatch."""

    def __init__(
        self,
        host: str,
        port: int,
        http_port: int,
        token_provider=None,
        virtualize: bool = False,
        cache_dir: str | None = None,
    ) -> None:
        from ..driver.network_driver import NetworkDocumentServiceFactory

        self.network_factory = NetworkDocumentServiceFactory(
            host, port, http_port, token_provider=token_provider
        )
        super().__init__(
            self.network_factory, virtualize=virtualize, cache_dir=cache_dir
        )

    def sync(self) -> int:
        return self.network_factory.sync_all()
