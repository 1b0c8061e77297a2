"""Test-facing wrapper running the REAL network plane in-process.

A port of ``fluidframework_tpu/testing/network_env.py`` (no JAX in it).

``NetworkTestService`` exposes the same surface tests use on
``LocalService`` (``document()`` for introspection, ``process_all()`` for
deterministic delivery), but every byte actually crosses TCP/HTTP sockets
through the nexus/alfred fronts (server/netserver.py) and the network
driver (driver/network_driver.py).  ``process_all`` maps to driver
``sync_all`` — repeated server-echoed sync markers, no sleeps.
"""

from __future__ import annotations

from ..driver.network_driver import NetworkDocumentServiceFactory
from ..server.netserver import ServicePlane


class NetworkTestService:
    def __init__(self, token_provider=None) -> None:
        self.plane = ServicePlane().start()
        self.factory = NetworkDocumentServiceFactory(
            "127.0.0.1",
            self.plane.nexus.port,
            self.plane.http.port,
            token_provider=token_provider,
        )

    # ------------------------------------------------- LocalService surface
    def document(self, doc_id: str):
        """Server-side introspection (safe once process_all has quiesced)."""
        return self.plane.service.document(doc_id)

    def process_all(self) -> int:
        return self.factory.sync_all()

    def enable_auth(self, *a, **kw):
        return self.plane.service.enable_auth(*a, **kw)

    def close(self) -> None:
        for conn in self.factory.live_connections:
            conn.disconnect()
        self.plane.stop()
