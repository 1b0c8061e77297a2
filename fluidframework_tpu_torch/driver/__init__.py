"""Driver layer: the service abstraction between loader and ordering service.

A port of ``fluidframework_tpu/driver/__init__.py`` (no JAX in it).

Reference parity: packages/common/driver-definitions (IDocumentServiceFactory
/ IDocumentService / IDocumentDeltaConnection / IDocumentStorageService /
IDocumentDeltaStorageService) + packages/drivers/local-driver.  The network
driver is ``driver.network_driver``; the reference's ``virtual_storage``
names (prefetch, snapshot cache, throttling retry) are not ported (ROADMAP
queue 1).
"""

from .definitions import (
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)
from .local_driver import LocalDocumentServiceFactory

__all__ = [
    "DeltaConnection",
    "DeltaStorageService",
    "DocumentService",
    "DocumentServiceFactory",
    "DriverError",
    "LocalDocumentServiceFactory",
    "StorageService",
]
