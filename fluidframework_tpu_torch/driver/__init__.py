"""Driver layer: the service abstraction between loader and ordering service.

A port of ``fluidframework_tpu/driver/__init__.py`` (no JAX in it).  The network
driver is ``driver.network_driver``; the replay, file and fault-injection
drivers are ``driver.replay_driver`` and ``driver.fault_injection``.

Reference parity: packages/common/driver-definitions (IDocumentServiceFactory
/ IDocumentService / IDocumentDeltaConnection / IDocumentStorageService /
IDocumentDeltaStorageService) + packages/drivers/local-driver.
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
from .virtual_storage import (
    PrefetchStorageService,
    SnapshotCache,
    ThrottlingError,
    VirtualizedDocumentServiceFactory,
    VirtualizedStorageService,
    run_with_retry,
)

__all__ = [
    "DeltaConnection",
    "DeltaStorageService",
    "DocumentService",
    "DocumentServiceFactory",
    "DriverError",
    "LocalDocumentServiceFactory",
    "PrefetchStorageService",
    "SnapshotCache",
    "StorageService",
    "ThrottlingError",
    "VirtualizedDocumentServiceFactory",
    "VirtualizedStorageService",
    "run_with_retry",
]
