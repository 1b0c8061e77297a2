"""Service abstraction contracts — re-export shim.

A port of ``fluidframework_tpu/driver/definitions.py`` (no JAX in it).

The contract classes moved to ``protocol.driver_contracts`` (the
contracts tier), so the runtime can name ``DriverError`` without an
upward edge into this layer — the same treatment the channel contracts
got with ``protocol.channel``.  Drivers and the loader keep importing
from here; the definitions ARE the driver-definitions package's surface
(ref packages/common/driver-definitions).
"""

from __future__ import annotations

from ..protocol.driver_contracts import (
    AuthRejection,
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)

__all__ = [
    "AuthRejection",
    "DeltaConnection",
    "DeltaStorageService",
    "DocumentService",
    "DocumentServiceFactory",
    "DriverError",
    "StorageService",
]
