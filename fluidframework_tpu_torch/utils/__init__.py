"""Cross-cutting utilities: distributed ID compression, telemetry, config.

The exports are the reference ``fluidframework_tpu/utils/__init__.py``'s.
Reference parity: packages/runtime/id-compressor, packages/utils/
telemetry-utils, packages/common/core-interfaces config contracts.
"""

from .config import CachedConfigProvider, ConfigTypes, MonitoringContext
from .id_compressor import IdCompressor, IdCreationRange
from .telemetry import (
    Histogram,
    Logger,
    PerformanceEvent,
    SampledTelemetryHelper,
    create_child_logger,
)

__all__ = [
    "CachedConfigProvider",
    "ConfigTypes",
    "Histogram",
    "IdCompressor",
    "IdCreationRange",
    "Logger",
    "MonitoringContext",
    "PerformanceEvent",
    "SampledTelemetryHelper",
    "create_child_logger",
]
