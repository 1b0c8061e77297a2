"""The port's own copy of ``fluidframework_tpu/runtime/snapshot_formats.py`` (no JAX in it).

Versioned DDS snapshot formats — re-export shim.

The format registry moved to ``protocol.snapshot_formats`` (the contracts
tier), so DDS summarize paths can stamp/upgrade without an upward edge
into the runtime.  The datastore and the corpus tooling keep importing
from here.
"""

from __future__ import annotations

from ..protocol.snapshot_formats import (
    CURRENT_FORMATS,
    FORMAT_KEY,
    UPGRADERS,
    current_format,
    upgrade,
)

__all__ = [
    "CURRENT_FORMATS",
    "FORMAT_KEY",
    "UPGRADERS",
    "current_format",
    "upgrade",
]
