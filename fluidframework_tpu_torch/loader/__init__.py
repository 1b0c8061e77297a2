"""Loader layer: container lifecycle, delta stream pump, connection state.

A port of ``fluidframework_tpu/loader/__init__.py`` (no JAX in it).

Reference parity: packages/loader/container-loader — Container (load/attach/
close), DeltaManager (inbound ordering + gap fetch), ConnectionManager
(reconnect, read/write modes), ProtocolHandler (quorum join/leave/propose).
"""

from .connection_manager import ConnectionManager
from .container import Container
from .delta_manager import DeltaManager
from .protocol import ProtocolHandler, Quorum

__all__ = [
    "ConnectionManager",
    "Container",
    "DeltaManager",
    "ProtocolHandler",
    "Quorum",
]
