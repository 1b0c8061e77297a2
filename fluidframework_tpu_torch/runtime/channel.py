"""The port's own copy of ``fluidframework_tpu/runtime/channel.py`` (no JAX in it).

Compatibility shim: the channel contract moved DOWN to
``protocol.channel`` (base layer) so DDS modules import it without an
upward edge — the same move Fluid made keeping datastore-definitions in
its contracts tier (fftpu-check rule ``layer-upward-import``).  Existing
``runtime.channel`` importers keep working through this re-export.
"""

from ..protocol.channel import (  # noqa: F401
    Channel,
    ChannelDeltaConnection,
    ChannelFactory,
    ChannelMessage,
    MessageCollection,
    MessageEnvelope,
    bunch_contiguous,
)

__all__ = [
    "Channel",
    "ChannelDeltaConnection",
    "ChannelFactory",
    "ChannelMessage",
    "MessageCollection",
    "MessageEnvelope",
    "bunch_contiguous",
]
