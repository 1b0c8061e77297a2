"""Runtime layer: container/datastore orchestration around the DDS kernels.

The port's own copy of ``fluidframework_tpu/runtime/`` (no JAX in it), with
the same exports.  Reference parity: packages/runtime/container-runtime
(ContainerRuntime, op lifecycle, pending state) and packages/runtime/datastore
(FluidDataStoreRuntime, the concrete side of the IChannelFactory plugin
boundary, datastore-definitions/src/channel.ts:140,203,233,294).
"""

from ..protocol.channel import Channel, ChannelFactory, ChannelDeltaConnection
from .datastore import DataStoreRuntime
from .container_runtime import ContainerRuntime
from .op_lifecycle import (
    Outbox,
    RemoteMessageProcessor,
    DuplicateBatchDetector,
    GROUPED_BATCH_TYPE,
    COMPRESSED_TYPE,
    CHUNK_TYPE,
)
from .pending_state import PendingStateManager

__all__ = [
    "Channel",
    "ChannelFactory",
    "ChannelDeltaConnection",
    "DataStoreRuntime",
    "ContainerRuntime",
    "Outbox",
    "RemoteMessageProcessor",
    "DuplicateBatchDetector",
    "PendingStateManager",
    "GROUPED_BATCH_TYPE",
    "COMPRESSED_TYPE",
    "CHUNK_TYPE",
]
