"""Framework / public API layer: the app-facing surface above the runtime.

The port's counterpart of ``fluidframework_tpu/framework/``, with the same
exports: ``fluid-static``'s FluidContainer and schema bootstrap,
``aqueduct``'s DataObject authoring model, ``presence`` (ephemeral state
over signals), ``undo-redo`` revertible stacks, the ``attributor``
(who-wrote-what from the op stream), the agent scheduler, the oldest-client
observer, interceptions, the dependency synthesizer, the tree agent, and the
service-client facade (tinylicious-client analog).
"""

from .agent_scheduler import AgentScheduler
from .aqueduct import DataObject, DataObjectFactory
from .attributor import OpStreamAttributor
from .fluid_static import ContainerSchema, FluidContainer
from .interceptions import InterceptedSharedMap, InterceptedSharedString
from .oldest_client import OldestClientObserver
from .presence import Presence
from .request_handler import (
    RequestParser,
    RuntimeRequestHandlerBuilder,
    datastore_request_handler,
)
from .service_client import LocalServiceClient, NetworkServiceClient
from .synthesize import DependencyContainer
from .tree_agent import TreeAgent, render_schema_prompt
from .undo_redo import UndoRedoStackManager

__all__ = [
    "AgentScheduler",
    "ContainerSchema",
    "DataObject",
    "DataObjectFactory",
    "DependencyContainer",
    "FluidContainer",
    "InterceptedSharedMap",
    "InterceptedSharedString",
    "LocalServiceClient",
    "NetworkServiceClient",
    "OldestClientObserver",
    "OpStreamAttributor",
    "Presence",
    "RequestParser",
    "RuntimeRequestHandlerBuilder",
    "TreeAgent",
    "UndoRedoStackManager",
    "datastore_request_handler",
    "render_schema_prompt",
]
