"""The port's own copy of ``fluidframework_tpu/framework/aqueduct.py`` (no JAX in it).

aqueduct: the DataObject high-level authoring model.

Reference parity: packages/framework/aqueduct — ``DataObject`` (a datastore
with a root SharedMap under which apps organize state and handles to other
channels) and ``DataObjectFactory`` (type name + channel registry + the
PureDataObject initialization lifecycle: ``initializingFirstTime`` on the
creating client only, ``initializingFromExisting`` on every later load,
``hasInitialized`` after either), the authoring pattern nearly every Fluid
example app uses. Handles (``DataObject.handle`` /
``resolve_handle``) are serializable references resolvable on any replica
— stored in maps like the reference stores IFluidHandles, resolved through
the request-routing layer.
"""

from __future__ import annotations

from typing import Any, Callable

from ..runtime.container_runtime import ContainerRuntime
from ..runtime.datastore import DataStoreRuntime

from ..runtime.handles import HANDLE_KEY, is_handle, make_handle_url

ROOT_MAP_ID = "root"


def make_handle(ds_id: str, channel_id: str | None = None) -> dict:
    """A serializable reference to a datastore (or one of its channels) —
    the IFluidHandle wire shape (runtime/handles.py; segments
    percent-encoded so ids containing '/' or '%' round-trip)."""
    return {HANDLE_KEY: make_handle_url(ds_id, channel_id)}


def resolve_handle(runtime: ContainerRuntime, handle: dict):
    """Resolve a stored handle on THIS replica (ref handle.get()): routes
    the handle's URL through the request layer."""
    from .request_handler import RuntimeRequestHandlerBuilder, datastore_request_handler

    if not is_handle(handle):
        # is_handle also requires a STRING url: a malformed
        # {"__fluid_handle__": None} raises here, not deep in the parser.
        raise TypeError(f"not a handle: {handle!r}")
    route = RuntimeRequestHandlerBuilder().push(datastore_request_handler).build()
    response = route(handle[HANDLE_KEY], runtime)
    if response["status"] != 200:
        raise KeyError(f"handle target not found: {handle[HANDLE_KEY]!r}")
    value = response["value"]
    return DataObject(value) if isinstance(value, DataStoreRuntime) else value


class DataObject:
    """A datastore wrapped in the aqueduct conventions: a ``root`` SharedMap
    plus named helper channels (ref PureDataObject/DataObject)."""

    def __init__(self, datastore: DataStoreRuntime) -> None:
        self._ds = datastore

    @property
    def id(self) -> str:
        return self._ds.id

    @property
    def root(self):
        """The root SharedMap (ref DataObject.root)."""
        return self._ds.get_channel(ROOT_MAP_ID)

    @property
    def handle(self) -> dict:
        """Serializable reference to this object (ref this.handle) —
        storable in any map/cell and resolvable on every replica."""
        return make_handle(self._ds.id)

    def channel_handle(self, name: str) -> dict:
        return make_handle(self._ds.id, name)

    def channel(self, name: str):
        return self._ds.get_channel(name)

    def create_channel(self, channel_type: str, name: str):
        return self._ds.create_channel(channel_type, name)


class DataObjectFactory:
    """Creates/loads DataObjects of one named type (ref DataObjectFactory).

    ``initial_channels``: name -> DDS type string, created (with the root
    map) on first-time initialization. ``initializing_first_time`` runs
    once on the creating client, AFTER the datastore attach is staged (its
    edits ride as ops following the layout — remote replicas instantiate
    the datastore first); ``initializing_from_existing`` runs on every
    later load; ``has_initialized`` after either.
    """

    def __init__(
        self,
        object_type: str,
        initial_channels: dict[str, str] | None = None,
        initializing_first_time: Callable[[DataObject], None] | None = None,
        initializing_from_existing: Callable[[DataObject], None] | None = None,
        has_initialized: Callable[[DataObject], None] | None = None,
    ) -> None:
        self.object_type = object_type
        self.initial_channels = dict(initial_channels or {})
        self._first_time = initializing_first_time
        self._from_existing = initializing_from_existing
        self._has_initialized = has_initialized

    def create(self, runtime: ContainerRuntime, ds_id: str) -> DataObject:
        ds = runtime.create_datastore(ds_id)
        ds.create_channel("sharedMap", ROOT_MAP_ID)
        for name, channel_type in self.initial_channels.items():
            ds.create_channel(channel_type, name)
        obj = DataObject(ds)
        # Sequence the new datastore's layout BEFORE any content op (the
        # init hook's edits included) so remote replicas instantiate it
        # first (ref attach ops).
        runtime.submit_datastore_attach(ds_id)
        if self._first_time is not None:
            self._first_time(obj)
        if self._has_initialized is not None:
            self._has_initialized(obj)
        return obj

    def get(self, runtime: ContainerRuntime, ds_id: str) -> DataObject:
        """Bind to an existing datastore created by this factory elsewhere
        (ref initializingFromExisting -> hasInitialized lifecycle)."""
        ds = runtime.datastore(ds_id)
        for name in (ROOT_MAP_ID, *self.initial_channels):
            ds.get_channel(name)  # raises if the layout doesn't match
        obj = DataObject(ds)
        if self._from_existing is not None:
            self._from_existing(obj)
        if self._has_initialized is not None:
            self._has_initialized(obj)
        return obj
