"""The port's own copy of ``fluidframework_tpu/framework/fluid_static.py`` (no JAX in it).

fluid-static: FluidContainer + schema-driven initial objects.

Reference parity: packages/framework/fluid-static — ``IFluidContainer``/
``FluidContainer`` (fluidContainer.ts) wrap the loader Container behind an
app-simple surface, and ``rootDataObject.ts`` bootstraps the channels named
in a ContainerSchema so every client finds them under ``initialObjects``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..dds.channels import default_registry
from ..loader.container import Container

ROOT_DATASTORE = "rootDO"


@dataclass
class ContainerSchema:
    """Declares the initial channels every client expects (ref
    ContainerSchema.initialObjects: name -> DDS type string)."""

    initial_objects: dict[str, str]
    registry: dict[str, Any] = field(default_factory=default_registry)


class FluidContainer:
    """App-facing wrapper over the loader Container (ref FluidContainer)."""

    def __init__(self, container: Container, schema: ContainerSchema) -> None:
        self.container = container
        self.schema = schema

    # ------------------------------------------------------------- lifecycle
    @staticmethod
    def create_detached(schema: ContainerSchema, client_id: str = "creator") -> "FluidContainer":
        c = Container.create_detached(schema.registry, container_id=client_id)
        ds = c.runtime.create_datastore(ROOT_DATASTORE)
        for name, channel_type in schema.initial_objects.items():
            ds.create_channel(channel_type, name)
        return FluidContainer(c, schema)

    def attach(self, doc_id: str, service_factory, client_id: str) -> str:
        self.container.attach(doc_id, service_factory, client_id)
        return doc_id

    @staticmethod
    def load(
        doc_id: str, service_factory, schema: ContainerSchema, client_id: str, **kw
    ) -> "FluidContainer":
        c = Container.load(doc_id, service_factory, schema.registry, client_id, **kw)
        fc = FluidContainer(c, schema)
        # Contract check: the document must carry the schema's objects.
        ds = c.runtime.datastore(ROOT_DATASTORE)
        for name, channel_type in schema.initial_objects.items():
            ch = ds.get_channel(name)
            if ch.channel_type != channel_type:
                raise ValueError(
                    f"initial object {name!r} is {ch.channel_type!r}, "
                    f"schema expects {channel_type!r}"
                )
        return fc

    @staticmethod
    def view_version(schema: ContainerSchema, summary: dict) -> "FluidContainer":
        """A read-only view of a container at a stored snapshot version,
        never connected to the service (ref AzureClient.viewContainerVersion
        via loadContainerPaused)."""
        c = Container.create_detached(schema.registry, container_id="version-view")
        c.runtime.load_snapshot(summary["runtime"])
        return FluidContainer(c, schema)

    # ----------------------------------------------------------------- access
    @property
    def initial_objects(self) -> dict[str, Any]:
        ds = self.container.runtime.datastore(ROOT_DATASTORE)
        return {name: ds.get_channel(name) for name in self.schema.initial_objects}

    @property
    def connected(self) -> bool:
        return self.container.connected

    def flush(self) -> None:
        self.container.runtime.flush()

    def disconnect(self) -> None:
        self.container.disconnect()

    def connect(self) -> None:
        self.container.connect()

    def close(self) -> None:
        self.container.close()

    @property
    def is_dirty(self) -> bool:
        """Unacked local changes exist (ref IFluidContainer.isDirty)."""
        return self.container.runtime.pending_op_count > 0
