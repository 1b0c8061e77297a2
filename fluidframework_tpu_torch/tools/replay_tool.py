"""Replay tool: time-travel a recorded document through the real stack.

A port of ``fluidframework_tpu/tools/replay_tool.py`` over the port's
``driver/replay_driver.py`` and ``loader/container.py``.  Reference parity: packages/tools/replay-tool — load a container read-only
over the replay driver, step it to arbitrary sequence numbers, and dump
state snapshots along the way (regression-compare runs)."""

from __future__ import annotations

from typing import Any

from ..dds.channels import default_registry
from ..driver.replay_driver import ReplayDocumentServiceFactory
from ..loader.container import Container


class ReplayTool:
    def __init__(self, factory: ReplayDocumentServiceFactory, doc_id: str,
                 registry: dict | None = None) -> None:
        self.container = Container.load(
            doc_id, factory, registry or default_registry(), "__replay__",
            mode="read",
        )
        self._conn = self.container.delta_manager.connection_manager.connection

    @classmethod
    def from_local_service(cls, service, doc_id: str, to_seq: int | None = None) -> "ReplayTool":
        return cls(
            ReplayDocumentServiceFactory.from_local_service(service, to_seq), doc_id
        )

    def step_to(self, seq: int | None = None) -> int:
        """Replay recorded ops up to ``seq`` (all when None)."""
        return self._conn.replay_to(seq)

    @property
    def current_seq(self) -> int:
        return self.container.runtime.ref_seq

    def state_dump(self) -> dict[str, Any]:
        """Full runtime state at the current replay point."""
        return self.container.runtime.summarize()
