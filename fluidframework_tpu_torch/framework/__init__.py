"""Framework layer: the op-stream attributor (``OpStreamAttributor``) that
``ContainerRuntime(track_attribution=True)`` records into.  The rest of
``fluidframework_tpu/framework/`` is not ported (ROADMAP queue 1 item 13)."""

from .attributor import OpStreamAttributor

__all__ = ["OpStreamAttributor"]
