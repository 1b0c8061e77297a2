"""Framework layer: the op-stream attributor (``OpStreamAttributor``) that
``ContainerRuntime(track_attribution=True)`` records into, the undo-redo
stacks (``UndoRedoStackManager``) over string, map and tree channels, and
presence (``presence.Presence``: per-session state over signals, with
attendees from the loader's audience).  The rest of
``fluidframework_tpu/framework/`` is not ported (ROADMAP queue 1 item 9)."""

from .attributor import OpStreamAttributor
from .presence import Presence
from .undo_redo import UndoRedoStackManager

__all__ = ["OpStreamAttributor", "Presence", "UndoRedoStackManager"]
