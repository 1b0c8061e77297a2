"""Framework layer: the op-stream attributor (``OpStreamAttributor``) that
``ContainerRuntime(track_attribution=True)`` records into, and the undo-redo
stacks (``UndoRedoStackManager``) over string, map and tree channels.  The
rest of ``fluidframework_tpu/framework/`` is not ported (ROADMAP queue 1
item 9)."""

from .attributor import OpStreamAttributor
from .undo_redo import UndoRedoStackManager

__all__ = ["OpStreamAttributor", "UndoRedoStackManager"]
