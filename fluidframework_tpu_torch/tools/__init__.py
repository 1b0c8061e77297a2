"""Tooling: the replay tool over the replay driver, the summary-inspect
CLI over the scribe's acked commits, the flight-recorder trace viewer and
devtools (the exports are the reference ``fluidframework_tpu/tools/__init__.py``'s)."""

from .replay_tool import ReplayTool

__all__ = ["ReplayTool"]
