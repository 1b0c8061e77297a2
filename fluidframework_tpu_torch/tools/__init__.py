"""Tooling: the replay tool over the replay driver, the summary-inspect
CLI over the scribe's acked commits and the flight-recorder trace viewer
(the exports are the reference ``fluidframework_tpu/tools/__init__.py``'s;
its ``devtools`` is not ported yet, ROADMAP queue 1 item 7)."""

from .replay_tool import ReplayTool

__all__ = ["ReplayTool"]
