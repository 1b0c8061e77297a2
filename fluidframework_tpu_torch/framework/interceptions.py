"""The port's own copy of ``fluidframework_tpu/framework/interceptions.py`` (no JAX in it).

DDS interceptions: wrap a channel so local edits pass a hook first.

Reference parity: packages/framework/dds-interceptions —
createSharedMapWithInterception / createDirectoryWithInterception /
createSharedStringWithInterception: the wrapper forwards reads untouched
and routes every local WRITE through a callback that may enrich it (the
canonical use: stamping attribution properties onto edits)."""

from __future__ import annotations

from typing import Any, Callable


class InterceptedSharedMap:
    """Write-intercepting view over a SharedMapChannel."""

    def __init__(self, channel, interceptor: Callable[[str, Any], Any]) -> None:
        self._ch = channel
        self._hook = interceptor

    def set(self, key: str, value: Any) -> None:
        self._ch.set(key, self._hook(key, value))

    def delete(self, key: str) -> None:
        self._ch.delete(key)

    def __getattr__(self, name: str):  # reads pass through
        return getattr(self._ch, name)


class InterceptedSharedString:
    """Insert-intercepting view over a SharedStringChannel: the hook returns
    annotation properties applied to every inserted range (the reference's
    attribution-stamping string interception)."""

    def __init__(self, channel, props_hook: Callable[[], dict[int, int]]) -> None:
        self._ch = channel
        self._hook = props_hook

    def insert_text(self, pos: int, text: str) -> int:
        ls = self._ch.insert_text(pos, text)
        for prop, value in self._hook().items():
            self._ch.annotate_range(pos, pos + len(text), prop, value)
        return ls

    def __getattr__(self, name: str):
        return getattr(self._ch, name)
