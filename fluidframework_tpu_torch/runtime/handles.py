"""The port's own copy of ``fluidframework_tpu/runtime/handles.py`` (no JAX in it).

The IFluidHandle wire shape — single source of truth.

A handle is ``{"__fluid_handle__": "/<ds id>[/<channel id>]"}`` with
percent-encoded segments. Both the framework layer (aqueduct: minting and
resolving) and the runtime layer (gc: reference scanning) read this module,
so the shape cannot silently diverge between the code that writes handles
and the collector that must keep their targets alive.
"""

from __future__ import annotations

from typing import Any
from urllib.parse import quote, unquote

HANDLE_KEY = "__fluid_handle__"


def make_handle_url(ds_id: str, channel_id: str | None = None) -> str:
    url = "/" + quote(ds_id, safe="")
    if channel_id is not None:
        url += "/" + quote(channel_id, safe="")
    return url


def parse_handle_url(url: str) -> list[str]:
    """Decoded path segments (the inverse of make_handle_url)."""
    return [unquote(p) for p in url.strip("/").split("/") if p]


def is_handle(value: Any) -> bool:
    return isinstance(value, dict) and isinstance(value.get(HANDLE_KEY), str)
