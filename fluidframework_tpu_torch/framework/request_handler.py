"""The port's own copy of ``fluidframework_tpu/framework/request_handler.py`` (no JAX in it).

Runtime request routing: URL paths to runtime objects.

Reference parity: packages/framework/request-handler —
``RuntimeRequestHandlerBuilder`` (runtimeRequestHandlerBuilder.ts) chains
handlers until one produces a response, and the stock handlers resolve
data stores / channels by path. ``RequestParser`` mirrors
runtime-utils' parser: split, unescape, expose ``path_parts``.
"""

from __future__ import annotations

from typing import Any, Callable
from urllib.parse import unquote


class RequestParser:
    """Parsed request: path segments + header bag (requestParser.ts)."""

    def __init__(self, url: str, headers: dict[str, Any] | None = None) -> None:
        self.url = url
        self.headers = dict(headers or {})
        self.path_parts = [unquote(p) for p in url.strip("/").split("/") if p]

    def sub_request(self, start: int) -> "RequestParser":
        """Tail of the path from ``start``, WITHOUT re-decoding: segments
        are already unquoted, so rebuilding a url and re-parsing would
        corrupt any segment containing '%' or an encoded '/'."""
        sub = RequestParser.__new__(RequestParser)
        sub.url = "/".join(self.path_parts[start:])
        sub.headers = dict(self.headers)
        sub.path_parts = list(self.path_parts[start:])
        return sub


def ok(value: Any) -> dict:
    return {"status": 200, "value": value}


def not_found(url: str) -> dict:
    return {"status": 404, "value": f"no route for {url!r}"}


Handler = Callable[[RequestParser, Any], dict | None]


class RuntimeRequestHandlerBuilder:
    """Compose handlers; the first non-None response wins (builder.ts)."""

    def __init__(self) -> None:
        self._handlers: list[Handler] = []

    def push(self, *handlers: Handler) -> "RuntimeRequestHandlerBuilder":
        self._handlers.extend(handlers)
        return self

    def build(self) -> Callable[[str, Any], dict]:
        handlers = list(self._handlers)

        def route(url: str, runtime: Any, headers: dict | None = None) -> dict:
            request = RequestParser(url, headers)
            for handler in handlers:
                response = handler(request, runtime)
                if response is not None:
                    return response
            return not_found(url)

        return route


# ----------------------------------------------------------- stock handlers

def datastore_request_handler(request: RequestParser, runtime) -> dict | None:
    """/<datastoreId>[/<channelId>] -> datastore or channel
    (requestHandlers.ts defaultDataStore/root routing)."""
    parts = request.path_parts
    if not parts:
        return None
    try:
        ds = runtime.datastore(parts[0])
    except KeyError:
        return None
    if len(parts) == 1:
        return ok(ds)
    if len(parts) == 2:
        try:
            return ok(ds.get_channel(parts[1]))
        except KeyError:
            return None
    return None


def default_route_handler(default_path: str) -> Handler:
    """'/' resolves to a default datastore (defaultRouteRequestHandler)."""

    def handler(request: RequestParser, runtime) -> dict | None:
        if request.path_parts:
            return None
        try:
            return ok(runtime.datastore(default_path))
        except KeyError:
            return None

    return handler


def create_fluid_object_handler(objects: dict[str, Any]) -> Handler:
    """Serve registered singletons by name (ref createFluidObjectResponse)."""

    def handler(request: RequestParser, runtime) -> dict | None:
        if len(request.path_parts) == 1 and request.path_parts[0] in objects:
            return ok(objects[request.path_parts[0]])
        return None

    return handler
