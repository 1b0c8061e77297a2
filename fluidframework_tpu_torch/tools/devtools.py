"""Devtools: live container/DDS inspection + telemetry capture + metrics.

Reference parity: packages/tools/devtools/devtools-core — FluidDevtools
(container registry, initializeDevtools/registerContainerDevtools),
ContainerDevtools (container + audience metadata, DDS data visualization
via visualizeChildData), and DevtoolsLogger (telemetry event capture the
devtools view consumes). The reference talks to a browser extension over
window messaging; here the same state surfaces as JSON — consumable
programmatically or over the optional HTTP endpoint (``DevtoolsServer``),
the analog of the extension's message channel.

A port of ``fluidframework_tpu/tools/devtools.py`` (no JAX in it).
``visualize_channel`` renders a string's text through its backend, so a
string on the card is read back from the device once per view.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..utils.telemetry import Logger


# ---------------------------------------------------------------------------
# DDS visualization (devtools-core/src/data-visualization)
# ---------------------------------------------------------------------------

def visualize_channel(channel) -> dict[str, Any]:
    """Type-aware visual tree for one DDS (visualizeChildData analog):
    every known channel type renders its user-level state; unknown types
    fall back to their summary."""
    ctype = getattr(channel, "channel_type", type(channel).__name__)
    out: dict[str, Any] = {"type": ctype}
    try:
        if ctype == "sharedString":
            out["text"] = channel.text
            out["intervals"] = {
                label: [iv.to_json() for iv in coll]
                for label, coll in getattr(channel, "_collections", {}).items()
            }
        elif ctype == "sharedMap":
            out["entries"] = {k: channel.get(k) for k in channel.keys()}
        elif ctype == "sharedMatrix":
            out["rows"] = channel.row_count
            out["cols"] = channel.col_count
        elif ctype == "sharedTree":
            out["forest"] = channel.forest.to_json()
        elif ctype == "sharedCell":
            out["value"] = channel.get()
        elif ctype == "sharedJsonOT":
            out["doc"] = channel.get()
            out["pendingOps"] = len(channel._pending)
        elif ctype == "sharedDirectory":
            def walk(path: str) -> dict:
                node: dict[str, Any] = {
                    "keys": {k: channel.get(path, k) for k in sorted(channel.keys(path))},
                }
                subs = {
                    name: walk(f"{path}/{name}" if path else name)
                    for name in sorted(channel.subdirectories(path))
                }
                if subs:
                    node["subdirectories"] = subs
                return node

            out["tree"] = walk("")
        elif ctype == "taskManager":
            out["queues"] = {k: list(v) for k, v in channel.queues.items()}
        elif hasattr(channel, "value"):
            out["value"] = channel.value
        elif hasattr(channel, "summarize"):
            out["summary"] = channel.summarize()
    except Exception as e:  # visualization must never take the host down
        out["error"] = f"{type(e).__name__}: {e}"
    return out


class ContainerDevtools:
    """Inspection surface for one registered container runtime
    (devtools-core ContainerDevtools: metadata + audience + DDS data)."""

    def __init__(self, container_key: str, runtime) -> None:
        self.container_key = container_key
        self.runtime = runtime

    def metadata(self) -> dict[str, Any]:
        r = self.runtime
        return {
            "containerKey": self.container_key,
            "containerId": getattr(r, "id", None),
            "connected": bool(getattr(r, "has_document", False)),
            "refSeq": getattr(r, "ref_seq", None),
            "pendingOps": getattr(r, "pending_op_count", None),
        }

    def audience(self) -> list[dict[str, Any]]:
        quorum = getattr(self.runtime, "quorum_table", None)
        if quorum is None:
            return []
        return [
            {"clientId": cid, "shortId": short}
            for cid, short in sorted(quorum.items())
        ]

    def container_data(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for ds_id, ds in self.runtime.datastores.items():
            out[ds_id] = {
                ch_id: visualize_channel(ds.get_channel(ch_id))
                for ch_id in ds.channels
            }
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "metadata": self.metadata(),
            "audience": self.audience(),
            "data": self.container_data(),
        }


class DevtoolsLogger(Logger):
    """A telemetry logger the devtools surface (DevtoolsLogger analog):
    forwards to an optional base logger and keeps the event history."""

    def __init__(self, base: Logger | None = None, namespace: str = "") -> None:
        super().__init__(namespace=namespace)
        self._base = base

    def send(self, event: dict[str, Any]) -> None:
        super().send(event)
        if self._base is not None:
            self._base.send(dict(event))


class FluidDevtools:
    """The devtools root (devtools-core FluidDevtools.initialize):
    registered containers + captured telemetry + aggregate metrics."""

    def __init__(self, logger: DevtoolsLogger | None = None) -> None:
        self.containers: dict[str, ContainerDevtools] = {}
        self.logger = logger if logger is not None else DevtoolsLogger()
        self.disposed = False

    def register_container(self, container_key: str, runtime) -> ContainerDevtools:
        if container_key in self.containers:
            raise ValueError(f"container key {container_key!r} already registered")
        dt = ContainerDevtools(container_key, runtime)
        self.containers[container_key] = dt
        return dt

    def close_container(self, container_key: str) -> None:
        self.containers.pop(container_key, None)

    def metrics(self) -> dict[str, Any]:
        """Aggregate counters over captured telemetry (category/event)."""
        counts: dict[str, int] = {}
        durations: dict[str, float] = {}
        for e in self.logger.events:
            key = f"{e.get('category', '?')}:{e.get('eventName', '?')}"
            counts[key] = counts.get(key, 0) + 1
            if "duration" in e:
                durations[key] = durations.get(key, 0.0) + e["duration"]
        return {"eventCounts": counts, "eventDurations": durations}

    def to_json(self) -> dict[str, Any]:
        return {
            "containers": {k: c.to_json() for k, c in self.containers.items()},
            "metrics": self.metrics(),
            "events": list(self.logger.events)[-200:],
        }

    def dispose(self) -> None:
        self.containers.clear()
        self.disposed = True


# ---------------------------------------------------------------------------
# Optional HTTP surface (the extension-messaging analog)
# ---------------------------------------------------------------------------

class _DevtoolsHandler(BaseHTTPRequestHandler):
    def log_message(self, *a) -> None:  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802
        devtools: FluidDevtools = self.server.devtools  # type: ignore[attr-defined]
        if self.path == "/devtools":
            body = devtools.to_json()
        elif self.path == "/devtools/metrics":
            body = devtools.metrics()
        elif self.path.startswith("/devtools/container/"):
            key = self.path.rsplit("/", 1)[1]
            c = devtools.containers.get(key)
            if c is None:
                self.send_response(404)
                self.end_headers()
                return
            body = c.to_json()
        else:
            self.send_response(404)
            self.end_headers()
            return
        payload = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class DevtoolsServer:
    """Serve the devtools JSON over HTTP (GET /devtools[...])."""

    def __init__(self, devtools: FluidDevtools, port: int = 0) -> None:
        self._http = ThreadingHTTPServer(("127.0.0.1", port), _DevtoolsHandler)
        self._http.devtools = devtools  # type: ignore[attr-defined]
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    def start(self) -> "DevtoolsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
