"""Metrics plane: Prometheus-text ``/metrics`` + JSON ``/status`` serving.

A copy of ``fluidframework_tpu/observability/metrics_plane.py``.  A
``MetricsPlane`` aggregates named sources — callables returning plain dicts
(an engine's ``health()``, its ``latency_histograms()``) whose leaves may be
numbers, bools, lists of numbers (one labeled series per index) or
``utils.telemetry.Histogram`` instances (quantile series plus
``_count``/``_sum``).  Non-numeric leaves appear in ``/status`` only.
``MetricsServer`` serves the plane over a small ThreadingHTTPServer on
``GET /metrics`` (Prometheus text exposition 0.0.4) and ``GET /status``;
it binds 127.0.0.1 by default.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (0.5, 0.9, 0.99)


def _metric_name(*parts: str) -> str:
    name = "_".join(_NAME_RE.sub("_", p).strip("_") for p in parts if p)
    return f"fftpu_{name}"


def _is_histogram(v: Any) -> bool:
    # Duck-typed: anything with record/percentile/count quacks like
    # utils.telemetry.Histogram (avoids an import cycle with utils).
    return (
        hasattr(v, "percentile") and hasattr(v, "count") and hasattr(v, "sum")
    )


def render_prometheus(tree: dict[str, Any]) -> str:
    """Flatten a nested dict of metric leaves into Prometheus text.

    Nested dict keys join with ``_``; numeric lists become one series per
    index with an ``idx`` label; histograms render as quantile series.
    """
    lines: list[str] = []

    def emit(name: str, value: Any, labels: str = "") -> None:
        # repr, not '%g': 6-significant-digit formatting would quantize
        # counters past ~1e6 (rate() over scrapes would plateau + spike).
        lines.append(f"{name}{labels} {float(value)!r}")

    def walk(prefix: tuple[str, ...], node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + (str(k),), node[k])
            return
        name = _metric_name(*prefix)
        if _is_histogram(node):
            for q in _QUANTILES:
                p = node.percentile(q)
                if p is not None:
                    emit(name, p, f'{{quantile="{q:g}"}}')
            emit(f"{name}_count", node.count)
            emit(f"{name}_sum", node.sum)
            return
        if isinstance(node, bool):
            emit(name, int(node))
            return
        if isinstance(node, (int, float)):
            emit(name, node)
            return
        if isinstance(node, (list, tuple)) and all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in node
        ):
            for i, v in enumerate(node):
                emit(name, v, f'{{idx="{i}"}}')
            return
        # Non-numeric leaf (strings, mixed lists): /status carries it.

    walk((), tree)
    return "\n".join(lines) + "\n" if lines else ""


def parse_prometheus(text: str) -> dict[tuple[str, tuple[tuple[str, str], ...]], float]:
    """Parse the exposition text back into ``{(name, labels): value}`` —
    the round-trip half the tests (and any scraper) rely on."""
    out: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)$", line
        )
        if m is None:
            raise ValueError(f"unparseable metrics line: {line!r}")
        name, raw_labels, value = m.groups()
        labels: list[tuple[str, str]] = []
        if raw_labels:
            for part in raw_labels.split(","):
                k, _eq, v = part.partition("=")
                labels.append((k.strip(), v.strip().strip('"')))
        out[(name, tuple(sorted(labels)))] = float(value)
    return out


def _status_jsonable(node: Any) -> Any:
    """The /status view: histograms summarize to their percentile dict,
    everything else passes through json-encodable or repr-falls-back."""
    if isinstance(node, dict):
        return {str(k): _status_jsonable(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_status_jsonable(v) for v in node]
    if _is_histogram(node):
        return node.snapshot()
    if isinstance(node, (str, int, float, bool)) or node is None:
        return node
    return repr(node)


class MetricsPlane:
    """Named metric sources aggregated into one scrapeable surface."""

    def __init__(self) -> None:
        self._sources: dict[str, Callable[[], dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable[[], dict[str, Any]]) -> None:
        with self._lock:
            self._sources[name] = fn

    def collect(self) -> dict[str, Any]:
        """One aggregate tree: ``{source_name: source_dict}``.  A failing
        source reports its error instead of sinking the whole scrape."""
        with self._lock:
            sources = dict(self._sources)
        out: dict[str, Any] = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — scrape must stay up
                out[name] = {"scrape_error": repr(e)[-200:]}
        return out

    def metrics_text(self) -> str:
        return render_prometheus(self.collect())

    def status_json(self) -> str:
        return json.dumps(_status_jsonable(self.collect()))


class _MetricsHandler(BaseHTTPRequestHandler):
    def log_message(self, *a) -> None:  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802
        plane: MetricsPlane = self.server.plane  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            body = plane.metrics_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/status":
            body = plane.status_json().encode()
            ctype = "application/json"
        else:
            body = b'{"error": "routes: /metrics, /status"}'
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsServer:
    """``/metrics`` + ``/status`` over one MetricsPlane (port 0 = ephemeral)."""

    def __init__(self, plane: MetricsPlane, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.plane = plane
        self._http = ThreadingHTTPServer((host, port), _MetricsHandler)
        self._http.plane = plane  # type: ignore[attr-defined]
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(
            target=self._http.serve_forever, daemon=True
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
