"""Snapshot-boot tier: HTTP reads straight out of the git snapshot store.

A port of ``fluidframework_tpu/fanout/historian.py`` (no JAX in it).

Booting readers are the vast majority of a hot document's traffic and need
NOTHING from the ordering path: the latest acked summary commit (plus the
trailing ops from delta storage) fully seeds a client.  This tier serves
exactly that — summary commits out of ``GitSnapshotStore`` — behind real
HTTP caching semantics, so a CDN/proxy (or the client's own cache) absorbs
the fleet-sized read load (the reference's historian layer:
historian → gitrest serve snapshots behind caching; ``git_sharing_ratio``
~0.65 says the content-addressed store already dedupes the bytes).

Caching contract:

- **ETag is the commit sha** — the version identity.  Content-addressed
  storage makes this exact: same sha ⇒ byte-identical snapshot.
- ``/doc/<id>/snapshot`` (latest) answers with ``Cache-Control: no-cache``
  (always revalidate: "latest" moves) but honors ``If-None-Match`` with a
  **304** — a booting reader that raced a summary pays one header
  round-trip, not a snapshot download.
- ``/doc/<id>/snapshot/<sha>`` and ``/doc/<id>/path/<sha>?path=a/b/c`` are
  **immutable** (``max-age=31536000, immutable``): a sha-addressed read can
  be cached forever by anything between us and the reader.
- ``path`` reads resolve one subtree via ``GitStore.read_path`` — the
  virtualized partial boot (fetch a single channel without the snapshot).

The tier holds NO service lock and never touches a sequencer: reads walk
immutable content-addressed objects (the version list is append-only, and
dict reads are GIL-atomic), so a boot storm cannot stall op ticketing.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

from ..observability import span

# source: doc_id -> GitSnapshotStore-like (``versions``/``store``/
# ``read_commit``/``latest``/``version_ids``) or None for unknown docs.
SnapshotSource = Callable[[str], object]

_IMMUTABLE = "public, max-age=31536000, immutable"
_REVALIDATE = "no-cache"


def _etag_matches(header: str | None, sha: str) -> bool:
    if not header:
        return False
    if header.strip() == "*":
        return True
    tags = [t.strip().strip('"') for t in header.split(",")]
    return sha in [t.removeprefix("W/").strip('"') for t in tags]


class _HistorianHandler(BaseHTTPRequestHandler):
    def log_message(self, *a) -> None:  # quiet
        pass

    def _json(self, code: int, obj, headers: dict | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)
        self.server.owner._count("bytes_served", len(body))  # type: ignore[attr-defined]

    def _not_modified(self, sha: str, cache_control: str) -> None:
        self.send_response(304)
        self.send_header("ETag", f'"{sha}"')
        self.send_header("Cache-Control", cache_control)
        self.end_headers()

    def do_GET(self) -> None:  # noqa: N802, C901 - route dispatch
        tier: HistorianTier = self.server.owner  # type: ignore[attr-defined]
        u = urlparse(self.path)
        parts = [p for p in u.path.split("/") if p]
        q = parse_qs(u.query)
        tier._count("requests")
        if parts == ["status"]:
            self._json(200, tier.stats())
            return
        if parts == ["metrics"]:
            from ..observability.metrics_plane import render_prometheus

            body = render_prometheus({"historian": tier.stats()}).encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if len(parts) < 3 or parts[0] != "doc":
            tier._count("bad_routes")
            self._json(404, {"error": "bad route"})
            return
        store = tier.source(parts[1])
        if store is None:
            tier._count("unknown_docs")
            self._json(404, {"error": "no such document"})
            return
        inm = self.headers.get("If-None-Match")
        with span("historian_read", doc=parts[1], route=parts[2]):
            if parts[2] == "versions" and len(parts) == 3:
                try:
                    max_count = int(q.get("max", ["5"])[0])
                except ValueError:
                    self._json(400, {"error": "non-numeric max"})
                    return
                self._json(200, {"versions": store.version_ids(max_count)})
            elif parts[2] == "snapshot" and len(parts) == 3:
                # Latest: revalidate-always, but a matching ETag costs one
                # header round-trip (the boot-storm fast path).
                if not store.versions:
                    tier._count("missing_snapshots")
                    self._json(404, {"error": "no snapshot"})
                    return
                seq, sha = store.versions[-1]
                if _etag_matches(inm, sha):
                    tier._count("not_modified_304")
                    self._not_modified(sha, _REVALIDATE)
                    return
                tier._count("cold_serves")
                _seq, summary = store.read_commit(sha)
                self._json(
                    200,
                    {"seq": seq, "commit": sha, "summary": summary},
                    headers={"ETag": f'"{sha}"',
                             "Cache-Control": _REVALIDATE},
                )
            elif parts[2] == "snapshot" and len(parts) == 4:
                sha = parts[3]
                if _etag_matches(inm, sha):
                    # Immutable: a sha-addressed conditional GET never even
                    # touches the object store.
                    tier._count("not_modified_304")
                    self._not_modified(sha, _IMMUTABLE)
                    return
                try:
                    seq, summary = store.read_commit(sha)
                except KeyError:
                    tier._count("unknown_commits")
                    self._json(404, {"error": "no such commit"})
                    return
                tier._count("cold_serves")
                self._json(
                    200,
                    {"seq": seq, "commit": sha, "summary": summary},
                    headers={"ETag": f'"{sha}"', "Cache-Control": _IMMUTABLE},
                )
            elif parts[2] == "path" and len(parts) == 4:
                sha = parts[3]
                path = q.get("path", [""])[0]
                if _etag_matches(inm, sha):
                    tier._count("not_modified_304")
                    self._not_modified(sha, _IMMUTABLE)
                    return
                try:
                    kind, payload = store.store.get(sha)
                    if kind != "commit":
                        raise KeyError(sha)
                    value = store.store.read_path(payload["tree"], path)
                except KeyError:
                    tier._count("unknown_commits")
                    self._json(404, {"error": "no such commit or path"})
                    return
                tier._count("path_reads")
                self._json(
                    200,
                    {"commit": sha, "path": path, "value": value},
                    headers={"ETag": f'"{sha}"', "Cache-Control": _IMMUTABLE},
                )
            else:
                tier._count("bad_routes")
                self._json(404, {"error": "bad route"})


class HistorianTier:
    """The standalone snapshot-boot HTTP server over a snapshot source."""

    def __init__(self, source: SnapshotSource, port: int = 0) -> None:
        self.source = source
        self._started = time.monotonic()
        self._stats_lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._http = ThreadingHTTPServer(("127.0.0.1", port), _HistorianHandler)
        self._http.owner = self  # type: ignore[attr-defined]
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(
            target=self._http.serve_forever, name="historian", daemon=True
        )

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._counters)
        out["uptime_s"] = round(time.monotonic() - self._started, 3)
        return out

    def start(self) -> "HistorianTier":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()


def service_snapshot_source(service) -> SnapshotSource:
    """Adapt a ``LocalService`` into a snapshot source: non-creating doc
    lookup → the document's git version chain.  Reads are lock-free by
    design (immutable content-addressed objects; append-only refs)."""
    def source(doc_id: str):
        doc = service.peek_document(doc_id)
        if doc is None:
            return None
        return doc.snapshot_store()

    return source
