"""Snapshot virtualization, persistent caching, and retry/prefetch utils.

A port of ``fluidframework_tpu/driver/virtual_storage.py`` (no JAX in it).

Reference parity:
- **odsp-driver snapshot virtualization** (packages/drivers/odsp-driver/src/
  odspDocumentStorageService.ts + the compact snapshot format): a snapshot
  is stored as a small SKELETON whose large subtrees are content-addressed
  blobs fetched on demand, so boot transfers the spine plus only the blobs
  this client doesn't already hold.
- **driver-web-cache** (persistent snapshot/blob cache keyed by content id;
  here an in-memory dict with optional directory persistence).
- **driver-utils** (packages/loader/driver-utils/src/): ``run_with_retry``
  with the driver error taxonomy (DriverError.can_retry, throttling
  retry-after), and ``PrefetchStorageService``
  (prefetchDocumentStorageService.ts — warm the cache ahead of reads).

Virtualization is transparent to the loader: ``get_latest_snapshot``
returns a ``LazySnapshot`` mapping that hydrates a subtree the first time
its key is read, counting fetches vs cache hits (the odsp telemetry
measure). Content addressing makes re-uploads of unchanged subtrees free
and makes warm-cache reboots fetch only what changed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

from .definitions import DriverError, StorageService

VBLOB_KEY = "__vblob__"
VBLOB_ESCAPE = "__vblob_escaped__"


class ThrottlingError(DriverError):
    """ref odsp throttling / 429: retryable after a delay."""

    def __init__(self, message: str, retry_after: float = 0.0) -> None:
        super().__init__(message, can_retry=True)
        self.retry_after = retry_after


# ---------------------------------------------------------------------------
# runWithRetry (ref driver-utils/src/runWithRetry.ts)
# ---------------------------------------------------------------------------

def run_with_retry(
    fn: Callable[[], Any],
    *,
    max_attempts: int = 5,
    base_delay: float = 0.01,
    max_delay: float = 2.0,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Run ``fn``, retrying retryable DriverErrors with exponential backoff
    (throttling errors wait their retry_after). Non-retryable errors and
    non-driver exceptions propagate immediately."""
    attempt = 0
    while True:
        try:
            return fn()
        except DriverError as e:
            attempt += 1
            if not e.can_retry or attempt >= max_attempts:
                raise
            delay = min(base_delay * (2 ** (attempt - 1)), max_delay)
            if isinstance(e, ThrottlingError):
                delay = max(delay, e.retry_after)
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)


# ---------------------------------------------------------------------------
# Persistent blob cache (ref driver-web-cache)
# ---------------------------------------------------------------------------

class SnapshotCache:
    """Content-addressed blob cache; optionally persisted to a directory
    (one file per blob id — survives process restarts like the reference's
    IndexedDB cache survives page loads)."""

    def __init__(self, directory: str | None = None) -> None:
        self._mem: dict[str, str] = {}
        self._dir = directory
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def get(self, blob_id: str) -> str | None:
        if blob_id in self._mem:
            return self._mem[blob_id]
        if self._dir is not None:
            path = os.path.join(self._dir, blob_id)
            if os.path.exists(path):
                with open(path) as f:
                    content = f.read()
                self._mem[blob_id] = content
                return content
        return None

    def put(self, blob_id: str, content: str) -> None:
        self._mem[blob_id] = content
        if self._dir is not None:
            with open(os.path.join(self._dir, blob_id), "w") as f:
                f.write(content)


# ---------------------------------------------------------------------------
# Shredding: summary dict -> skeleton + content-addressed subtree blobs
# ---------------------------------------------------------------------------

def _canonical(value: Any) -> str:
    return json.dumps(value, sort_keys=True, separators=(",", ":"))


def shred_summary(
    summary: dict,
    upload: Callable[[str], str],
    threshold: int = 256,
    known_chunk: Callable[[str], bool] | None = None,
) -> dict:
    """Replace large subtrees (bottom-up) with ``{VBLOB_KEY: id}`` markers.
    Children shred first, so a huge tree becomes a spine of small nodes
    pointing at content-addressed chunks — unchanged chunks keep their ids
    across snapshots (the virtualization dedup).

    ``known_chunk`` validates pass-through markers (re-shredding an
    unhydrated skeleton): an id it rejects raises at WRITE time instead of
    silently storing a dangling marker that fails far away at hydration."""

    def walk(value: Any, depth: int) -> Any:
        if isinstance(value, dict):
            keys = set(value.keys())
            if keys == {VBLOB_KEY} and isinstance(value[VBLOB_KEY], str):
                # An existing chunk marker (re-shredding a skeleton that was
                # not fully hydrated, e.g. dict(lazy_snapshot)): pass it
                # through — the id still resolves in the blob store.
                # VBLOB_KEY is a reserved key; genuine user data shaped
                # exactly {VBLOB_KEY: <str>} is not representable.
                if known_chunk is not None and not known_chunk(value[VBLOB_KEY]):
                    raise ValueError(
                        f"marker-shaped value {value!r} does not name a known "
                        f"chunk ({VBLOB_KEY!r} is a reserved key)"
                    )
                return dict(value)
            if keys == {VBLOB_KEY} or keys == {VBLOB_ESCAPE}:
                # Marker- or escape-shaped user data (non-string payload):
                # escape it, recording which key it had.
                (k,) = keys
                return {VBLOB_ESCAPE: {"k": k, "v": walk(value[k], depth + 1)}}
            out: Any = {k: walk(v, depth + 1) for k, v in value.items()}
        elif isinstance(value, list):
            out = [walk(v, depth + 1) for v in value]
        else:
            return value
        if depth > 0:
            encoded = _canonical(out)
            if len(encoded) > threshold:
                return {VBLOB_KEY: upload(encoded)}
        return out

    return walk(summary, 0)


def hydrate_summary(node: Any, fetch: Callable[[str], str]) -> Any:
    """Fully resolve a shredded skeleton (eager)."""
    if isinstance(node, dict):
        if set(node.keys()) == {VBLOB_KEY}:
            return hydrate_summary(json.loads(fetch(node[VBLOB_KEY])), fetch)
        if set(node.keys()) == {VBLOB_ESCAPE}:
            esc = node[VBLOB_ESCAPE]
            return {esc["k"]: hydrate_summary(esc["v"], fetch)}
        return {k: hydrate_summary(v, fetch) for k, v in node.items()}
    if isinstance(node, list):
        return [hydrate_summary(v, fetch) for v in node]
    return node


def iter_vblob_ids(node: Any):
    """All marker ids in a skeleton (transitively only those visible — the
    nested ones surface as their parents hydrate)."""
    if isinstance(node, dict):
        if set(node.keys()) == {VBLOB_KEY}:
            yield node[VBLOB_KEY]
            return
        for v in node.values():
            yield from iter_vblob_ids(v)
    elif isinstance(node, list):
        for v in node:
            yield from iter_vblob_ids(v)


class LazySnapshot(dict):
    """A snapshot skeleton that hydrates per-key on first read — reading
    only ``summary["protocol"]`` never fetches the runtime subtree's blobs
    (the odsp partial-snapshot access pattern)."""

    def __init__(self, skeleton: dict, fetch: Callable[[str], str]) -> None:
        super().__init__(skeleton)
        self._fetch = fetch
        self._hydrated: set = set()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if key not in self._hydrated:
            value = hydrate_summary(value, self._fetch)
            super().__setitem__(key, value)
            self._hydrated.add(key)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self[k]) for k in super().keys()]

    def values(self):
        return [self[k] for k in super().keys()]


# ---------------------------------------------------------------------------
# The virtualized storage service
# ---------------------------------------------------------------------------

class VirtualizedStorageService(StorageService):
    """Wrap any driver StorageService with odsp-style virtualization.

    Writes shred the summary into content-addressed chunks (cache-seeded,
    so this client never re-fetches what it wrote); reads return a
    LazySnapshot resolving chunks through the cache first. ``stats``
    counts wire fetches vs cache hits."""

    def __init__(
        self,
        inner: StorageService,
        cache: SnapshotCache | None = None,
        threshold: int = 256,
    ) -> None:
        self._inner = inner
        self._cache = cache if cache is not None else SnapshotCache()
        self._threshold = threshold
        self.stats = {"uploads": 0, "wire_fetches": 0, "cache_hits": 0}

    # ------------------------------------------------------------- internals
    def _upload_chunk(self, content: str) -> str:
        # Always upload: the cache is strictly a READ cache (a warm cache
        # says nothing about what the server holds — it may have restarted).
        # Write-side dedup is the server's job (content-addressed blob
        # stores make re-uploads of unchanged chunks idempotent).
        blob_id = self._inner.upload_blob_content(content)
        self.stats["uploads"] += 1
        self._cache.put(blob_id, content)
        return blob_id

    def _fetch_chunk(self, blob_id: str) -> str:
        cached = self._cache.get(blob_id)
        if cached is not None:
            self.stats["cache_hits"] += 1
            return cached
        content = self._inner.read_blob_content(blob_id)
        self.stats["wire_fetches"] += 1
        self._cache.put(blob_id, content)
        return content

    # -------------------------------------------------------------- contract
    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        snap = self._inner.get_latest_snapshot()
        if snap is None:
            return None
        seq, skeleton = snap
        return seq, LazySnapshot(skeleton, self._fetch_chunk)

    def _known_chunk(self, blob_id: str) -> bool:
        """Existence probe for pass-through markers. Only a DEFINITIVE
        absence (missing blob) reports unknown; a transient storage failure
        surfaces as itself, never as a reserved-key complaint. A successful
        probe warms the cache (the content was fetched anyway)."""
        if self._cache.get(blob_id) is not None:
            return True
        try:
            content = self._inner.read_blob_content(blob_id)
        except KeyError:
            return False
        except DriverError as e:
            if e.can_retry:
                raise  # transient: report the real failure
            return False
        self._cache.put(blob_id, content)
        return True

    def write_snapshot(self, seq: int, summary: dict) -> None:
        if isinstance(summary, LazySnapshot):
            # Force per-key hydration so we shred content, not markers
            # (markers that do sneak in pass through shred_summary intact).
            summary = {k: summary[k] for k in summary.keys()}
        skeleton = shred_summary(
            dict(summary), self._upload_chunk, self._threshold, self._known_chunk
        )
        self._inner.write_snapshot(seq, skeleton)

    def upload_blob_content(self, content: str) -> str:
        return self._inner.upload_blob_content(content)

    def read_blob_content(self, blob_id: str) -> str:
        return self._inner.read_blob_content(blob_id)

    def upload_summary(self, summary_tree: dict) -> str:
        return self._inner.upload_summary(summary_tree)

    def get_versions(self, max_count: int = 5) -> list[dict]:
        return self._inner.get_versions(max_count)

    def get_snapshot_version(self, version_id: str) -> tuple[int, dict] | None:
        snap = self._inner.get_snapshot_version(version_id)
        if snap is None:
            return None
        seq, skeleton = snap
        return seq, LazySnapshot(skeleton, self._fetch_chunk)


class VirtualizedDocumentServiceFactory:
    """Wrap any DocumentServiceFactory so storage connections come back
    virtualized (the odsp driver's storage path composed over an arbitrary
    transport). One cache per document id — shared across services of the
    same doc, like the web cache."""

    def __init__(
        self,
        inner,
        cache_dir: str | None = None,
        threshold: int = 256,
        prefetch: bool = False,
    ) -> None:
        self._inner = inner
        self._cache_dir = cache_dir
        self._threshold = threshold
        self._prefetch = prefetch
        self._caches: dict[str, SnapshotCache] = {}

    def cache_for(self, doc_id: str) -> SnapshotCache:
        if doc_id not in self._caches:
            sub = (
                os.path.join(self._cache_dir, doc_id)
                if self._cache_dir is not None
                else None
            )
            self._caches[doc_id] = SnapshotCache(sub)
        return self._caches[doc_id]

    def create_document_service(self, doc_id: str):
        inner_service = self._inner.create_document_service(doc_id)
        outer = self

        class _Service:
            def connect_to_delta_stream(self, *a, **kw):
                return inner_service.connect_to_delta_stream(*a, **kw)

            def connect_to_delta_storage(self):
                return inner_service.connect_to_delta_storage()

            def connect_to_storage(self):
                storage = VirtualizedStorageService(
                    inner_service.connect_to_storage(),
                    cache=outer.cache_for(doc_id),
                    threshold=outer._threshold,
                )
                return (
                    PrefetchStorageService(storage) if outer._prefetch else storage
                )

        return _Service()


class PrefetchStorageService(StorageService):
    """ref driver-utils PrefetchDocumentStorageService: wraps a (typically
    virtualized) storage service and warms every chunk reachable from the
    latest snapshot skeleton, so subsequent hydration is all cache hits."""

    def __init__(self, inner: VirtualizedStorageService) -> None:
        self._inner = inner

    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        snap = self._inner.get_latest_snapshot()
        if snap is None:
            return None
        seq, lazy = snap
        # Breadth-first chunk warm-up: fetch every marker, then any markers
        # that surfaced inside fetched chunks.
        frontier = list(iter_vblob_ids(dict.copy(lazy)))
        seen = set()
        while frontier:
            blob_id = frontier.pop()
            if blob_id in seen:
                continue
            seen.add(blob_id)
            content = self._inner._fetch_chunk(blob_id)
            frontier.extend(iter_vblob_ids(json.loads(content)))
        return seq, lazy

    def write_snapshot(self, seq: int, summary: dict) -> None:
        self._inner.write_snapshot(seq, summary)

    def upload_blob_content(self, content: str) -> str:
        return self._inner.upload_blob_content(content)

    def read_blob_content(self, blob_id: str) -> str:
        return self._inner.read_blob_content(blob_id)

    def upload_summary(self, summary_tree: dict) -> str:
        return self._inner.upload_summary(summary_tree)
