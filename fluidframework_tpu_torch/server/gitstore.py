"""Git-tree summary storage: content-addressed blobs/trees with structural
sharing (the gitrest/historian storage model).

A copy of ``fluidframework_tpu/server/gitstore.py`` (it imports no JAX).
Objects are addressed by the sha256 of the same canonical JSON, and the
object log holds the same lines, so an object store either package wrote
opens in the other with the same SHAs (tests/test_torch_scribe.py).

Reference parity: the reference stores summaries as GIT TREES via
historian -> gitrest (server/gitrest/packages/gitrest-base/src/; SURVEY
§2.5 "summaries stored as git trees"): every blob and tree object is
addressed by the hash of its content, so consecutive snapshots share every
unchanged subtree physically — version N+1 costs only its changed spine.
This pairs with the client's incremental summaries (handles reference
unchanged subtrees logically; the store dedups them physically even when a
client re-uploads identical content).

Objects (each keyed by sha256 of its canonical encoding):

- blob: canonical JSON of a leaf value;
- tree: sorted {name: child_sha} mapping — identical subtrees collapse to
  one object regardless of where (or in which version) they appear;
- commit: {tree, seq, parent} — the VERSION identity.  Two versions with
  identical content still get distinct commits (seq/parent differ), which
  is exactly why git has commit objects: refs stay 1:1 with versions.

``GitSnapshotStore`` is the per-document version chain (gitrest's refs):
``(seq, commit_sha)`` entries over one shared object store.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any


def _canon(obj: Any) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


class GitStore:
    """One content-addressed object store (may back many documents).

    With ``directory`` the store is durable: every new object appends one
    JSONL line to ``objects.jsonl`` (content-addressed objects are
    immutable, so an append-only log IS the store; a torn trailing line
    from a crash drops harmlessly — the object was never referenced by a
    durable ref).  Reopening replays the log."""

    def __init__(self, directory: str | None = None, readonly: bool = False) -> None:
        self._objects: dict[str, tuple[str, Any]] = {}  # sha -> (kind, payload)
        self.writes = 0       # put calls
        self.stored = 0       # objects actually created
        self.bytes_stored = 0
        self.loaded = 0       # objects replayed from the durable log
        self.readonly = readonly
        self._file = None
        if directory is not None:
            path = os.path.join(directory, "objects.jsonl")
            if not readonly:
                os.makedirs(directory, exist_ok=True)
            if os.path.exists(path):
                good_bytes = 0
                with open(path, "rb") as f:
                    raw_lines = f.read().split(b"\n")
                for i, raw in enumerate(raw_lines):
                    try:
                        sha, kind, payload = json.loads(raw) if raw.strip() else (
                            None, None, None
                        )
                    except (json.JSONDecodeError, ValueError):
                        if i == len(raw_lines) - 1:
                            # Torn trailing write: keep the good prefix AND
                            # truncate the tear away — appending after it
                            # would fuse two records into one garbage line
                            # and silently drop every later object on the
                            # NEXT reopen (same repair as DurablePartition).
                            break
                        # Interior corruption is NOT a crash artifact:
                        # truncating here would destroy every later object
                        # (possibly the only copy of compacted-away state).
                        # Surface it instead.
                        raise
                    if sha is not None:
                        self._objects[sha] = (kind, payload)
                        self.loaded += 1
                    good_bytes += len(raw) + 1
                if not readonly:
                    with open(path, "r+b") as f:
                        f.truncate(min(good_bytes, os.path.getsize(path)))
            if not readonly:
                self._file = open(path, "a")

    # ------------------------------------------------------------- primitives
    def _put(self, kind: str, payload: Any) -> str:
        if self.readonly:
            raise RuntimeError("read-only GitStore: writes not permitted")
        raw = _canon([kind, payload])
        sha = hashlib.sha256(raw).hexdigest()
        self.writes += 1
        if sha not in self._objects:
            # Store the canonical COPY: objects must be immutable — a
            # caller mutating its input (or a read result) must never
            # reach the shared stored structure, or every version sharing
            # the object would silently corrupt.
            self._objects[sha] = (kind, json.loads(raw.decode())[1])
            self.stored += 1
            self.bytes_stored += len(raw)
            if self._file is not None:
                self._file.write(
                    json.dumps([sha, kind, self._objects[sha][1]]) + "\n"
                )
                self._file.flush()
        return sha

    def sync(self) -> None:
        """Force the object log to disk (flush + fsync).  Callers invoke
        this before externalizing a commit sha (ack records, refs): once a
        sha is referenced durably, the objects behind it must not be
        sitting in the page cache when compaction destroys the op log they
        summarize."""
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def put_blob(self, content: Any) -> str:
        return self._put("blob", content)

    def put_tree(self, entries: dict[str, str]) -> str:
        """entries: name -> child sha (every child must already exist)."""
        for name, sha in entries.items():
            if sha not in self._objects:
                raise KeyError(f"tree entry {name!r} references unknown {sha}")
        return self._put("tree", dict(sorted(entries.items())))

    def put_commit(self, tree_sha: str, seq: int, parent: str | None) -> str:
        if tree_sha not in self._objects:
            raise KeyError(f"commit references unknown tree {tree_sha}")
        return self._put(
            "commit", {"tree": tree_sha, "seq": seq, "parent": parent}
        )

    def get(self, sha: str) -> tuple[str, Any]:
        """(kind, deep-copied payload); raises KeyError when unknown."""
        kind, payload = self._objects[sha]
        return kind, json.loads(_canon(payload).decode())

    def __contains__(self, sha: str) -> bool:
        return sha in self._objects

    def __len__(self) -> int:
        return len(self._objects)

    # ----------------------------------------------------------- snapshot IO
    def write_snapshot(self, plain: dict) -> str:
        """Recursively store a materialized summary: dicts become tree
        objects, everything else a blob.  Returns the root tree sha.
        Unchanged subtrees hash identically and dedup to existing objects."""
        def walk(node: Any) -> str:
            if isinstance(node, dict):
                return self.put_tree({k: walk(v) for k, v in node.items()})
            return self.put_blob(node)

        return walk(plain)

    def read_snapshot(self, sha: str) -> Any:
        kind, payload = self.get(sha)
        if kind == "blob":
            return payload
        return {name: self.read_snapshot(child) for name, child in payload.items()}

    def read_path(self, sha: str, path: str) -> Any:
        """Resolve a '/'-separated path from a root tree — the virtualized
        partial read (fetch one subtree without the whole snapshot; ref
        gitrest tree reads feeding odsp-style snapshot virtualization)."""
        cur = sha
        for part in [p for p in path.split("/") if p]:
            kind, payload = self.get(cur)
            if kind != "tree" or part not in payload:
                raise KeyError(f"path {path!r} not found under {sha[:12]}")
            cur = payload[part]
        return self.read_snapshot(cur)


class GitSnapshotStore:
    """Per-document version chain over a shared GitStore (gitrest refs):
    ``(seq, commit_sha)`` entries, newest last."""

    def __init__(self, store: GitStore | None = None) -> None:
        self.store = store if store is not None else GitStore()
        self.versions: list[tuple[int, str]] = []

    def save(self, seq: int, plain: dict) -> str:
        root = self.store.write_snapshot(plain)
        return self.save_root(seq, root)

    def save_root(self, seq: int, root_sha: str) -> str:
        """Commit a PRE-BUILT root tree (the scribe's handle-reuse path:
        unchanged channels keep their previous sha without re-walking)."""
        parent = self.versions[-1][1] if self.versions else None
        commit = self.store.put_commit(root_sha, seq, parent)
        self.versions.append((seq, commit))
        return commit

    def adopt_version(self, seq: int, commit_sha: str) -> None:
        """Re-attach a version minted by a previous incarnation (scribe
        restart: refs reload from disk, objects from the durable log)."""
        if commit_sha not in self.store:
            raise KeyError(f"unknown commit {commit_sha[:12]}")
        self.versions.append((seq, commit_sha))

    def read_commit(self, commit_sha: str) -> tuple[int, dict]:
        kind, payload = self.store.get(commit_sha)
        if kind != "commit":
            raise KeyError(f"{commit_sha[:12]} is a {kind}, not a commit")
        return payload["seq"], self.store.read_snapshot(payload["tree"])

    def latest(self) -> tuple[int, dict] | None:
        if not self.versions:
            return None
        return self.read_commit(self.versions[-1][1])

    def at(self, commit_sha: str) -> tuple[int, dict] | None:
        for _seq, commit in reversed(self.versions):
            if commit == commit_sha:
                return self.read_commit(commit)
        return None

    def version_ids(self, max_count: int = 5) -> list[dict]:
        if max_count <= 0:
            return []
        return [
            {"id": commit, "seq": seq}
            for seq, commit in reversed(self.versions[-max_count:])
        ]

    # ----------------------------------------------------------- diagnostics
    def sharing_ratio(self) -> float:
        """Fraction of object writes that dedup'd to an existing object —
        the structural-sharing measure across the version chain."""
        if not self.store.writes:
            return 0.0
        return 1.0 - self.store.stored / self.store.writes
