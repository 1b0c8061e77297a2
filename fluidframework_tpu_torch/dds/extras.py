"""The port's own copy of ``fluidframework_tpu/dds/extras.py`` (no JAX in it).

Remaining DDS family members: SharedDirectory, Ink, SharedSummaryBlock.

Reference parity:
- ``SharedDirectory`` (packages/dds/map/src/directory.ts): hierarchical
  key-value store — a tree of subdirectories each holding a LWW map, with
  create/delete of subdirectories sequenced like keys.
- ``Ink`` (packages/dds/ink/src/ink.ts): append-only stroke collection
  (createStroke/appendPointToStroke); ops commute per-stroke so application
  is order-insensitive beyond sequencing.
- ``SharedSummaryBlock`` (packages/dds/shared-summary-block): write-locally,
  read-after-summary block — data travels ONLY via summaries, never ops.
"""

from __future__ import annotations

from typing import Any

from .channels import ChannelTypeFactory, PendingOverlayChannel
from ..protocol.channel import Channel, MessageCollection


def _split_path(path: str) -> list[str]:
    return [p for p in path.split("/") if p]


class SharedDirectory(PendingOverlayChannel):
    """Hierarchical LWW key-value store (ref SharedDirectory).

    Sequenced state: nested dict of {"keys": {...}, "subdirs": {...}}.
    Ops carry an absolute subdirectory path; missing intermediate
    subdirectories are created implicitly (directory.ts ensureSubDirectory).
    Deleting a subdirectory drops its whole subtree (LWW by sequence order).
    """

    channel_type = "sharedDirectory"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.root: dict[str, Any] = {"keys": {}, "subdirs": {}}
        self._root_version = 0  # bumps on every sequenced apply (view cache)
        self._overlay_cache: tuple | None = None  # (key, view)

    # ------------------------------------------------------------ local edits
    def set(self, path: str, key: str, value: Any) -> None:
        self._submit({"type": "set", "path": path, "key": key, "value": value})

    def delete(self, path: str, key: str) -> None:
        self._submit({"type": "delete", "path": path, "key": key})

    def create_subdirectory(self, path: str) -> None:
        self._submit({"type": "createSubdir", "path": path})

    def delete_subdirectory(self, path: str) -> None:
        assert _split_path(path), "cannot delete the root directory"
        self._submit({"type": "deleteSubdir", "path": path})

    def clear(self, path: str = "") -> None:
        self._submit({"type": "clear", "path": path})

    # ---------------------------------------------------------------- applies
    def _node(self, state: dict, path: str, create: bool) -> dict | None:
        node = state
        for part in _split_path(path):
            sub = node["subdirs"].get(part)
            if sub is None:
                if not create:
                    return None
                sub = node["subdirs"][part] = {"keys": {}, "subdirs": {}}
            node = sub
        return node

    def _apply(self, op: dict) -> None:
        self._root_version += 1
        kind = op["type"]
        if kind == "set":
            self._node(self.root, op["path"], create=True)["keys"][op["key"]] = op["value"]
        elif kind == "delete":
            node = self._node(self.root, op["path"], create=False)
            if node is not None:
                node["keys"].pop(op["key"], None)
        elif kind == "createSubdir":
            self._node(self.root, op["path"], create=True)
        elif kind == "deleteSubdir":
            parts = _split_path(op["path"])
            parent = self._node(self.root, "/".join(parts[:-1]), create=False)
            if parent is not None:
                parent["subdirs"].pop(parts[-1], None)
        elif kind == "clear":
            node = self._node(self.root, op["path"], create=False)
            if node is not None:
                node["keys"].clear()
        else:
            raise ValueError(f"unknown directory op {kind!r}")

    # ------------------------------------------------------------------ views
    def _overlay(self) -> dict:
        """Optimistic view: sequenced state + pending ops applied on a
        copy, memoized until either side changes (repeated reads while ops
        are in flight would otherwise deepcopy the whole tree each time)."""
        import copy

        if not self._pending:
            return self.root
        key = (self._root_version, tuple(pid for pid, _op in self._pending))
        if self._overlay_cache is not None and self._overlay_cache[0] == key:
            return self._overlay_cache[1]
        view = copy.deepcopy(self.root)
        saved_version = self._root_version
        saved, self.root = self.root, view
        try:
            for _pid, op in self._pending:
                self._apply(op)
        finally:
            self.root = saved
            self._root_version = saved_version
        self._overlay_cache = (key, view)
        return view

    def get(self, path: str, key: str) -> Any:
        node = self._node(self._overlay(), path, create=False)
        return None if node is None else node["keys"].get(key)

    def keys(self, path: str = "") -> set[str]:
        node = self._node(self._overlay(), path, create=False)
        return set() if node is None else set(node["keys"])

    def subdirectories(self, path: str = "") -> set[str]:
        node = self._node(self._overlay(), path, create=False)
        return set() if node is None else set(node["subdirs"])

    def has_subdirectory(self, path: str) -> bool:
        return self._node(self._overlay(), path, create=False) is not None

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        import copy

        return {"root": copy.deepcopy(self.root)}

    def load(self, summary: dict[str, Any]) -> None:
        import copy

        self.root = copy.deepcopy(summary["root"])


class Ink(PendingOverlayChannel):
    """Append-only ink strokes (ref Ink: createStroke + appendPointToStroke).

    Points are (x, y, time, pressure) tuples; per-stroke append order is the
    author's order (single-author strokes in practice), cross-stroke order
    is sequencing order.
    """

    channel_type = "ink"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.strokes: dict[str, dict] = {}
        self._stroke_counter = 0

    def create_stroke(self, pen: dict | None = None) -> str:
        self._stroke_counter += 1
        owner = self._connection.client_id() if self._connection else self.id
        sid = f"{owner}-s{self._stroke_counter}"
        self._submit({"type": "createStroke", "id": sid, "pen": dict(pen or {})})
        return sid

    def append_point(self, stroke_id: str, x: float, y: float, t: float = 0.0, pressure: float = 0.5) -> None:
        self._submit(
            {"type": "stylus", "id": stroke_id, "point": [x, y, t, pressure]}
        )

    def _apply(self, op: dict) -> None:
        if op["type"] == "createStroke":
            self.strokes.setdefault(op["id"], {"pen": op["pen"], "points": []})
        elif op["type"] == "stylus":
            stroke = self.strokes.get(op["id"])
            if stroke is not None:  # points to a deleted/unknown stroke drop
                stroke["points"].append(tuple(op["point"]))
        else:
            raise ValueError(f"unknown ink op {op['type']!r}")

    # ------------------------------------------------------------------ views
    def get_stroke(self, stroke_id: str) -> dict | None:
        base = self.strokes.get(stroke_id)
        out = (
            {"pen": dict(base["pen"]), "points": list(base["points"])}
            if base is not None
            else None
        )
        for _pid, op in self._pending:
            if op["id"] != stroke_id:
                continue
            if op["type"] == "createStroke" and out is None:
                out = {"pen": dict(op["pen"]), "points": []}
            elif op["type"] == "stylus" and out is not None:
                out["points"].append(tuple(op["point"]))
        return out

    def stroke_ids(self) -> set[str]:
        out = set(self.strokes)
        out.update(op["id"] for _pid, op in self._pending if op["type"] == "createStroke")
        return out

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        return {
            "strokes": {
                sid: {"pen": s["pen"], "points": [list(p) for p in s["points"]]}
                for sid, s in self.strokes.items()
            }
        }

    def load(self, summary: dict[str, Any]) -> None:
        self.strokes = {
            sid: {"pen": dict(s["pen"]), "points": [tuple(p) for p in s["points"]]}
            for sid, s in summary["strokes"].items()
        }


class SharedSummaryBlock(Channel):
    """Summary-only data block (ref shared-summary-block): writes are local
    and surface to other clients ONLY through summary load — no ops ever.
    """

    channel_type = "sharedSummaryBlock"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.data: dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        self.data[key] = value  # local only; never submitted

    def get(self, key: str) -> Any:
        return self.data.get(key)

    def process_messages(self, collection: MessageCollection) -> None:
        raise RuntimeError("sharedSummaryBlock never receives ops")

    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        raise RuntimeError("sharedSummaryBlock never submits ops")

    def summarize(self) -> dict[str, Any]:
        return {"data": dict(self.data)}

    def load(self, summary: dict[str, Any]) -> None:
        self.data = dict(summary["data"])


EXTRA_DDS_FACTORIES: dict[str, ChannelTypeFactory] = {
    cls.channel_type: ChannelTypeFactory(cls)
    for cls in (SharedDirectory, Ink, SharedSummaryBlock)
}
