"""The port's own copy of ``fluidframework_tpu/dds/tree/schema.py`` (no JAX in it).

Stored schema + typed view layer for SharedTree.

Reference parity: tree/src/core/schema-stored/ (stored schema, sequenced as
ops so all replicas agree) and tree/src/simple-tree/ (the public typed API:
object/array/leaf node kinds with field kinds required/optional/sequence).

The ``TreeView`` proxies translate reads into forest cursor walks and writes
into path-addressed changesets submitted through the channel — the analog of
simple-tree's proxy layer generating modular changesets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable

from .changeset import NodeChange, make_insert, make_remove, make_set_value
from .forest import Forest, Node, ROOT_FIELD


class FieldKind(str, Enum):
    VALUE = "value"  # exactly one child
    OPTIONAL = "optional"  # zero or one child
    SEQUENCE = "sequence"  # any number of children


class LeafKind(str, Enum):
    NUMBER = "number"
    STRING = "string"
    BOOLEAN = "boolean"
    NULL = "null"


LEAF_TYPES = {k.value for k in LeafKind}


@dataclass
class FieldSchema:
    kind: FieldKind
    allowed_types: set[str]

    def to_json(self) -> dict:
        return {"kind": self.kind.value, "types": sorted(self.allowed_types)}

    @staticmethod
    def from_json(d: dict) -> "FieldSchema":
        return FieldSchema(FieldKind(d["kind"]), set(d["types"]))


@dataclass
class NodeSchema:
    """An object node kind: named fields with schemas. Arrays are object
    nodes with a single SEQUENCE field (key "") — the same normalization the
    reference's simple-tree ArrayNode uses internally."""

    name: str
    fields: dict[str, FieldSchema] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"name": self.name, "fields": {k: f.to_json() for k, f in self.fields.items()}}

    @staticmethod
    def from_json(d: dict) -> "NodeSchema":
        return NodeSchema(
            d["name"], {k: FieldSchema.from_json(f) for k, f in d["fields"].items()}
        )


ARRAY_FIELD = ""


def array_schema(name: str, item_types: set[str]) -> NodeSchema:
    return NodeSchema(name, {ARRAY_FIELD: FieldSchema(FieldKind.SEQUENCE, item_types)})


@dataclass
class SchemaRegistry:
    """The document's stored schema: node kinds + the root field schema."""

    nodes: dict[str, NodeSchema] = field(default_factory=dict)
    root: FieldSchema | None = None

    def add(self, schema: NodeSchema) -> NodeSchema:
        self.nodes[schema.name] = schema
        return schema

    def to_json(self) -> dict:
        return {
            "nodes": {k: s.to_json() for k, s in self.nodes.items()},
            "root": self.root.to_json() if self.root else None,
        }

    @staticmethod
    def from_json(d: dict) -> "SchemaRegistry":
        reg = SchemaRegistry(
            nodes={k: NodeSchema.from_json(s) for k, s in d["nodes"].items()},
            root=FieldSchema.from_json(d["root"]) if d["root"] else None,
        )
        return reg

    # ------------------------------------------------------------- validation
    def check_node(self, node: Node) -> list[str]:
        """Validate a subtree; returns a list of violations (empty = ok)."""
        errors: list[str] = []
        if node.type in LEAF_TYPES:
            kind = node.type
            v = node.value
            ok = (
                (kind == LeafKind.NUMBER and isinstance(v, (int, float)) and not isinstance(v, bool))
                or (kind == LeafKind.STRING and isinstance(v, str))
                or (kind == LeafKind.BOOLEAN and isinstance(v, bool))
                or (kind == LeafKind.NULL and v is None)
            )
            if not ok:
                errors.append(f"leaf {kind} holds incompatible value {v!r}")
            if node.fields:
                errors.append(f"leaf {kind} has fields")
            return errors
        schema = self.nodes.get(node.type)
        if schema is None:
            return [f"unknown node type {node.type!r}"]
        for key, fs in schema.fields.items():
            children = node.fields.get(key, [])
            n = len(children)
            if fs.kind == FieldKind.VALUE and n != 1:
                errors.append(f"{node.type}.{key}: value field has {n} children")
            if fs.kind == FieldKind.OPTIONAL and n > 1:
                errors.append(f"{node.type}.{key}: optional field has {n} children")
            for c in children:
                if c.type not in fs.allowed_types:
                    errors.append(f"{node.type}.{key}: type {c.type!r} not allowed")
                errors.extend(self.check_node(c))
        for key in node.fields:
            if key not in schema.fields and node.fields[key]:
                errors.append(f"{node.type}: unexpected field {key!r}")
        return errors

    def check_forest(self, forest: Forest) -> list[str]:
        errors: list[str] = []
        roots = forest.root_field
        if self.root is not None:
            n = len(roots)
            if self.root.kind == FieldKind.VALUE and n != 1:
                errors.append(f"root: value field has {n} children")
            for r in roots:
                if r.type not in self.root.allowed_types:
                    errors.append(f"root: type {r.type!r} not allowed")
        for r in roots:
            errors.extend(self.check_node(r))
        return errors


# ---------------------------------------------------------------------------
# Schema evolution (ref tree/src/shared-tree/schematizingTreeView.ts
# compatibility + simple-tree SchemaCompatibilityStatus: a VIEW schema is
# checked against the document's STORED schema; viewing requires every
# stored-schema document to be readable under the view schema, upgrading
# replaces the stored schema with the view schema when that holds).
# ---------------------------------------------------------------------------

_KIND_WIDTH = {FieldKind.VALUE: 0, FieldKind.OPTIONAL: 1, FieldKind.SEQUENCE: 2}


@dataclass
class SchemaCompatibility:
    """ref simple-tree SchemaCompatibilityStatus {isEquivalent, canView,
    canUpgrade}."""

    is_equivalent: bool
    can_view: bool
    can_upgrade: bool


def field_subsumes(view: FieldSchema, stored: FieldSchema) -> bool:
    """Every field content valid under ``stored`` is valid under ``view``:
    multiplicity may widen (value -> optional -> sequence) and allowed
    types may grow, never shrink."""
    if _KIND_WIDTH[view.kind] < _KIND_WIDTH[stored.kind]:
        return False
    return stored.allowed_types <= view.allowed_types


def _subsumes(wider: SchemaRegistry, narrower: SchemaRegistry) -> bool:
    """Every document valid under ``narrower`` is valid under ``wider``:
    ``wider`` must know every ``narrower`` node type with each field
    widened-or-equal; it may add node types freely but may add NEW fields
    to an existing type only with non-VALUE kinds (existing documents lack
    the field entirely)."""
    if narrower.root is not None:
        if wider.root is None or not field_subsumes(wider.root, narrower.root):
            return False
    for name, s in narrower.nodes.items():
        w = wider.nodes.get(name)
        if w is None:
            return False
        for key, fs in s.fields.items():
            wf = w.fields.get(key)
            if wf is None or not field_subsumes(wf, fs):
                return False
        for key, wf in w.fields.items():
            if key not in s.fields and wf.kind == FieldKind.VALUE:
                return False  # new required field: old documents can't satisfy
    return True


def schema_compat(view: SchemaRegistry, stored: SchemaRegistry) -> SchemaCompatibility:
    """Compare a view schema against the stored schema.

    ``can_upgrade`` needs the view to subsume the stored schema (stored
    documents stay valid once the view schema replaces it).  ``can_view``
    is stricter — no-upgrade compatibility: edits written under the view
    schema must also satisfy the CURRENT stored schema, so the two must
    subsume each other (a strictly wider view only grants upgrade; ref
    SchemaCompatibilityStatus canView vs canUpgrade)."""
    forward = _subsumes(view, stored)
    return SchemaCompatibility(
        is_equivalent=view.to_json() == stored.to_json(),
        can_view=forward and _subsumes(stored, view),
        can_upgrade=forward,
    )


class SchemaView:
    """The gate a client goes through to read/edit a document with ITS OWN
    schema (ref ITree.viewWith -> TreeView with .compatibility and
    .upgradeSchema). Reads/edits raise until the view schema can read the
    stored schema; upgrade_schema ships the view schema as the new stored
    schema when permitted."""

    def __init__(self, channel, view_schema: SchemaRegistry) -> None:
        self._channel = channel
        self.view_schema = view_schema

    @property
    def compatibility(self) -> SchemaCompatibility:
        return schema_compat(self.view_schema, self._channel.schema)

    @property
    def root(self):
        c = self.compatibility
        if not c.can_view:
            raise RuntimeError(
                "view schema cannot read the document's stored schema "
                "(compatibility.can_view is False)"
            )
        return TreeView(
            self._channel.forest, self._channel.submit_change, self.view_schema
        ).root

    def upgrade_schema(self) -> None:
        c = self.compatibility
        if not c.can_upgrade:
            raise RuntimeError("view schema cannot upgrade the stored schema")
        if not c.is_equivalent:
            self._channel.set_schema(self.view_schema)


# ---------------------------------------------------------------------------
# Leaf construction helpers
# ---------------------------------------------------------------------------


def leaf(value: Any) -> Node:
    if value is None:
        return Node(type=LeafKind.NULL.value, value=None)
    if isinstance(value, bool):
        return Node(type=LeafKind.BOOLEAN.value, value=value)
    if isinstance(value, (int, float)):
        return Node(type=LeafKind.NUMBER.value, value=value)
    if isinstance(value, str):
        return Node(type=LeafKind.STRING.value, value=value)
    raise TypeError(f"not a leaf value: {value!r}")


def build_node(type_name: str, **fields: Any) -> Node:
    """Construct an object node; field values may be leaf scalars, Nodes, or
    lists thereof."""
    out = Node(type=type_name)
    for key, v in fields.items():
        items = v if isinstance(v, list) else [v]
        out.fields[key] = [i if isinstance(i, Node) else leaf(i) for i in items]
    return out


# ---------------------------------------------------------------------------
# Typed view (proxy layer)
# ---------------------------------------------------------------------------


class TreeView:
    """A read/write view over a SharedTree channel's forest. Reads resolve
    through live forest paths; writes submit path-addressed changesets via
    ``submit_change`` (provided by the channel)."""

    def __init__(
        self,
        forest: Forest,
        submit_change: Callable[[NodeChange], None],
        registry: SchemaRegistry | None = None,
    ) -> None:
        self._forest = forest
        self._submit = submit_change
        self.registry = registry

    # ----------------------------------------------------------------- reads
    @property
    def root(self) -> "NodeProxy | None":
        roots = self._forest.root_field
        return NodeProxy(self, [(ROOT_FIELD, 0)]) if roots else None

    def node(self, path: list[tuple[str, int]]) -> "NodeProxy":
        return NodeProxy(self, path)

    # ---------------------------------------------------------------- writes
    def set_root(self, node: Node) -> None:
        count = len(self._forest.root_field)
        if count:
            self._submit(make_remove([], ROOT_FIELD, 0, count))
        self._submit(make_insert([], ROOT_FIELD, 0, [node]))


class NodeProxy:
    """Typed handle to one node at a live path."""

    def __init__(self, view: TreeView, path: list[tuple[str, int]]) -> None:
        self._view = view
        self._path = path

    def _node(self) -> Node:
        return self._view._forest.node_at(self._path)

    # ----------------------------------------------------------------- reads
    @property
    def type(self) -> str:
        return self._node().type

    @property
    def value(self) -> Any:
        return self._node().value

    def get(self, key: str) -> "NodeProxy | None":
        children = self._node().fields.get(key, [])
        return NodeProxy(self._view, self._path + [(key, 0)]) if children else None

    def scalar(self, key: str) -> Any:
        """Read the leaf value of a value/optional field."""
        children = self._node().fields.get(key, [])
        return children[0].value if children else None

    def children(self, key: str = ARRAY_FIELD) -> list["NodeProxy"]:
        n = len(self._node().fields.get(key, []))
        return [NodeProxy(self._view, self._path + [(key, i)]) for i in range(n)]

    def __len__(self) -> int:
        return len(self._node().fields.get(ARRAY_FIELD, []))

    def __getitem__(self, i: int) -> "NodeProxy":
        return NodeProxy(self._view, self._path + [(ARRAY_FIELD, i)])

    def to_json(self) -> dict:
        return self._node().to_json()

    # ---------------------------------------------------------------- writes
    def set_value(self, value: Any) -> None:
        self._view._submit(make_set_value(self._path, value))

    def set(self, key: str, value: Any) -> None:
        """Overwrite a value/optional field with one leaf/node."""
        node = value if isinstance(value, Node) else leaf(value)
        count = len(self._node().fields.get(key, []))
        if count:
            self._view._submit(make_remove(self._path, key, 0, count))
        self._view._submit(make_insert(self._path, key, 0, [node]))

    def clear(self, key: str) -> None:
        count = len(self._node().fields.get(key, []))
        if count:
            self._view._submit(make_remove(self._path, key, 0, count))

    def insert(self, index: int, items: list, key: str = ARRAY_FIELD) -> None:
        nodes = [i if isinstance(i, Node) else leaf(i) for i in items]
        self._view._submit(make_insert(self._path, key, index, nodes))

    def remove(self, index: int, count: int = 1, key: str = ARRAY_FIELD) -> None:
        self._view._submit(make_remove(self._path, key, index, count))
