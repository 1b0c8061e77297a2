"""The port's own copy of ``fluidframework_tpu/dds/tree/simple_tree.py`` (no JAX in it).

simple-tree: the declarative typed public API over SharedTree.

Reference parity: tree/src/simple-tree/ — ``SchemaFactory``
(api/schemaFactory.ts) lets applications DECLARE node schemas as classes
and then work with the document through typed objects instead of paths:

    sf = SchemaFactory("com.example.app")
    Point = sf.object("Point", x=sf.number, y=sf.number)
    Points = sf.array("Points", Point)

    view = channel.typed_view(TreeViewConfiguration(Points))
    view.initialize([Point(x=1, y=2)])
    view.root.insert_at_end(Point(x=3, y=4))
    view.root[0].x = 5                    # typed write -> changeset
    Tree.on(view.root[0], "nodeChanged", cb)

Python-idiomatic rather than a TS transcription: schema "classes" construct
UNHYDRATED content (plain forest Nodes); reading through a view hands back
HYDRATED typed handles bound to live paths (simple-tree's proxy hydration,
core/treeNodeKernel.ts).  Field access maps by field kind — required/
optional leaves read as scalars, node fields as typed handles, arrays as
sequences with the reference TreeArrayNode verbs (insert_at/insert_at_start/
insert_at_end/remove_at/remove_range/move_to_index — moves are REAL moves,
preserving identity under concurrent edits, not remove+insert).  The
``Tree`` helper namespace mirrors the reference's (api/tree.ts): key,
parent, schema, is_, status, on.  Plain data hydrates implicitly where the
schema is unambiguous (dicts for objects, lists for arrays, scalars for
leaves — simple-tree's implicit construction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

from .forest import ROOT_FIELD, Node
from .changeset import make_insert, make_remove
from .schema import (
    ARRAY_FIELD,
    FieldKind,
    FieldSchema,
    LeafKind,
    NodeSchema,
    SchemaRegistry,
    leaf,
    schema_compat,
)


class _LeafType:
    """A leaf schema marker (SchemaFactory.number etc.)."""

    def __init__(self, kind: LeafKind) -> None:
        self.kind = kind
        self.name = kind.value

    def __repr__(self) -> str:
        return f"<leaf {self.name}>"


NUMBER = _LeafType(LeafKind.NUMBER)
STRING = _LeafType(LeafKind.STRING)
BOOLEAN = _LeafType(LeafKind.BOOLEAN)
NULL = _LeafType(LeafKind.NULL)

_LEAF_BY_NAME = {t.name: t for t in (NUMBER, STRING, BOOLEAN, NULL)}


@dataclass
class FieldSpec:
    """One declared field: kind + allowed child types (schema classes or
    leaf markers) — ref simple-tree FieldSchema (fieldSchema.ts)."""

    kind: FieldKind
    types: tuple

    def type_names(self) -> set[str]:
        return {t.name for t in self.types}


def required(*types) -> FieldSpec:
    return FieldSpec(FieldKind.VALUE, types)


def optional(*types) -> FieldSpec:
    return FieldSpec(FieldKind.OPTIONAL, types)


class NodeKind:
    OBJECT = "object"
    ARRAY = "array"


class TreeNodeSchema:
    """A declared node schema; calling it constructs unhydrated content.

    Instances of the reference's schema classes; here one object carries
    the declaration and the constructor."""

    def __init__(self, name: str, kind: str, fields: dict[str, FieldSpec]):
        self.name = name
        self.kind = kind
        self.fields = fields

    def __repr__(self) -> str:
        return f"<schema {self.kind} {self.name!r}>"

    # --------------------------------------------------------- construction
    def __call__(self, *args, **kwargs) -> Node:
        if self.kind == NodeKind.ARRAY:
            (items,) = args if args else (kwargs.pop("items", []),)
            assert not kwargs, "array schema takes a single iterable"
            spec = self.fields[ARRAY_FIELD]
            return Node(type=self.name, fields={
                ARRAY_FIELD: [_content_to_node(spec, it) for it in items]
            })
        assert not args, "object schema takes keyword fields"
        out = Node(type=self.name)
        for key, spec in self.fields.items():
            if key in kwargs:
                v = kwargs.pop(key)
                if spec.kind == FieldKind.SEQUENCE:
                    out.fields[key] = [_content_to_node(spec, it) for it in v]
                else:
                    out.fields[key] = [_content_to_node(spec, v)]
            elif spec.kind == FieldKind.VALUE:
                raise TypeError(f"{self.name}: missing required field {key!r}")
        if kwargs:
            raise TypeError(f"{self.name}: unknown fields {sorted(kwargs)}")
        return out

    # ---------------------------------------------------------------- schema
    def to_node_schema(self) -> NodeSchema:
        return NodeSchema(self.name, {
            k: FieldSchema(s.kind, s.type_names())
            for k, s in self.fields.items()
        })


def _content_to_node(spec: FieldSpec, v: Any) -> Node:
    """Implicit construction (ref simple-tree insertable content): Nodes
    pass through; scalars become leaves; dicts/lists hydrate through the
    spec when exactly one non-leaf type is allowed."""
    if isinstance(v, Node):
        return v
    if isinstance(v, (dict, list)):
        object_types = [
            t for t in spec.types if isinstance(t, TreeNodeSchema)
        ]
        if len(object_types) != 1:
            raise TypeError(
                f"ambiguous implicit construction for {v!r}: "
                f"{len(object_types)} candidate node types"
            )
        t = object_types[0]
        if isinstance(v, list):
            return t(v)
        return t(**v)
    return leaf(v)


def _find_node(root: Node, target: Node) -> list[tuple[str, int]] | None:
    """Locate ``target`` (by object identity) under ``root``; returns its
    path or None when detached (the anchor relocation walk)."""
    stack: list[tuple[Node, list[tuple[str, int]]]] = [(root, [])]
    while stack:
        node, path = stack.pop()
        for key, children in node.fields.items():
            for i, c in enumerate(children):
                if c is target:
                    return path + [(key, i)]
                stack.append((c, path + [(key, i)]))
    return None


class SchemaFactory:
    """Declares schemas in a namespace (ref api/schemaFactory.ts:
    SchemaFactory scoping: type identifiers are '<scope>.<name>')."""

    number = NUMBER
    string = STRING
    boolean = BOOLEAN
    null = NULL

    def __init__(self, scope: str) -> None:
        self.scope = scope
        self._declared: dict[str, TreeNodeSchema] = {}

    def _qualify(self, name: str) -> str:
        return f"{self.scope}.{name}" if self.scope else name

    def object(self, name: str, /, **fields) -> TreeNodeSchema:
        """An object node kind; field values are leaf markers, schema
        objects, or FieldSpec (required(...)/optional(...))."""
        specs = {
            k: (v if isinstance(v, FieldSpec) else required(v))
            for k, v in fields.items()
        }
        return self._declare(TreeNodeSchema(
            self._qualify(name), NodeKind.OBJECT, specs
        ))

    def array(self, name: str, /, *item_types) -> TreeNodeSchema:
        return self._declare(TreeNodeSchema(
            self._qualify(name), NodeKind.ARRAY,
            {ARRAY_FIELD: FieldSpec(FieldKind.SEQUENCE, item_types)},
        ))

    def _declare(self, schema: TreeNodeSchema) -> TreeNodeSchema:
        if schema.name in self._declared:
            raise ValueError(f"schema {schema.name!r} already declared")
        self._declared[schema.name] = schema
        return schema


@dataclass
class TreeViewConfiguration:
    """ref simple-tree TreeViewConfiguration: the root schema."""

    schema: TreeNodeSchema | FieldSpec

    def root_spec(self) -> FieldSpec:
        s = self.schema
        return s if isinstance(s, FieldSpec) else required(s)


def _collect_registry(root: FieldSpec) -> tuple[SchemaRegistry, dict[str, TreeNodeSchema]]:
    """One traversal of the declared schema graph yields both the stored
    SchemaRegistry and the name -> declaration map hydration uses."""
    reg = SchemaRegistry()
    reg.root = FieldSchema(root.kind, root.type_names())
    schemas: dict[str, TreeNodeSchema] = {}

    def walk(spec: FieldSpec) -> None:
        for t in spec.types:
            if isinstance(t, TreeNodeSchema) and t.name not in schemas:
                schemas[t.name] = t
                reg.add(t.to_node_schema())
                for sub in t.fields.values():
                    walk(sub)

    walk(root)
    return reg, schemas


# ---------------------------------------------------------------------------
# Hydrated typed handles
# ---------------------------------------------------------------------------


class TypedNode:
    """A hydrated handle to one node — IDENTITY-stable, not positional
    (simple-tree's hydrated TreeNode; core/treeNodeKernel.ts anchors).

    The handle anchors to the forest Node object at hydration; when edits
    shift its position (a sibling removal, a move), ``_node`` relocates the
    anchor and rebinds the path, so the handle keeps naming the SAME node
    rather than whatever now sits at its old coordinates."""

    def __init__(self, view: "SimpleTreeView", path: list[tuple[str, int]]):
        object.__setattr__(self, "_view", view)
        object.__setattr__(self, "_path", list(path))
        object.__setattr__(
            self, "_anchor", view._channel.forest.node_at(path)
        )

    # ------------------------------------------------------------- plumbing
    def _node(self) -> Node:
        forest = self._view._channel.forest
        try:
            n = forest.node_at(self._path)
        except (IndexError, KeyError):
            n = None
        if n is self._anchor:
            return n
        # Positional drift: relocate the anchored node and rebind.
        path = _find_node(forest.root, self._anchor)
        if path is None:
            raise KeyError("node removed from the document")
        object.__setattr__(self, "_path", path)
        return self._anchor

    def _schema(self) -> TreeNodeSchema:
        return self._view._schemas[self._node().type]

    def _spec(self, key: str) -> FieldSpec:
        try:
            return self._schema().fields[key]
        except KeyError:
            raise AttributeError(
                f"{self._node().type} has no field {key!r}"
            ) from None

    def _read_field(self, key: str):
        spec = self._spec(key)
        children = self._node().fields.get(key, [])
        if spec.kind == FieldKind.SEQUENCE:
            return [
                self._view._hydrate(self._path + [(key, i)])
                for i in range(len(children))
            ]
        if not children:
            return None
        return self._view._hydrate(self._path + [(key, 0)])

    def to_json(self) -> dict:
        return self._node().to_json()

    def __eq__(self, other) -> bool:
        return isinstance(other, TypedNode) and self._anchor is other._anchor

    def __hash__(self) -> int:
        return id(self._anchor)


class TreeObjectNode(TypedNode):
    """Typed attribute access: reads unwrap leaves, writes submit
    changesets (ref simple-tree ObjectNode property proxies)."""

    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        return self._read_field(key)

    def __setattr__(self, key: str, value) -> None:
        spec = self._spec(key)
        if spec.kind == FieldKind.SEQUENCE:
            raise AttributeError(
                f"sequence field {key!r} edits through its array handle"
            )
        node = self._node()
        count = len(node.fields.get(key, []))
        from .changeset import NodeChange
        from .field_kinds import OptionalChange

        fkind = "value" if spec.kind == FieldKind.VALUE else "optional"
        if (
            spec.kind in (FieldKind.VALUE, FieldKind.OPTIONAL)
            and count == 1
            and not isinstance(value, (Node, dict, list))
            and value is not None
            and node.fields[key][0].type == leaf(value).type
        ):
            # Same-leaf-kind overwrite: a nested value SET, not a replace
            # (keeps node identity so concurrent edits merge as value
            # LWW).  Expressed through the field's OWN kind — one field,
            # one rebaser (mixing sequence marks in would kind-conflict).
            self._view.submit_field(self._path, key, OptionalChange(
                kind=fkind, nested=NodeChange(value=(value,)),
            ))
            return
        if value is None and spec.kind == FieldKind.VALUE:
            # Validate BEFORE any submit: a raise must leave no edit behind.
            raise ValueError(f"required field {key!r} cannot be cleared")
        # Whole-content replace rides the OPTIONAL/VALUE field kind
        # (field_kinds.py): one atomic set with later-sequenced-wins
        # semantics.  A remove+insert pair would let two concurrent
        # replaces double-insert (two children in a 0..1 field).
        content = None if value is None else _content_to_node(spec, value)
        self._view.submit_field(self._path, key, OptionalChange(
            kind=fkind,
            set=(content.clone() if content is not None else None,),
        ))


class TreeArrayNode(TypedNode):
    """Sequence verbs of the reference TreeArrayNode (arrayNode.ts)."""

    def _count(self) -> int:
        return len(self._node().fields.get(ARRAY_FIELD, []))

    def __len__(self) -> int:
        return self._count()

    def __getitem__(self, i: int):
        n = self._count()
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._view._hydrate(self._path + [(ARRAY_FIELD, i)])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _content(self, items: Iterable) -> list[Node]:
        spec = self._spec(ARRAY_FIELD)
        return [_content_to_node(spec, it) for it in items]

    def _submit_marks(self, marks: list) -> None:
        self._view.submit_field(self._path, ARRAY_FIELD, marks)

    def insert_at(self, index: int, *items) -> None:
        from .changeset import make_insert_marks

        self._node()  # rebind the path BEFORE building the submit
        self._submit_marks(make_insert_marks(index, self._content(items)))

    def insert_at_start(self, *items) -> None:
        self.insert_at(0, *items)

    def insert_at_end(self, *items) -> None:
        self.insert_at(self._count(), *items)

    def remove_at(self, index: int) -> None:
        from .changeset import make_remove_marks

        self._node()  # rebind before using the path
        self._submit_marks(make_remove_marks(index, 1))

    def remove_range(self, start: int, end: int) -> None:
        from .changeset import make_remove_marks

        self._node()
        self._submit_marks(make_remove_marks(start, end - start))

    def move_to_index(self, dest: int, source: int, count: int = 1) -> None:
        """A REAL move (identity-preserving under concurrency), not
        remove+insert (ref arrayNode.ts moveToIndex/moveRangeToIndex)."""
        from .changeset import make_move_marks

        self._node()
        self._submit_marks(make_move_marks(source, count, dest))

    def move_to_start(self, source: int, count: int = 1) -> None:
        self.move_to_index(0, source, count)

    def move_to_end(self, source: int, count: int = 1) -> None:
        self.move_to_index(self._count(), source, count)

    def values(self) -> list:
        """Leaf values of the items (None for non-leaf items)."""
        return [
            c.value for c in self._node().fields.get(ARRAY_FIELD, [])
        ]


class SimpleTreeView:
    """The schematize gate + typed root (ref schematizingTreeView.ts via
    channel.view_with; compatibility/upgrade semantics shared with
    schema.SchemaView)."""

    def __init__(self, channel, config: TreeViewConfiguration) -> None:
        self._channel = channel
        self._root_spec = config.root_spec()
        self.view_schema, self._schemas = _collect_registry(self._root_spec)

    # ----------------------------------------------------------------- gate
    @property
    def compatibility(self):
        return schema_compat(self.view_schema, self._channel.schema)

    def upgrade_schema(self) -> None:
        c = self.compatibility
        if not c.can_upgrade:
            raise RuntimeError("view schema cannot upgrade the stored schema")
        if not c.is_equivalent:
            self._channel.set_schema(self.view_schema)

    def initialize(self, content) -> None:
        """Set the stored schema AND the root content (ref
        TreeView.initialize): only valid on an empty/compatible document."""
        self.upgrade_schema()
        existing = len(self._channel.forest.root_field)
        if existing:
            self._channel.submit_change(
                make_remove([], ROOT_FIELD, 0, existing)
            )
        self._channel.submit_change(make_insert(
            [], ROOT_FIELD, 0, [_content_to_node(self._root_spec, content)]
        ))

    # ---------------------------------------------------------------- reads
    def _gate(self) -> None:
        if not self.compatibility.can_view:
            raise RuntimeError(
                "view schema cannot read the document's stored schema"
            )

    def _hydrate(self, path: list[tuple[str, int]]):
        node = self._channel.forest.node_at(path)
        schema = self._schemas.get(node.type)
        if schema is None:  # leaf
            return node.value
        if schema.kind == NodeKind.ARRAY:
            return TreeArrayNode(self, path)
        return TreeObjectNode(self, path)

    @property
    def root(self):
        self._gate()
        if not self._channel.forest.root_field:
            return None
        return self._hydrate([(ROOT_FIELD, 0)])

    # --------------------------------------------------------------- writes
    def _submit(self, change) -> None:
        self._gate()
        self._channel.submit_change(change)

    # Every typed-view write wraps its ancestor path steps BY FIELD KIND:
    # a step through a required/optional field encodes as that kind's
    # nested change, a step through an array/root field as sequence marks.
    # One field, one rebaser — a concurrent whole-field replace
    # (OptionalChange) and a nested edit descending through the same field
    # must meet under the same kind (changeset.rebase_node_change).
    def _step_kind(self, path: list, depth: int) -> FieldKind:
        if depth == 0:
            return FieldKind.SEQUENCE  # the document root field
        key, _idx = path[depth]
        parent = self._channel.forest.node_at(path[:depth])
        schema = self._schemas.get(parent.type)
        if schema is None or key not in schema.fields:
            return FieldKind.SEQUENCE
        return schema.fields[key].kind

    def _wrap_path(self, path: list, leaf: "NodeChange") -> "NodeChange":
        from .changeset import Modify, NodeChange, Skip
        from .field_kinds import OptionalChange

        for depth in reversed(range(len(path))):
            key, idx = path[depth]
            kind = self._step_kind(path, depth)
            if kind == FieldKind.SEQUENCE:
                marks: list = [Skip(idx)] if idx else []
                marks.append(Modify(leaf))
                leaf = NodeChange(fields={key: marks})
            else:
                leaf = NodeChange(fields={key: OptionalChange(
                    kind="value" if kind == FieldKind.VALUE else "optional",
                    nested=leaf,
                )})
        return leaf

    def submit_field(self, path: list, field_key: str, field_change) -> None:
        """Submit one field's change with kind-aware ancestor wrapping."""
        from .changeset import NodeChange

        self._submit(self._wrap_path(
            path, NodeChange(fields={field_key: field_change})
        ))


# ---------------------------------------------------------------------------
# The Tree helper namespace (ref simple-tree api/tree.ts)
# ---------------------------------------------------------------------------


class Tree:
    """Static helpers over hydrated nodes, mirroring the reference
    ``Tree``/``TreeBeta`` surface."""

    @staticmethod
    def key(node: TypedNode):
        """The node's key under its parent: field name, or index within an
        array (ref Tree.key)."""
        node._node()  # rebind to the anchor's current position
        fld, idx = node._path[-1]
        if len(node._path) == 1:
            return idx  # root field position
        parent = node._view._channel.forest.node_at(node._path[:-1])
        parent_schema = node._view._schemas.get(parent.type)
        if parent_schema is not None and parent_schema.kind == NodeKind.ARRAY:
            return idx
        return fld

    @staticmethod
    def parent(node: TypedNode):
        """The parent node handle, or None at the root (ref Tree.parent)."""
        node._node()
        if len(node._path) <= 1:
            return None
        return node._view._hydrate(node._path[:-1])

    @staticmethod
    def schema(node: TypedNode) -> TreeNodeSchema:
        return node._schema()

    @staticmethod
    def is_(node, schema: TreeNodeSchema) -> bool:
        return isinstance(node, TypedNode) and node._node().type == schema.name

    @staticmethod
    def status(node: TypedNode) -> str:
        """"inDocument" | "removed" (ref TreeStatus)."""
        try:
            node._node()
            return "inDocument"
        except (IndexError, KeyError):
            return "removed"

    @staticmethod
    def on(node: TypedNode, event: str, fn: Callable[[], None]) -> Callable[[], None]:
        """Subscribe to "nodeChanged" (this node's own content) or
        "treeChanged" (anything in its subtree) — ref TreeNode events
        (api/treeNodeApi.ts).  Returns the unsubscribe handle."""
        if event not in ("nodeChanged", "treeChanged"):
            raise ValueError(f"unknown event {event!r}")
        view = node._view

        def snapshot():
            try:
                n = node._node()  # identity-stable: follows the anchor
            except (IndexError, KeyError):
                return None
            if event == "treeChanged":
                return n.to_json()
            # nodeChanged: the node's own value plus its DIRECT children's
            # identities/values — a leaf child's value IS the object's
            # property in this model (ref nodeChanged fires on property
            # writes, api/treeNodeApi.ts).
            return (n.value, sorted(
                (k, tuple((c.type, c.value) for c in v))
                for k, v in n.fields.items()
            ))

        last = [snapshot()]

        def on_change() -> None:
            cur = snapshot()
            if cur != last[0]:
                last[0] = cur
                fn()

        return view._channel.add_change_listener(on_change)
