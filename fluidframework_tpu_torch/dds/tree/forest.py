"""Tree state store: object forest + columnar uniform chunks.

The port's own copy of ``fluidframework_tpu/dds/tree/forest.py``
(unchanged): the port imports nothing of the JAX package, so it keeps the
host algebra here.

Reference parity: the object forest (tree/src/feature-libraries/object-forest/)
is the general-purpose mutable store; ``UniformChunk``
(feature-libraries/chunked-forest/uniformChunk.ts:42) is the reference's
columnar, shape-deduplicated value representation — reproduced here as a
numpy-backed column store because it is exactly the layout TPU kernels want
(see ops/tree_kernel.py for the batched value-update kernels over chunk
columns).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np


@dataclass
class Node:
    """One tree node: a type tag, an optional leaf value, and named fields
    each holding an ordered sequence of child nodes (every field is a
    sequence; value/optional fields are schema-constrained sequences, the
    same unification the reference's modular schema uses)."""

    type: str
    value: Any = None
    fields: dict[str, list["Node"]] = field(default_factory=dict)

    # ------------------------------------------------------------------ codec
    def to_json(self) -> dict:
        out: dict[str, Any] = {"t": self.type}
        if self.value is not None:
            out["v"] = self.value
        # Canonical form: an EMPTIED sequence field is identical to one that
        # never existed (the reference's forests prune empty fields the same
        # way), so replicas that took different routes to the same tree
        # serialize identically — and match the columnar materialization,
        # which has no rows to represent an empty field with.
        present = {
            k: [c.to_json() for c in children]
            for k, children in self.fields.items()
            if children
        }
        if present:
            out["f"] = present
        return out

    @staticmethod
    def from_json(data: dict) -> "Node":
        return Node(
            type=data["t"],
            value=data.get("v"),
            fields={
                k: [Node.from_json(c) for c in children]
                for k, children in data.get("f", {}).items()
            },
        )

    def clone(self) -> "Node":
        # Structural clone (no JSON codec pass — this sits on the trunk
        # apply hot path).  Empty fields prune, matching the canonical
        # to_json form; non-scalar leaf values deep-copy via the codec
        # (they are rare; scalars dominate).
        v = self.value
        if not isinstance(v, (int, float, str, bool, type(None))):
            import json as _json

            v = _json.loads(_json.dumps(v))
        return Node(
            type=self.type,
            value=v,
            fields={
                k: [c.clone() for c in children]
                for k, children in self.fields.items()
                if children
            },
        )

    def child(self, field_key: str, index: int) -> "Node":
        return self.fields[field_key][index]

    def equal(self, other: "Node") -> bool:
        return self.to_json() == other.to_json()


ROOT_FIELD = ""


class Forest:
    """The document's tree state: a virtual root node whose ``ROOT_FIELD``
    sequence holds the root content. Mutated only through changeset apply
    (changeset.apply_node_change) so every replica performs identical
    transitions."""

    def __init__(self) -> None:
        self.root = Node(type="__root__")
        self.root.fields[ROOT_FIELD] = []

    # ------------------------------------------------------------------ views
    @property
    def root_field(self) -> list[Node]:
        return self.root.fields.setdefault(ROOT_FIELD, [])

    def node_at(self, path: list[tuple[str, int]]) -> Node:
        """Resolve a path of (field_key, index) steps from the virtual root."""
        node = self.root
        for key, idx in path:
            node = node.fields[key][idx]
        return node

    def iter_nodes(self) -> Iterator[tuple[list[tuple[str, int]], Node]]:
        """Depth-first cursor over (path, node) — the forest cursor analog
        (reference ITreeCursor over object forest)."""

        def walk(node: Node, path: list[tuple[str, int]]):
            for key, children in node.fields.items():
                for i, child in enumerate(children):
                    cpath = path + [(key, i)]
                    yield cpath, child
                    yield from walk(child, cpath)

        yield from walk(self.root, [])

    # ------------------------------------------------------------------ codec
    def to_json(self) -> dict:
        return {"root": [n.to_json() for n in self.root_field]}

    def load_json(self, data: dict) -> None:
        self.root = Node(type="__root__")
        self.root.fields[ROOT_FIELD] = [Node.from_json(n) for n in data["root"]]

    def equal(self, other: "Forest") -> bool:
        return self.to_json() == other.to_json()


# ---------------------------------------------------------------------------
# Uniform chunks: columnar representation of shape-uniform subtree arrays
# ---------------------------------------------------------------------------

def _encode_column(col: list) -> Any:
    """ndarray-back a column only when it is type-homogeneous: all int or
    all float (a mixed column through np.asarray would coerce ints to floats
    and change values across a summary roundtrip)."""
    if col and all(type(v) is int for v in col):
        return np.asarray(col, dtype=np.int64)
    if col and all(type(v) is float for v in col):
        return np.asarray(col, dtype=np.float64)
    return list(col)


@dataclass
class UniformChunk:
    """A run of sibling subtrees that all share one shape, stored as value
    columns (one column per leaf position in the shape) — the reference's
    chunked-forest layout (uniformChunk.ts:42) and the natural device layout:
    numeric columns are contiguous ndarrays a kernel can gather/scatter.

    ``shape``   — the per-subtree template as a Node with leaf values elided
                  (value slots marked by leaf type tag).
    ``columns`` — list (one per leaf slot, in cursor order) of length-N
                  arrays/lists of values.
    """

    shape: Node
    columns: list[Any]
    count: int

    @staticmethod
    def try_encode(nodes: list[Node]) -> "UniformChunk | None":
        """Columnarize if every node shares the same shape (type structure);
        returns None when the run is not uniform."""
        if len(nodes) < 2:
            return None
        template = _shape_of(nodes[0])
        for n in nodes[1:]:
            if _shape_of(n).to_json() != template.to_json():
                return None
        slots = [[] for _ in range(_leaf_count(template))]
        for n in nodes:
            for i, v in enumerate(_leaf_values(n)):
                slots[i].append(v)
        columns: list[Any] = [_encode_column(col) for col in slots]
        return UniformChunk(shape=template, columns=columns, count=len(nodes))

    def decode(self) -> list[Node]:
        # One bulk host conversion per COLUMN (tolist == elementwise
        # .item(): python scalars out), not one sync per element per row —
        # the per-element form is the jit-host-sync-loop antipattern
        # fftpu-check flags, and decode() runs once per chunk per summary
        # load with count x columns elements.
        cols = [
            np.asarray(c).tolist() if isinstance(c, np.ndarray) else c
            for c in self.columns
        ]
        out = []
        for i in range(self.count):
            out.append(_fill_shape(self.shape, iter(c[i] for c in cols)))
        return out

    def to_json(self) -> dict:
        return {
            "shape": self.shape.to_json(),
            "count": self.count,
            "columns": [
                c.tolist() if isinstance(c, np.ndarray) else c for c in self.columns
            ],
        }

    @staticmethod
    def from_json(data: dict) -> "UniformChunk":
        return UniformChunk(
            shape=Node.from_json(data["shape"]),
            count=data["count"],
            columns=[_encode_column(c) for c in data["columns"]],
        )


def _shape_of(node: Node) -> Node:
    """Type structure with values elided. Field keys are traversed in sorted
    order everywhere in this codec: shape equality is dict-order-insensitive,
    so the value-slot ordering must be too or columns misalign between
    siblings built with different field insertion orders."""
    return Node(
        type=node.type,
        value=None,
        fields={k: [_shape_of(c) for c in node.fields[k]] for k in sorted(node.fields)},
    )


def _leaf_count(shape: Node) -> int:
    # EVERY node owns a value slot (a node may carry both a value and
    # children); structural nodes just column None.
    n = 1
    for k in sorted(shape.fields):
        for c in shape.fields[k]:
            n += _leaf_count(c)
    return n


def _leaf_values(node: Node) -> list[Any]:
    out = [node.value]
    for k in sorted(node.fields):
        for c in node.fields[k]:
            out.extend(_leaf_values(c))
    return out


def _fill_shape(shape: Node, values: Iterator[Any]) -> Node:
    value = next(values)
    return Node(
        type=shape.type,
        value=value,
        fields={
            k: [_fill_shape(c, values) for c in shape.fields[k]]
            for k in sorted(shape.fields)
        },
    )


def encode_field_chunked(nodes: list[Node]) -> list[dict]:
    """Summary codec for a field: greedy runs of shape-uniform siblings become
    uniform chunks, the rest stay plain nodes (reference forest-summary with
    incremental chunk reuse is approximated by whole-field chunk encode)."""
    out: list[dict] = []
    i = 0
    while i < len(nodes):
        j = i + 1
        template = _shape_of(nodes[i]).to_json()
        while j < len(nodes) and _shape_of(nodes[j]).to_json() == template:
            j += 1
        chunk = UniformChunk.try_encode(nodes[i:j]) if j - i >= 4 else None
        if chunk is not None:
            out.append({"chunk": chunk.to_json()})
        else:
            out.extend({"node": n.to_json()} for n in nodes[i:j])
        i = j
    return out


def decode_field_chunked(entries: list[dict]) -> list[Node]:
    out: list[Node] = []
    for e in entries:
        if "chunk" in e:
            out.extend(UniformChunk.from_json(e["chunk"]).decode())
        else:
            out.append(Node.from_json(e["node"]))
    return out
