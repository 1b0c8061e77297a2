"""Leaf node kinds and constructors of SharedTree content.

The part of ``fluidframework_tpu/dds/tree/schema.py`` that builds content
(``LeafKind``, ``leaf``, ``build_node``); the stored-schema registry and the
typed view layer are not ported.
"""

from __future__ import annotations

from enum import Enum
from typing import Any

from .forest import Node


class LeafKind(str, Enum):
    NUMBER = "number"
    STRING = "string"
    BOOLEAN = "boolean"
    NULL = "null"


LEAF_TYPES = {k.value for k in LeafKind}


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
