"""The port's own copy of ``fluidframework_tpu/dds/property_dds.py`` (no JAX in it).

PropertyDDS seed: a typed property tree over OT changesets.

Reference parity: `experimental/PropertyDDS/packages/` — property-dds
(SharedPropertyTree), property-changeset (SerializedChangeSet algebra),
property-properties (the typed property model).  The reference's data
model: a document is a tree of TYPED properties — primitive leaves
(Int32/Float64/String/Bool) and ``NodeProperty`` containers — mutated by
changesets with ``insert``/``modify``/``remove`` sections keyed by type id
then property name, nested recursively for containers.

This seed reproduces that model on this repo's SharedOT base
(MSN-windowed transform, dds/ot.py): a changeset is the OT op;
``transform`` implements the property-changeset rebase rules —

- edits under a concurrently removed property drop (the subtree is gone);
- insert/insert on one name: the later-sequenced insert wins (LWW);
- modify/modify on one primitive: later wins; on one container: recurse;
- disjoint names commute untouched.

Serialized state/changeset shapes follow the reference's nesting
(`{"insert": {typeid: {name: payload}}, "modify": …, "remove": [names]}`),
so property-changeset-shaped documents read naturally.
"""

from __future__ import annotations

import json
from typing import Any

from .ot import SharedOTChannel

NODE_TYPE = "NodeProperty"
PRIMITIVES = {"Int32", "Float64", "String", "Bool"}


# ---------------------------------------------------------------- documents
# state = {name: prop}; prop = {"typeid": t, "value": v} (primitive)
#                        | {"typeid": "NodeProperty", "children": {…}}


def _prop(typeid: str, payload: Any) -> dict:
    if typeid == NODE_TYPE:
        return {"typeid": NODE_TYPE, "children": dict(payload or {})}
    assert typeid in PRIMITIVES, f"unknown property type {typeid!r}"
    return {"typeid": typeid, "value": payload}


# ---------------------------------------------------------------- changesets


def make_insert(path: list[str], typeid: str, payload: Any = None) -> dict:
    """Insert a property at ``path`` (last part = new name)."""
    cs: dict = {"insert": {typeid: {path[-1]: payload}}}
    return _nest(path[:-1], cs)


def make_remove(path: list[str]) -> dict:
    return _nest(path[:-1], {"remove": [path[-1]]})


def make_modify(path: list[str], typeid: str, value: Any) -> dict:
    return _nest(path[:-1], {"modify": {typeid: {path[-1]: value}}})


def _nest(prefix: list[str], cs: dict) -> dict:
    for name in reversed(prefix):
        cs = {"modify": {NODE_TYPE: {name: cs}}}
    return cs


def apply_changeset(state: dict | None, cs: dict) -> dict:
    """Functional apply of one changeset to a {name: prop} map."""
    out = dict(state or {})
    for name in cs.get("remove", []):
        out.pop(name, None)
    for typeid, entries in cs.get("insert", {}).items():
        for name, payload in entries.items():
            out[name] = _prop(typeid, payload)
    for typeid, entries in cs.get("modify", {}).items():
        for name, change in entries.items():
            cur = out.get(name)
            if cur is None or cur["typeid"] != typeid:
                continue  # target gone (post-rebase residue): no-op
            if typeid == NODE_TYPE:
                out[name] = {
                    "typeid": NODE_TYPE,
                    "children": apply_changeset(cur["children"], change),
                }
            else:
                out[name] = {"typeid": typeid, "value": change}
    return out


def transform_changeset(input_cs: dict | None, earlier: dict | None) -> dict | None:
    """Rebase ``input_cs`` over ``earlier`` (applied first) — the
    property-changeset rebase rules (see module docstring)."""
    if input_cs is None or earlier is None:
        return input_cs
    removed = set(earlier.get("remove", []))
    e_ins = {
        name: typeid
        for typeid, entries in earlier.get("insert", {}).items()
        for name in entries
    }
    e_mod: dict[str, tuple[str, Any]] = {
        name: (typeid, change)
        for typeid, entries in earlier.get("modify", {}).items()
        for name, change in entries.items()
    }

    out: dict = {}
    rm = [n for n in input_cs.get("remove", []) if n not in removed]
    if rm:
        out["remove"] = rm
    for typeid, entries in input_cs.get("insert", {}).items():
        # Later insert wins over an earlier insert OR remove of the name.
        kept = dict(entries)
        if kept:
            out.setdefault("insert", {})[typeid] = kept
    for typeid, entries in input_cs.get("modify", {}).items():
        kept = {}
        for name, change in entries.items():
            if name in removed:
                continue  # subtree gone
            if name in e_ins and e_ins[name] != typeid:
                continue  # replaced by a different type
            if typeid == NODE_TYPE and name in e_mod and e_mod[name][0] == NODE_TYPE:
                nested = transform_changeset(change, e_mod[name][1])
                if nested:
                    kept[name] = nested
                continue
            # Primitive modify-modify: the later op simply applies after
            # (LWW by order) — keep as-is.
            kept[name] = change
        if kept:
            out.setdefault("modify", {})[typeid] = kept
    return out or None


# ------------------------------------------------------------------ channel


class PropertyTreeChannel(SharedOTChannel):
    """SharedPropertyTree seed (ref property-dds/src/propertyTree.ts)."""

    channel_type = "propertyTree"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id, initial={})

    def apply_core(self, state: Any, cs: dict | None) -> Any:
        return apply_changeset(state, cs) if cs else state

    def transform(self, input_op, earlier):
        return transform_changeset(input_op, earlier)

    # ------------------------------------------------------------ public API
    def root(self) -> dict:
        return self.state

    def resolve_path(self, path: list[str]) -> dict | None:
        """The property at a name path, or None (ref resolvePath)."""
        node: Any = {"typeid": NODE_TYPE, "children": self.state}
        for name in path:
            if node is None or node["typeid"] != NODE_TYPE:
                return None
            node = node["children"].get(name)
        return node

    def value_at(self, path: list[str]) -> Any:
        prop = self.resolve_path(path)
        return None if prop is None else prop.get("value")

    def insert_property(self, path: list[str], typeid: str, payload: Any = None) -> None:
        json.dumps(payload)
        self.apply(make_insert(path, typeid, payload))

    def remove_property(self, path: list[str]) -> None:
        self.apply(make_remove(path))

    def set_value(self, path: list[str], value: Any) -> None:
        prop = self.resolve_path(path)
        assert prop is not None and prop["typeid"] in PRIMITIVES, path
        json.dumps(value)
        self.apply(make_modify(path, prop["typeid"], value))


class _PropertyTreeFactory:
    channel_type = PropertyTreeChannel.channel_type

    def create(self, channel_id: str) -> PropertyTreeChannel:
        return PropertyTreeChannel(channel_id)


PropertyTreeFactory = _PropertyTreeFactory()
