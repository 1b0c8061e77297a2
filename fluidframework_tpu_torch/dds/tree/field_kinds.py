"""Modular field kinds: pluggable per-field-kind change algebras.

The port's own copy of ``fluidframework_tpu/dds/tree/field_kinds.py``
(unchanged): the port imports nothing of the JAX package, so it keeps the
host algebra here.

Reference parity: the modular-schema FieldKind registry
(tree/src/feature-libraries/modular-schema/fieldKind.ts,
fieldChangeHandler.ts) — each field kind owns its change representation and
its rebaser (rebase/invert/compose, core/rebase/changeRebaser.ts:41), and
the node-level changeset dispatches per field through the registry.

Three built-in kinds (the reference's default-field-kinds):

- ``sequence``: the mark-list algebra of changeset.py (0..N nodes).  Its
  change TYPE stays the bare ``list[Mark]`` — wire format and device path
  are untouched.
- ``optional``: 0..1 nodes; a change either REPLACES the whole field
  content (``set``, later-sequenced-wins) or edits the resident node
  (``nested``).  Ref feature-libraries/optional-field/.
- ``value``: exactly-1 node; ``optional`` restricted to non-empty sets.

The registry is open (``register_field_kind``) — a schema extension can
ship its own kind with its own rebaser, the reference's extensibility
contract.

Compose: each kind also implements ``compose(a, b)`` (b reads a's output
context; result reads a's input context), giving the full ChangeRebaser
triple.  Sequence compose covers Skip/Insert/Remove/Modify; composing
across moves raises (the trunk pipeline never composes — commits stay
element lists — so compose is the offline squash/undo tool).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .forest import Node

# Module-level import is safe (changeset never imports field_kinds at module
# scope); the previous per-call lazy imports in the rebase/compose hot path
# paid importlib machinery on every field dispatch.
from .changeset import (
    NodeChange,
    apply_marks,
    apply_node_change,
    change_from_json,
    change_to_json,
    compose_node_change,
    invert_marks,
    invert_node_change,
    marks_from_json,
    marks_to_json,
    rebase_marks,
    rebase_node_change,
)

# ---------------------------------------------------------------------------
# Optional / value field changes
# ---------------------------------------------------------------------------


@dataclass
class OptionalChange:
    """Change to a 0..1 field.  Exactly one of:

    - ``set``: ``(new,)`` before apply, ``(new, prior)`` after (enriched
      for invert) — new/prior are Node or None (None = empty field);
    - ``nested``: a NodeChange editing the resident node.
    """

    kind: str = "optional"
    set: tuple | None = None
    nested: Any | None = None  # NodeChange

    def is_empty(self) -> bool:
        return self.set is None and (self.nested is None or self.nested.is_empty())


class FieldKind:
    """One field kind's change algebra (ref fieldChangeHandler.ts)."""

    name: str

    def rebase(self, a, b, a_after: bool):
        raise NotImplementedError

    def invert(self, change):
        raise NotImplementedError

    def compose(self, a, b):
        raise NotImplementedError

    def apply(self, nodes: list[Node], change) -> None:
        raise NotImplementedError

    def to_json(self, change):
        raise NotImplementedError

    def from_json(self, data):
        raise NotImplementedError

    def is_empty(self, change) -> bool:
        raise NotImplementedError

    def clone(self, change):
        return self.from_json(self.to_json(change))


class SequenceFieldKind(FieldKind):
    """The mark-list algebra (changeset.py) behind the registry facade."""

    name = "sequence"
    # Sequence-FAMILY marker: this kind (and the pooled columnar kind in
    # mark_pool.py) can expose a bare mark-list view for the fate-map
    # consumers (constraint paths, mixed-kind compose).
    is_sequence = True

    def as_mark_list(self, change):
        return change

    def clone(self, change):
        return list(change)  # shallow, matching the historical copy

    def rebase(self, a, b, a_after: bool):
        return rebase_marks(a, b, a_after)

    def invert(self, change):
        return invert_marks(change)

    def compose(self, a, b):
        return compose_marks(a, b)

    def apply(self, nodes: list[Node], change) -> None:
        apply_marks(nodes, change)

    def to_json(self, change):
        return marks_to_json(change)  # bare list: wire-compatible

    def from_json(self, data):
        return marks_from_json(data)

    def is_empty(self, change) -> bool:
        return not change


class OptionalFieldKind(FieldKind):
    """0..1 field: whole-content replace with later-wins conflict rule
    (ref feature-libraries/optional-field/optionalField.ts)."""

    name = "optional"

    def _mk(self, **kw) -> OptionalChange:
        return OptionalChange(kind=self.name, **kw)

    def clone(self, change: OptionalChange) -> OptionalChange:
        return self.from_json(self.to_json(change))

    def rebase(self, a: OptionalChange, b: OptionalChange, a_after: bool):
        """Always returns a FRESH change object — a rebased pending form is
        later apply-enriched in place, and sharing structure with the
        original shipped commit would rewrite its repair data."""
        if b.set is not None:
            # b replaced the field content.
            if a.set is not None:
                # Concurrent sets: the later-sequenced one wins.
                return self.clone(a) if a_after else self._mk()
            # a edited a node b replaced: target gone.
            return self._mk()
        if b.nested is not None and a.nested is not None:
            return self._mk(
                nested=rebase_node_change(a.nested, b.nested, a_after)
            )
        return self.clone(a)

    def invert(self, change: OptionalChange):
        if change.is_empty():  # rebase can void a change (conflict loser)
            return self._mk()
        if change.set is not None:
            assert len(change.set) == 2, "invert of unapplied optional set"
            new, prior = change.set
            return self._mk(set=(
                prior.clone() if prior is not None else None,
                new.clone() if new is not None else None,
            ))
        return self._mk(nested=invert_node_change(change.nested))

    def compose(self, a: OptionalChange, b: OptionalChange):
        if b.set is not None:
            new = b.set[0]
            if a.set is not None and len(a.set) == 2:
                prior = a.set[1]
            elif len(b.set) == 2:
                # b's recorded prior lives in a's OUTPUT context; repair
                # data of the composed change must be in a's INPUT context,
                # so unwind a's nested edit from it (possible exactly when
                # a was applied/enriched — the squash-of-applied case).
                prior = b.set[1]
                if prior is not None and a.nested is not None:
                    prior = prior.clone()
                    apply_node_change(prior, _safe_invert(a.nested))
            else:
                prior = None
            out = (new, prior) if (
                len(b.set) == 2 or (a.set is not None and len(a.set) == 2)
            ) else (new,)
            return self._mk(set=tuple(
                n.clone() if isinstance(n, Node) else n for n in out
            ))
        if a.set is not None:
            # set then edit-the-new-content: fold the edit into the content.
            new = a.set[0].clone() if a.set[0] is not None else None
            if b.nested is not None:
                assert new is not None, "nested edit composed onto a clear"
                apply_node_change(new, b.nested)
            return self._mk(set=(new,) + tuple(a.set[1:]))
        if a.nested is not None and b.nested is not None:
            return self._mk(nested=compose_node_change(a.nested, b.nested))
        return a if b.is_empty() else b

    def apply(self, nodes: list[Node], change: OptionalChange) -> None:
        if change.is_empty():  # rebase can void a change (conflict loser)
            return
        if change.set is not None:
            # A schema-violating writer (raw sequence ops) can leave >1
            # node in a 0..1 field; a set COLLAPSES the field to its
            # content (prior records the first resident — the schema-legal
            # one — for invert).
            prior = nodes[0] if nodes else None
            new = change.set[0]
            change.set = (new, prior)  # enrich in place (invertibility)
            nodes[:] = [new.clone()] if new is not None else []
            return
        assert nodes, "nested change on an empty optional field"
        apply_node_change(nodes[0], change.nested)

    def to_json(self, change: OptionalChange):
        out: dict[str, Any] = {"k": self.name}
        if change.set is not None:
            out["set"] = [
                n.to_json() if n is not None else None for n in change.set
            ]
        if change.nested is not None:
            out["nested"] = change_to_json(change.nested)
        return out

    def from_json(self, data):
        return self._mk(
            set=tuple(
                Node.from_json(n) if n is not None else None
                for n in data["set"]
            )
            if "set" in data
            else None,
            nested=change_from_json(data["nested"]) if "nested" in data else None,
        )

    def is_empty(self, change: OptionalChange) -> bool:
        return change.is_empty()


class ValueFieldKind(OptionalFieldKind):
    """Exactly-1 field: optional restricted to non-empty content
    (ref default-field-kinds required field)."""

    name = "value"

    def apply(self, nodes: list[Node], change: OptionalChange) -> None:
        if change.set is not None:
            assert change.set[0] is not None, "value field cannot be cleared"
        super().apply(nodes, change)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

FIELD_KINDS: dict[str, FieldKind] = {}


def register_field_kind(kind: FieldKind) -> FieldKind:
    """Install a field kind (open registry — ref FieldKindRegistry)."""
    FIELD_KINDS[kind.name] = kind
    return kind


SEQUENCE = register_field_kind(SequenceFieldKind())
OPTIONAL = register_field_kind(OptionalFieldKind())
VALUE = register_field_kind(ValueFieldKind())


def kind_of(field_change) -> FieldKind:
    """Resolve a field change object to its kind: a bare list is the
    sequence kind (wire/back compat); tagged changes carry their kind."""
    if isinstance(field_change, list):
        return SEQUENCE
    return FIELD_KINDS[field_change.kind]


def field_change_to_json(fc):
    return kind_of(fc).to_json(fc)


def field_change_from_json(data):
    if isinstance(data, list):
        return SEQUENCE.from_json(data)
    return FIELD_KINDS[data["k"]].from_json(data)


def _safe_invert(nested):
    """Invert a nested NodeChange for repair-data context transport; an
    unenriched change (compose of never-applied changes, which carries no
    repair data to protect) inverts to the identity instead of asserting."""
    try:
        return invert_node_change(nested)
    except AssertionError:
        return NodeChange()


# ---------------------------------------------------------------------------
# Sequence compose (Skip/Insert/Remove/Modify; moves unsupported)
# ---------------------------------------------------------------------------


def compose_marks(a: list, b: list) -> list:
    """Compose mark lists: b reads a's OUTPUT context; the result reads a's
    INPUT context and is equivalent to applying a then b.

    Covers Skip/Insert/Remove/Modify (composing across moves raises —
    the trunk pipeline never composes, see module docstring).
    """
    from .changeset import (
        Insert,
        Modify,
        MoveIn,
        MoveOut,
        Remove,
        Skip,
        _emit,
        apply_node_change,
        clone_change,
        compose_node_change,
    )

    if any(isinstance(m, (MoveIn, MoveOut)) for m in a + b):
        raise NotImplementedError("compose across moves")

    # a's output as anchored items: ("in", in_pos, nested) kept inputs,
    # ("new", boundary_in_pos, node) inserted content.  a's removes anchor
    # at their input position.
    items: list[tuple] = []
    removed: list[tuple[int, Remove]] = []  # (in_pos, Remove(1, detached))
    in_pos = 0
    for m in a:
        if isinstance(m, Skip):
            for _ in range(m.count):
                items.append(("in", in_pos, None))
                in_pos += 1
        elif isinstance(m, Modify):
            items.append(("in", in_pos, m.change))
            in_pos += 1
        elif isinstance(m, Remove):
            for off in range(m.count):
                det = m.detached[off] if m.detached is not None else None
                removed.append((in_pos, Remove(1, [det] if det is not None else None)))
                in_pos += 1
        elif isinstance(m, Insert):
            for n in m.content:
                items.append(("new", in_pos, n.clone()))
    tail_in = in_pos  # items beyond a's marks keep 1:1 (implicit Skip)

    def item(i: int) -> tuple:
        if i < len(items):
            return items[i]
        return ("in", tail_in + (i - len(items)), None)

    # Walk b over the item list, producing placements anchored in a's INPUT
    # coordinates: (in_boundary, order, payload-mark).
    placements: list[tuple[int, int, int, Any]] = []
    seq = 0

    def anchor_of(i: int) -> int:
        kind, pos, _x = item(i)
        return pos

    out_pos = 0
    # Placements always carry CLONES of a's/b's nested changes and content:
    # applying the composed change enriches nested changes and repair data
    # in place, and sharing structure with the inputs would silently mutate
    # the original commits (applied_log / trunk), corrupting their invert.
    for m in b:
        seq += 1
        if isinstance(m, Skip):
            for _ in range(m.count):
                kind, pos, nested = item(out_pos)
                if kind == "in" and nested is not None:
                    placements.append((pos, 1, seq, Modify(clone_change(nested))))
                elif kind == "new":
                    placements.append((pos, 0, seq, Insert([item(out_pos)[2]])))
                out_pos += 1
        elif isinstance(m, Modify):
            kind, pos, nested = item(out_pos)
            if kind == "in":
                change = (
                    compose_node_change(nested, m.change)
                    if nested is not None
                    else clone_change(m.change)
                )
                placements.append((pos, 1, seq, Modify(change)))
            else:  # b edits a-inserted content: fold into the insert
                node = item(out_pos)[2]
                apply_node_change(node, clone_change(m.change))
                placements.append((pos, 0, seq, Insert([node])))
            out_pos += 1
        elif isinstance(m, Remove):
            for off in range(m.count):
                kind, pos, nested = item(out_pos)
                det = m.detached[off] if m.detached is not None else None
                if kind == "in":
                    if det is not None:
                        det = det.clone()
                        if nested is not None:
                            # b captured the node AFTER a's Modify; composed
                            # repair data must be a's-input-context content.
                            apply_node_change(det, _safe_invert(nested))
                    placements.append((
                        pos, 1, seq,
                        Remove(1, [det] if det is not None else None),
                    ))
                # b removing a-inserted content: both cancel (no mark).
                out_pos += 1
        elif isinstance(m, Insert):
            placements.append((
                anchor_of(out_pos), 0, seq,
                Insert([n.clone() for n in m.content]),
            ))
    # a-output items b never reached keep their a-effects.
    for i in range(out_pos, len(items)):
        kind, pos, nested = item(i)
        if kind == "new":
            placements.append((pos, 0, seq + 1, Insert([items[i][2]])))
        elif nested is not None:
            placements.append((pos, 1, seq + 1, Modify(clone_change(nested))))
    for pos, rm in removed:
        placements.append((pos, 1, 0, rm))

    placements.sort(key=lambda t: (t[0], t[1], t[2]))
    out: list = []
    cursor = 0
    for pos, _ko, _sq, mark in placements:
        if pos > cursor:
            _emit(out, Skip(pos - cursor))
            cursor = pos
        _emit(out, mark)
        if isinstance(mark, (Remove, Modify)):
            cursor += mark.count if isinstance(mark, Remove) else 1
    return out
