"""The port's own copy of ``fluidframework_tpu/dds/ot_json1.py`` (no JAX in it).

SharedJson1: the sharejs ot-json1 WIRE-compatible OT type.

Reference parity: `experimental/dds/ot/sharejs/json1/src/json1.ts:28`
(SharedJson1 over the npm ``ot-json1`` library) — the reference's own code
is a thin wrapper; the OT type there lives in the library.  Here the type
is implemented from scratch against ot-json1's documented operation
format, so wire ops interoperate:

- an op is a DESCENT LIST: scalar parts descend (object key / list
  index), dict parts are components at the current path, nested lists are
  sibling branches from the current path;
- components: ``{"i": value}`` insert, ``{"r": value-or-true}`` remove,
  ``{"r":…, "i":…}`` replace, ``{"p": slot}`` pick up, ``{"d": slot}``
  drop (a pick/drop pair is a move);
- apply is two-phase: picks/removes first (right-to-left, so sibling
  list indices stay stable), then drops/inserts (left-to-right) against
  the post-pick document — drop/insert paths read in that context.

Embedded edits (``e``/``es``/``ena`` subtypes) are not supported (raise);
this repo's SharedString is the rich-text surface.

Transform: single-target ops translate onto the repo's JSON OT algebra
(dds/ot.py — annihilation, list shifts, left priority) and translate
back, so the transform laws there carry over.  Ops containing moves
transform conservatively: a move rebased over an overlapping concurrent
op drops (the reference's transformNoConflict likewise refuses genuinely
conflicting moves); a concurrent MOVE transforms later ops as its
remove+insert decomposition.
"""

from __future__ import annotations

import json
from typing import Any

from .ot import SharedOTChannel, _apply_json, _transform_json

Path = tuple


# ------------------------------------------------------------------ builders


def insert_op(path: list, value: Any) -> list:
    return [*path, {"i": value}]


def remove_op(path: list, value: Any = True) -> list:
    return [*path, {"r": value}]


def replace_op(path: list, old: Any, new: Any) -> list:
    return [*path, {"r": old, "i": new}]


def move_op(src: list, dst: list) -> list:
    """ot-json1 moveOp: shared-prefix descent with a pick and a drop
    branch."""
    k = 0
    while k < len(src) and k < len(dst) and src[k] == dst[k]:
        k += 1
    prefix, s_rest, d_rest = list(src[:k]), list(src[k:]), list(dst[k:])
    return [*prefix, [*s_rest, {"p": 0}], [*d_rest, {"d": 0}]]


# -------------------------------------------------------------------- parse


def flatten(op: list | None) -> list[tuple[Path, dict]]:
    """Descent list -> [(path, component)] in document order."""
    if op is None:
        return []
    out: list[tuple[Path, dict]] = []

    def walk(parts: list, path: tuple) -> None:
        cur = list(path)
        for part in parts:
            if isinstance(part, (str, int)):
                cur.append(part)
            elif isinstance(part, dict):
                out.append((tuple(cur), part))
            elif isinstance(part, list):
                walk(part, tuple(cur))
            else:
                raise ValueError(f"bad op part {part!r}")

    walk(op, ())
    return out


def _get(node: Any, path: Path) -> Any:
    for part in path:
        node = node[part]
    return node


def _set_at(state: Any, path: Path, value: Any, insert: bool) -> Any:
    return _apply_json(
        state, {"t": "insert" if insert else "replace", "p": list(path), "v": value}
    )


def _remove_at(state: Any, path: Path) -> Any:
    return _apply_json(state, {"t": "remove", "p": list(path)})


def apply_json1(state: Any, op: list | None) -> Any:
    """Two-phase json1 apply (see module docstring)."""
    entries = flatten(op)
    for _p, comp in entries:
        if "e" in comp or "es" in comp or "ena" in comp:
            raise NotImplementedError("json1 embedded edits unsupported")
    slots: dict[int, Any] = {}
    # Phase 1: removes and pick-ups, right-to-left.
    for path, comp in reversed(entries):
        if "p" in comp:
            slots[comp["p"]] = _get(state, path)
            state = _remove_at(state, path)
        elif "r" in comp:
            if not path:
                state = None
            else:
                state = _remove_at(state, path)
    # Phase 2: inserts and drops, left-to-right (post-pick coordinates).
    for path, comp in entries:
        if "d" in comp:
            value = slots.pop(comp["d"])
            state = value if not path else _set_at(state, path, value, insert=True)
        elif "i" in comp:
            v = comp["i"]
            if not path:
                state = v
            else:
                state = _set_at(state, path, v, insert=True)
    return state


# ---------------------------------------------------------------- transform


def _to_internal(op: list | None) -> dict | None | str:
    """Single-target json1 op -> internal JSON OT op; "move" when the op
    contains pick/drop components; "multi" for multi-target branch ops
    (these APPLY fine but transform conservatively — see
    transform_json1)."""
    entries = flatten(op)
    if not entries:
        return None
    if any("p" in c or "d" in c for _p, c in entries):
        return "move"
    if len(entries) != 1:
        return "multi"
    path, comp = entries[0]
    if "r" in comp and "i" in comp:
        return {"t": "replace", "p": list(path), "v": comp["i"]}
    if "i" in comp:
        return {"t": "insert", "p": list(path), "v": comp["i"]}
    if "r" in comp:
        return {"t": "remove", "p": list(path)}
    return "multi"  # unknown component: conservative, never crash


def _to_json1(op: dict | None) -> list | None:
    if op is None:
        return None
    t, path, v = op["t"], op["p"], op.get("v")
    if t == "insert":
        return insert_op(path, v)
    if t == "remove":
        return remove_op(path)
    return replace_op(path, True, v)


def _move_decomposition(op: list) -> list[dict]:
    """A move op as its remove+insert internal pair (for transforming
    OTHER ops over a sequenced move)."""
    out = []
    for path, comp in flatten(op):
        if "p" in comp or "r" in comp:
            out.append({"t": "remove", "p": list(path)})
    for path, comp in flatten(op):
        if "d" in comp or "i" in comp:
            out.append({"t": "insert", "p": list(path), "v": comp.get("i")})
    return out


def transform_json1(input_op: list | None, earlier: list | None) -> list | None:
    if input_op is None or earlier is None:
        return input_op
    ikind = _to_internal(input_op)
    ekind = _to_internal(earlier)
    if ikind == "multi" or ekind == "multi":
        # Multi-target branch ops apply, but transforming sequential op
        # programs against each other needs the two-sided bridge this
        # windowed model does not carry; refusing deterministically (every
        # replica drops the same later-sequenced op) keeps state identical
        # — same policy as conflicting moves.
        return None
    if ikind == "move":
        if ekind == "move":
            # Concurrent moves: refuse rather than guess (ot-json1
            # transformNoConflict raises on real conflicts; every replica
            # drops the same later-sequenced op, so state stays identical).
            return None
        # Earlier single-target op (multi handled above): carry each move
        # path through it — pick paths with ELEMENT semantics (an earlier
        # remove/replace of the picked node voids the whole move), drop
        # paths with BOUNDARY semantics (they name a gap and just shift).
        parts = []
        for path, comp in flatten(input_op):
            element = "p" in comp or "r" in comp
            shifted = _transform_json(
                {"t": "remove" if element else "insert", "p": list(path)},
                ekind,
            )
            if shifted is None:
                return None
            parts.append((tuple(shifted["p"]), comp))
        out: list = []
        for path, comp in parts:
            out.append([*path, comp])
        return out if len(out) > 1 else [*parts[0][0], parts[0][1]]
    if ekind == "move":
        x: dict | None = ikind
        for e in _move_decomposition(earlier):
            if x is None:
                return None
            x = _transform_json(x, e)
        return _to_json1(x)
    return _to_json1(_transform_json(ikind, ekind))


# ------------------------------------------------------------------ channel


class SharedJson1Channel(SharedOTChannel):
    """The sharejs-json1-compatible DDS (ref json1.ts:28)."""

    channel_type = "sharedJson1"

    def __init__(self, channel_id: str) -> None:
        # RATIONALE (matching the reference): undefined is not preserved
        # by JSON.stringify, so the initial doc is null.
        super().__init__(channel_id, initial=None)

    def apply_core(self, state: Any, op: list | None) -> Any:
        return apply_json1(state, op)

    def transform(self, input_op, earlier):
        return transform_json1(input_op, earlier)

    # ------------------------------------------------------------ public API
    def get(self) -> Any:
        return self.state

    def insert(self, path: list, value: Any) -> None:
        json.dumps(value)  # wire-serializable guard
        self.apply(insert_op(path, value))

    def move(self, src: list, dst: list) -> None:
        self.apply(move_op(src, dst))

    def remove(self, path: list, value: Any = True) -> None:
        self.apply(remove_op(path, value))

    def replace(self, path: list, old: Any, new: Any) -> None:
        json.dumps(new)
        self.apply(replace_op(path, old, new))


class _Json1Factory:
    channel_type = SharedJson1Channel.channel_type

    def create(self, channel_id: str) -> SharedJson1Channel:
        return SharedJson1Channel(channel_id)


SharedJson1Factory = _Json1Factory()
