"""The port's own copy of ``fluidframework_tpu/dds/markers.py`` (no JAX in it).

Marker segments: zero-text, length-1 position anchors in a sequence.

Reference parity: ``Marker`` (merge-tree/src/mergeTreeNodes.ts:495) is a
length-1 segment carrying a ``ReferenceType`` bitmask and properties
(``markerId``, ``referenceTileLabels``, ...); SharedString inserts them via
``insertMarker`` (sequence/src/sharedString.ts:42) and queries them with
``getMarkerFromId`` / ``searchForMarker``.  Markers occupy one POSITION in
the sequence (getLength counts them) but contribute no TEXT (getText skips
them) — they are how real documents express paragraph/table structure.

Device-first design: a marker is encoded as ONE CODEPOINT in the Unicode
private-use plane — ``chr(0xE000 + refType)``.  That single decision makes
markers first-class across the whole stack with no new columns anywhere:

- the columnar kernel stores the codepoint in its text pool like any other
  char; every position/visibility/tie-break/obliterate rule applies
  unchanged (a marker IS a 1-char segment);
- marker-ness survives summaries, reconnect regeneration and squash,
  because it lives in the content itself, not in side metadata;
- text materialization filters the plane (``strip_markers``), so getText
  semantics match the reference exactly while getLength still counts them.

The plane U+E000..U+F8FF is therefore RESERVED: user text may not contain
it (SharedString.insert_text asserts).  ReferenceType bitmasks
(ops.ts ReferenceType: Simple=0, Tile=1, ...) fit comfortably.

Marker properties ride the ordinary annotate machinery: an insertMarker op
applies the marker segment insert and its initial properties under ONE
stamp, so LWW/resubmit/summary paths need no marker-specific handling.
"""

from __future__ import annotations

from typing import Any

# The plane boundaries are a protocol-level contract shared with the device
# text-pool materializer (re-exported here for existing importers).
from ..protocol.marker_plane import MARKER_CP_BASE, MARKER_CP_END  # noqa: F401

# ReferenceType bitmask (ref merge-tree/src/ops.ts ReferenceType).
REF_SIMPLE = 0x0
REF_TILE = 0x1

# Reserved property keys (ref merge-tree/src/referencePositions.ts).
MARKER_ID_KEY = "markerId"
TILE_LABELS_KEY = "referenceTileLabels"


def marker_char(ref_type: int) -> str:
    assert 0 <= ref_type < MARKER_CP_END - MARKER_CP_BASE
    return chr(MARKER_CP_BASE + ref_type)


def is_marker_char(ch: str) -> bool:
    return MARKER_CP_BASE <= ord(ch) < MARKER_CP_END


def marker_ref_type(ch: str) -> int:
    return ord(ch) - MARKER_CP_BASE


def is_marker_text(text: str) -> bool:
    """True iff this segment text is a marker (length-1, reserved plane)."""
    return len(text) == 1 and is_marker_char(text)


def strip_markers(text: str) -> str:
    """Drop marker codepoints — the getText view of a char run."""
    return "".join(c for c in text if not is_marker_char(c))


def assert_no_marker_plane(text: str) -> None:
    """User text may not use the reserved plane (insert_text guard)."""
    if any(is_marker_char(c) for c in text):
        raise ValueError(
            "text may not contain U+E000..U+F8FF (reserved for markers)"
        )


def marker_json(ref_type: int, props: dict[str, Any] | None) -> dict:
    """The reference IJSONSegment marker shape (textSegment/marker
    toJSONObject): {"marker": {"refType": n}, "props": {...}}."""
    out: dict[str, Any] = {"marker": {"refType": ref_type}}
    if props:
        out["props"] = props
    return out


def regenerated_insert_spec(parts: list[tuple[str, dict]]) -> Any:
    """Wire spec for a regenerated pending insert, shared by both merge-tree
    backends.  ``parts`` = [(segment text, props applied by the SAME op)].
    Props ride ON the insert spec (the original insertMarker shape) because
    the regeneration annotate scan cannot see the op's own segments; values
    are interned ids the channel resolves at the wire boundary.

    Split parts can carry DIFFERENT props — e.g. a later local annotate
    restamped a prop on only half the pending insert's range.  Collapsing
    to one spec would drop annotations on resubmit, so this emits one spec
    per distinct-props run: a single spec when the runs collapse to one,
    else a LIST of specs the receiver applies back-to-back at the insert
    position.  Marker parts always emit marker form ({"marker": ...}) —
    bare text must never carry reserved-plane codepoints (the op-apply
    boundary rejects them)."""
    runs: list[tuple[str, dict]] = []
    for text, props in parts:
        if not text:
            continue
        props = props or {}
        if (
            runs
            and runs[-1][1] == props
            and not is_marker_text(text)
            and not is_marker_text(runs[-1][0][-1:])
        ):
            runs[-1] = (runs[-1][0] + text, props)
        else:
            runs.append((text, props))

    def one(text: str, props: dict) -> Any:
        if is_marker_text(text):
            out: dict[str, Any] = {"marker": {"refType": marker_ref_type(text)}}
            if props:
                out["props"] = props
            return out
        return {"text": text, "props": props} if props else text

    if not runs:
        return ""
    specs = [one(t, p) for t, p in runs]
    return specs[0] if len(specs) == 1 else specs


def spec_length(seg: Any) -> int:
    """Visible length of one insert spec (marker = 1 position)."""
    if isinstance(seg, str):
        return len(seg)
    if "marker" in seg:
        return 1
    return len(seg["text"])
