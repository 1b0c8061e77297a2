"""Marker codepoints in the host text view.

The subset of ``fluidframework_tpu/dds/markers.py`` that the oracle merge
tree (``dds/mergetree_ref.py``) reads: a marker is a one-character segment
in the reserved plane ``[MARKER_CP_BASE, MARKER_CP_END)``; it occupies a
position but no text.
"""

from __future__ import annotations

from typing import Any

from ..ops.mergetree_kernel import MARKER_CP_BASE, MARKER_CP_END


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


def regenerated_insert_spec(parts: list[tuple[str, dict]]) -> Any:
    """Wire spec for a regenerated pending insert: one spec per
    distinct-props run (a single spec when the runs collapse to one, else
    a list), marker parts in marker form ({"marker": ...})."""
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
