"""The port's own copy of ``fluidframework_tpu/protocol/snapshot_formats.py`` (no JAX in it).

Versioned DDS snapshot formats + ISummaryTree node builders.

Reference parity: the reference evolves per-DDS snapshot formats behind
explicit versions (merge-tree snapshotV1.ts vs snapshotlegacy.ts, tree's
versioned editManagerCodecs/messageCodecs) and pins them with a committed
golden corpus (packages/test/snapshots: real snapshot files validated
against every supported read-version on every run); the summary-tree node
shapes (ISummaryTree blob/tree/handle) live in protocol-definitions.
Both are persistence contracts, so they live in the contracts tier — the
DDS layer (shared_tree's incremental summaries) names them without an
upward edge into the runtime; ``runtime.snapshot_formats`` and
``runtime.summary`` re-export for existing callers.

The version rides BESIDE the payload, never inside it (several DDS
summaries are keyed directly by user-chosen names — e.g. a register named
"fmt" — so injecting a key into the payload could clobber user data): the
datastore's channel entry is ``{"type": t, "fmt": N, "summary": ...}``.
Loading runs any upgraders from the entry's version to the current one;
entries with no ``fmt`` (pre-versioning files) read as version 1 — the
shipping layout. The golden corpus lives in ``tests/snapshots/`` with the
scripted documents that produced it in
``fluidframework_tpu/testing/snapshot_corpus.py`` — regenerating requires
a deliberate ``python -m fluidframework_tpu.testing.snapshot_corpus``
run, so format drift always shows up as a reviewed diff.
"""

from __future__ import annotations

from typing import Any, Callable

FORMAT_KEY = "fmt"

def _shared_string_v1_to_v2(summary: dict) -> dict:
    """v2 adds ``sliceKeys`` — the stamp keys applied by obliterates, kept
    beyond the window so snapshotV1 interop can label slice- vs set-removes
    (mergetree_ref.RefMergeTree.slice_keys).  A v1 file can only recover
    the keys still in its obliterate window table; stamps whose obliterate
    had already left the window stay unlabeled (visibility is unaffected —
    slice/set removes hide segments identically)."""
    return {
        **summary,
        "sliceKeys": sorted({ob["key"] for ob in summary.get("obliterates", [])}),
    }


# Current write-format per channel type; unlisted types are version 1.
CURRENT_FORMATS: dict[str, int] = {
    "sharedString": 2,
}

# channel type -> list of upgraders; UPGRADERS[t][k] rewrites a version
# k+1 summary dict into version k+2.
UPGRADERS: dict[str, list[Callable[[dict], dict]]] = {
    "sharedString": [_shared_string_v1_to_v2],
}


def current_format(channel_type: str) -> int:
    return CURRENT_FORMATS.get(channel_type, 1)


def upgrade(channel_type: str, summary: dict[str, Any], fmt: int = 1) -> dict[str, Any]:
    """Lift a summary payload recorded at format ``fmt`` to the current
    format (the payload itself is never stamped)."""
    cur = current_format(channel_type)
    if fmt > cur:
        raise ValueError(
            f"snapshot of {channel_type!r} uses format {fmt}, newer than "
            f"this build's {cur} — refusing a lossy downgrade read"
        )
    out = summary
    for upgrader in UPGRADERS.get(channel_type, [])[fmt - 1 : cur - 1]:
        out = upgrader(out)
    return out


# ---------------------------------------------------------------------------
# ISummaryTree node builders (ref protocol-definitions ISummaryTree)
# ---------------------------------------------------------------------------


def blob(content: Any) -> dict:
    return {"type": "blob", "content": content}


def tree(entries: dict[str, Any]) -> dict:
    return {"type": "tree", "entries": entries}


def handle(path: str) -> dict:
    """Reference to the same path in the previous acked summary."""
    return {"type": "handle", "path": path}
