"""The port's own copy of ``fluidframework_tpu/testing/reference_snapshots.py`` (no JAX in it).

Loaders for the reference's committed SEQUENCE snapshot artifacts.

The reference repo ships real summaries its own tests load
(`packages/dds/sequence/src/test/snapshots/v1/*.json`, written by
sharedString summarize and checked in so format drift is caught).  Loading
those files here is the strongest available proof of sequence-format
fidelity: the artifacts were produced by the
TypeScript implementation, not by this repo.

Each artifact is an ITree JSON (`{entries: [{path, type, value}...]}`):
merge-tree blobs (``header``, ``body_0``...) under the ``content`` subtree
(sequence/src/sequenceFactory.ts load path), and — for SharedString
documents with interval collections — a top-level ``header`` blob holding
each collection's serialized intervals
(intervalCollection.ts serializeInternal: ``[start, end, seq, type,
props]`` rows, props carrying ``intervalId``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from ..dds.sequence_intervals import SequenceInterval
from ..dds.snapshot_v1 import decode_snapshot_v1

# The reference checkout is named by FFTPU_REFERENCE_DIR; without it there
# is no artifact directory and every listing below is empty.
_REFERENCE_DIR = os.environ.get("FFTPU_REFERENCE_DIR")
V1_SNAPSHOT_DIR = (
    os.path.join(_REFERENCE_DIR, "packages/dds/sequence/src/test/snapshots/v1")
    if _REFERENCE_DIR
    else None
)


def _json_files(directory: str | None) -> list[str]:
    if directory is None or not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith(".json")
    )


def v1_artifact_files() -> list[str]:
    return _json_files(V1_SNAPSHOT_DIR)


def artifact_blobs(path: str) -> tuple[dict[str, str], dict[str, str]]:
    """Flatten an artifact ITree into ({merge-tree blob name: contents},
    {other blob path: contents}).  Merge-tree blobs are the ones under a
    ``content`` subtree; everything else (the interval-collection header)
    lands in the second map."""
    data = json.load(open(path, encoding="utf-8"))
    blobs: dict[str, str] = {}
    extra: dict[str, str] = {}

    def walk(tree: dict, under_content: bool) -> None:
        for e in tree.get("entries", []):
            if e["type"] == "Tree":
                walk(e["value"], under_content or e["path"] == "content")
            elif e["type"] == "Blob":
                (blobs if under_content else extra)[e["path"]] = (
                    e["value"]["contents"]
                )

    walk(data, False)
    return blobs, extra


def import_reference_intervals(
    header_json: str,
) -> dict[str, list[SequenceInterval]]:
    """Parse the sequence-level header blob: {collection key:
    {type: "sharedStringIntervalCollection", value: {label, intervals,
    version}}} -> label -> [SequenceInterval].  Serialized rows are
    ``[start, end, sequenceNumber, intervalType, props]``."""
    out: dict[str, list[SequenceInterval]] = {}
    for _key, entry in json.loads(header_json).items():
        if entry.get("type") != "sharedStringIntervalCollection":
            continue
        value = entry["value"]
        ivs = []
        for row in value["intervals"]:
            start, end, _seq, _itype, props = row
            props = dict(props or {})
            interval_id = props.pop("intervalId")
            ivs.append(SequenceInterval(
                interval_id=interval_id, start=start, end=end, props=props,
            ))
        out[value["label"]] = ivs
    return out


def legacy_artifact_files() -> list[str]:
    """The reference's LEGACY-format committed snapshots (snapshotlegacy.ts
    MergeTreeChunkLegacy): snapshots/legacy and legacyWithCatchUp."""
    if V1_SNAPSHOT_DIR is None:
        return []
    root = os.path.dirname(V1_SNAPSHOT_DIR)
    out = []
    for d in ("legacy", "legacyWithCatchUp"):
        out.extend(_json_files(os.path.join(root, d)))
    return out


def load_legacy_sequence_artifact(path: str):
    """Load a LEGACY-format artifact (header + optional body chunk of
    ``segmentTexts`` IJSONSegment specs, snapshotlegacy.ts) into a fresh
    oracle.  Returns (RefMergeTree, sequenceNumber, {label: intervals})."""
    from ..dds.snapshot_v1 import _spec_text_props
    from ..dds.mergetree_ref import RefMergeTree, Segment
    from ..protocol.stamps import NON_COLLAB_CLIENT, UNIVERSAL_SEQ

    blobs, extra = artifact_blobs(path)
    header = json.loads(blobs["header"])
    meta = header["headerMetadata"]
    chunks = [header]
    for entry in meta["orderedChunkMetadata"]:
        if entry["id"] != "header":
            chunks.append(json.loads(blobs[entry["id"]]))
    tree = RefMergeTree()
    for chunk in chunks:
        assert chunk["chunkSegmentCount"] == len(chunk["segmentTexts"])
        for spec in chunk["segmentTexts"]:
            text, props = _spec_text_props(spec)
            tree.segments.append(Segment(
                text=text,
                ins_key=UNIVERSAL_SEQ,
                ins_client=NON_COLLAB_CLIENT,
                props={p: (v, UNIVERSAL_SEQ) for p, v in (props or {}).items()},
            ))
    assert len(tree.segments) == meta["totalSegmentCount"]
    intervals = (
        import_reference_intervals(extra["header"]) if "header" in extra else {}
    )
    return tree, meta["sequenceNumber"], intervals


def load_sequence_artifact(
    path: str,
    get_short_client_id: Callable[[str], int] | None = None,
) -> tuple[Any, int, int, dict[str, list[SequenceInterval]]]:
    """Load one reference artifact: returns (RefMergeTree, seq, min_seq,
    {label: intervals}).  Property keys stay raw strings (the artifacts
    carry rich props: markerId, referenceTileLabels, nested objects)."""
    blobs, extra = artifact_blobs(path)
    names: list[str] = []

    def default_short(long_id: str) -> int:
        if long_id not in names:
            names.append(long_id)
        return names.index(long_id)

    tree, seq, min_seq = decode_snapshot_v1(
        blobs, get_short_client_id or default_short, prop_decoder=str
    )
    intervals = (
        import_reference_intervals(extra["header"]) if "header" in extra else {}
    )
    return tree, seq, min_seq, intervals
