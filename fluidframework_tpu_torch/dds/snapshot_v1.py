"""The port's own copy of ``fluidframework_tpu/dds/snapshot_v1.py`` (no JAX in it).

Merge-tree snapshotV1: the REFERENCE wire format, encode and decode.

This is the interop boundary SURVEY.md §7 demands ("protocol-compatible with
the reference's wire formats ... so the reference's fuzz/replay oracles can
verify bit-identical semantics"): a summary emitted here is shaped exactly
like the TypeScript reference's merge-tree V1 snapshot
(merge-tree/src/snapshotV1.ts:42, chunk format snapshotChunks.ts:49), so a
reference client could load it, and a reference-produced V1 snapshot loads
into our oracle (mirroring snapshotLoader.ts specToSegment).

Format recap (all blob values are JSON strings):

- blob ``header``: MergeTreeChunkV1 ``{version:"1", segmentCount, length,
  segments, startIndex, headerMetadata}`` where headerMetadata =
  ``{minSequenceNumber, sequenceNumber, orderedChunkMetadata:[{id}...],
  totalLength, totalSegmentCount}`` (snapshotV1.ts:69, emit :134-189).
- blobs ``body_0``, ``body_1``, ...: same chunk shape, headerMetadata
  absent (TS ``undefined`` is dropped by JSON.stringify).
- each chunk holds segments until accumulated char length >= chunkSize
  (default 10000 chars, snapshotV1.ts:49, getSeqLengthSegs :82).
- a segment spec is either a bare IJSONSegment — a string, or
  ``{text, props}`` for annotated text (textSegment.ts toJSONObject:63) —
  or ``{json, seq?, client?, removedSeq?, removedClient?, removedClientIds?,
  movedSeq?, movedSeqs?, movedClientIds?}`` when merge info above the MSN
  must survive (snapshotChunks.ts IJSONSegmentWithMergeInfo:65).

Elision/coalescing rules mirrored from snapshotV1.ts extractSync:192:

- unacked (local) inserts are elided — a pending op will redeliver them;
- segments whose winning remove is acked at/below the MSN are elided;
- fully-below-MSN live segments drop their merge info and coalesce with a
  compatible neighbour (canAppend: no newline at the join, one side within
  the 256-char granularity — textSegment.ts:77; matching props);
- everything else records merge info: insert stamp only when above the MSN,
  set-removes as removedSeq (FIRST remove's seq for every remover — the
  reference records only that, snapshotLoader.ts:133 fakes the rest),
  slice-removes (obliterates) as movedSeqs/movedClientIds.

Like the reference, the V1 format does NOT carry the in-window obliterate
anchor table or annotate LWW stamps: a replica loaded from V1 can converge
forward from the snapshot seq but cannot re-arbitrate races older than it
(reference TODO AB#32299 documents the same loss).
"""

from __future__ import annotations

import json
from typing import Any, Callable

from ..protocol.stamps import NON_COLLAB_CLIENT, NO_REMOVE, UNIVERSAL_SEQ, acked
from .markers import (
    assert_no_marker_plane,
    is_marker_text,
    marker_char,
    marker_ref_type,
)
from .mergetree_ref import RefMergeTree, Segment

CHUNK_SIZE = 10000          # chars per chunk (snapshotV1.ts:49)
TEXT_GRANULARITY = 256      # coalescing size gate (textSegment.ts:21)
HEADER_BLOB = "header"      # snapshotlegacy.ts:45
BODY_BLOB = "body"          # snapshotlegacy.ts:46


def _can_append(a_text: str, b_text: str) -> bool:
    """textSegment.ts canAppend:77 — no newline at the join point, and at
    least one side within the granularity.  Markers NEVER coalesce
    (Marker.canAppend is constant false, mergeTreeNodes.ts:495)."""
    if is_marker_text(a_text) or is_marker_text(b_text):
        return False
    return not a_text.endswith("\n") and (
        len(a_text) <= TEXT_GRANULARITY or len(b_text) <= TEXT_GRANULARITY
    )


def _props_json(seg: Segment) -> dict[str, Any] | None:
    """Segment props as reference PropertySet JSON (values only — V1 drops
    the LWW stamps, matching toJSONObject)."""
    if not seg.props:
        return None
    return {str(p): v for p, (v, _key) in sorted(seg.props.items())}


def _json_segment(text: str, props: dict[str, Any] | None) -> Any:
    """IJSONSegment: bare string, {text, props} when annotated, or
    {marker: {refType}, props} for a marker segment (marker/textSegment
    toJSONObject)."""
    if is_marker_text(text):
        out: dict[str, Any] = {"marker": {"refType": marker_ref_type(text)}}
        if props:
            out["props"] = props
        return out
    return {"text": text, "props": props} if props else text


def _spec_text_props(j: Any) -> tuple[str, dict[str, Any] | None]:
    """Inverse of _json_segment (snapshotLoader.ts specToSegment:107).
    Decode boundary for the reserved marker plane: only marker specs may
    produce U+E000..U+F8FF codepoints — a snapshot artifact smuggling them
    as 'text' is rejected, matching the op-apply boundary."""
    if isinstance(j, str):
        assert_no_marker_plane(j)
        return j, None
    if "marker" in j:
        return marker_char(j["marker"]["refType"]), j.get("props")
    assert_no_marker_plane(j["text"])
    return j["text"], j.get("props")


def encode_snapshot_v1(
    tree: RefMergeTree,
    seq: int,
    get_long_client_id: Callable[[int], str],
    chunk_size: int = CHUNK_SIZE,
    attribution: bool = False,
) -> dict[str, str]:
    """Emit the reference V1 snapshot blobs for a merge-tree replica.

    ``seq`` is the collab window's current sequence number (the reference
    reads it off mergeTree.collabWindow, snapshotV1.ts:68).  Returns
    {blob name: JSON string} exactly as SnapshotV1.emit writes them.

    With ``attribution`` on, every chunk carries the reference's
    SerializedAttributionCollection (``{seqs, posBreakpoints, length}``,
    attributionCollection.ts:465): run-length insert attribution across the
    chunk's segments, so who-wrote-what survives the below-MSN coalescing
    that strips insert stamps.
    """
    min_seq = tree.min_seq
    slice_keys = tree.slice_keys | {ob.key for ob in tree.obliterates}

    # ---- extractSync: elide / coalesce / record merge info ----------------
    specs: list[Any] = []
    lengths: list[int] = []
    attrs: list[list[tuple[int, Any]]] = []  # per-spec attribution runs

    def push(spec: Any, length: int, runs: list[tuple[int, Any]]) -> None:
        specs.append(spec)
        lengths.append(length)
        attrs.append(runs)

    prev: Segment | None = None  # coalescing candidate (below-MSN run)
    prev_attr: list[tuple[int, Any]] = []

    def flush_prev() -> None:
        nonlocal prev
        if prev is not None:
            push(
                _json_segment(prev.text, _props_json(prev)),
                len(prev.text),
                list(prev_attr),
            )
            prev = None

    for seg in tree.segments:
        if not acked(seg.ins_key):
            continue  # (a) pending insert redelivers on reconnect
        win_rem = seg.removes[0][0] if seg.removes else NO_REMOVE
        if seg.removes and acked(win_rem) and win_rem <= min_seq:
            continue  # (b) removed at/below MSN: unreferenceable

        below_msn = seg.ins_key <= min_seq and (
            not seg.removes or not acked(seg.removes[0][0])
        )
        if below_msn:
            # Coalesce with the previous below-MSN segment when compatible;
            # attribution runs concatenate across the join so the merged
            # spec keeps exact per-char provenance.
            if prev is None:
                prev, prev_attr = seg, list(seg.attr_runs())
            elif _can_append(prev.text, seg.text) and _props_json(prev) == _props_json(seg):
                base = len(prev.text)
                for off, key in seg.attr_runs():
                    if not prev_attr or prev_attr[-1][1] != key:
                        prev_attr.append((base + off, key))
                prev = Segment(
                    text=prev.text + seg.text,
                    ins_key=prev.ins_key,
                    ins_client=prev.ins_client,
                    props=dict(prev.props),
                )
            else:
                flush_prev()
                prev, prev_attr = seg, list(seg.attr_runs())
            continue

        flush_prev()
        raw: dict[str, Any] = {
            "json": _json_segment(seg.text, _props_json(seg))
        }
        if seg.ins_key > min_seq:
            raw["seq"] = seg.ins_key
            raw["client"] = get_long_client_id(seg.ins_client)
        set_removes = [
            (k, c) for k, c in seg.removes
            if acked(k) and k not in slice_keys
        ]
        if set_removes:
            raw["removedSeq"] = set_removes[0][0]
            # Vestigial singular field kept for <=0.58 loaders
            # (snapshotV1.ts:308-311).
            raw["removedClient"] = get_long_client_id(set_removes[0][1])
            raw["removedClientIds"] = [
                get_long_client_id(c) for _k, c in set_removes
            ]
        slice_removes = [
            (k, c) for k, c in seg.removes if acked(k) and k in slice_keys
        ]
        if slice_removes:
            raw["movedSeq"] = slice_removes[0][0]
            raw["movedSeqs"] = [k for k, _c in slice_removes]
            raw["movedClientIds"] = [
                get_long_client_id(c) for _k, c in slice_removes
            ]
        assert (
            "seq" in raw or "removedSeq" in raw or "movedSeq" in raw
        ), "corrupted preservation of segment metadata (ref assert 0x066)"
        push(raw, len(seg.text), list(seg.attr_runs()))
    flush_prev()

    # ---- chunking + blob emission (emit :134) -----------------------------
    chunks: list[dict[str, Any]] = []
    start = 0
    while start < len(specs) or not chunks:
        count = 0
        length = 0
        while length < chunk_size and start + count < len(specs):
            length += lengths[start + count]
            count += 1
        chunk: dict[str, Any] = {
            "version": "1",
            "segmentCount": count,
            "length": length,
            "segments": specs[start : start + count],
            "startIndex": start,
        }
        if attribution:
            chunk["attribution"] = _serialize_attribution(
                attrs[start : start + count], lengths[start : start + count]
            )
        chunks.append(chunk)
        start += count

    header = chunks[0]
    ordered = [{"id": HEADER_BLOB}] + [
        {"id": f"{BODY_BLOB}_{i}"} for i in range(len(chunks) - 1)
    ]
    header["headerMetadata"] = {
        "minSequenceNumber": min_seq,
        "sequenceNumber": seq,
        "orderedChunkMetadata": ordered,
        "totalLength": sum(lengths),
        "totalSegmentCount": len(specs),
    }
    blobs = {HEADER_BLOB: json.dumps(header, separators=(",", ":"))}
    for i, chunk in enumerate(chunks[1:]):
        blobs[f"{BODY_BLOB}_{i}"] = json.dumps(chunk, separators=(",", ":"))
    return blobs


def _serialize_attribution(
    attrs: list[list[tuple[int, Any]]], lengths: list[int]
) -> dict[str, Any]:
    """Reference extractSequenceOffsets (attributionCollection.ts:465):
    collapse per-segment runs into chunk-wide parallel arrays, merging
    consecutive equal keys across segment boundaries.  Local keys never
    reach a summary (ref assert 0x5c1)."""
    pos_breakpoints: list[int] = []
    seqs: list[Any] = []
    _SENTINEL = object()
    last: Any = _SENTINEL
    cum = 0
    for runs, length in zip(attrs, lengths):
        for off, key in runs:
            assert not (isinstance(key, dict) and key.get("type") == "local"), (
                "local attribution keys should never be put in summaries"
            )
            if last is _SENTINEL or key != last:
                pos_breakpoints.append(cum + off)
                seqs.append(key)
            last = key
        cum += length
    return {"seqs": seqs, "posBreakpoints": pos_breakpoints, "length": cum}


def _populate_attribution(
    segments: list[Segment], serialized: dict[str, Any], lengths: list[int]
) -> None:
    """Reference populateAttributionCollections (attributionCollection.ts:389):
    slice the chunk-wide runs back onto each segment as override runs."""
    bps = serialized["posBreakpoints"]
    seqs = serialized["seqs"]
    cum = 0
    i = 0
    for seg, length in zip(segments, lengths):
        runs: list[tuple[int, Any]] = []
        # Run in effect at the segment's start.
        while i + 1 < len(bps) and bps[i + 1] <= cum:
            i += 1
        j = i
        while j < len(bps) and bps[j] < cum + length:
            runs.append((max(bps[j] - cum, 0), seqs[j]))
            j += 1
        seg.attr = runs
        cum += length
    assert cum == serialized["length"], "attribution length mismatch"


def decode_snapshot_v1(
    blobs: dict[str, str],
    get_short_client_id: Callable[[str], int],
    prop_decoder: Callable[[str], int] = int,
) -> tuple[RefMergeTree, int, int]:
    """Load V1 snapshot blobs into a fresh oracle replica.

    Mirrors snapshotLoader.ts specToSegment:107: merge-info-free specs get
    the universal insert stamp (NonCollabClient), set-removes all share the
    recorded first removedSeq (the reference's own data loss, loader :133),
    slice-removes restore their individual seqs.  Returns
    (tree, sequenceNumber, minSequenceNumber).
    """
    header = json.loads(blobs[HEADER_BLOB])
    meta = header["headerMetadata"]
    chunks = [header]
    for entry in meta["orderedChunkMetadata"]:
        if entry["id"] != HEADER_BLOB:
            chunks.append(json.loads(blobs[entry["id"]]))

    tree = RefMergeTree()
    tree.min_seq = meta["minSequenceNumber"]
    slice_keys: set[int] = set()
    for chunk in chunks:
        chunk_segs: list[Segment] = []
        for spec in chunk["segments"]:
            if isinstance(spec, dict) and "json" in spec:
                text, props = _spec_text_props(spec["json"])
                ins_seq = spec.get("seq", UNIVERSAL_SEQ)
                client = (
                    get_short_client_id(spec["client"])
                    if "client" in spec
                    else NON_COLLAB_CLIENT
                )
                removes: list[tuple[int, int]] = []
                if "removedSeq" in spec:
                    ids = spec.get("removedClientIds")
                    if ids is None:  # pre-split singular form (loader :128)
                        ids = [spec["removedClient"]]
                    removes += [
                        (spec["removedSeq"], get_short_client_id(i))
                        for i in ids
                    ]
                if "movedSeq" in spec:
                    for k, c in zip(spec["movedSeqs"], spec["movedClientIds"]):
                        removes.append((k, get_short_client_id(c)))
                        slice_keys.add(k)
                removes.sort()
            else:
                text, props = _spec_text_props(spec)
                ins_seq, client, removes = UNIVERSAL_SEQ, NON_COLLAB_CLIENT, []
            chunk_segs.append(Segment(
                text=text,
                ins_key=ins_seq,
                ins_client=client,
                removes=removes,
                props={
                    prop_decoder(p): (v, UNIVERSAL_SEQ)
                    for p, v in (props or {}).items()
                },
            ))
        if "attribution" in chunk:
            _populate_attribution(
                chunk_segs, chunk["attribution"],
                [len(s.text) for s in chunk_segs],
            )
        tree.segments.extend(chunk_segs)
    # Like the reference loader, the obliterates collection itself is NOT
    # rebuilt (snapshotLoader.ts creates only the removes stamps): the
    # slice stamps keep visibility exact, but the swallow window for
    # not-yet-seen concurrent inserts is lost with the anchors — the
    # documented V1 limitation (TODO AB#32299).
    tree.slice_keys = slice_keys
    return tree, meta["sequenceNumber"], meta["minSequenceNumber"]
