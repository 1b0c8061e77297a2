"""The port's own copy of ``fluidframework_tpu/dds/channels.py`` (no JAX in it).

Channel-contract DDS implementations (the runtime-hosted forms).

These are the DDSes as plugged into the runtime layer through the channel
boundary (runtime/channel.py) — the reference's SharedObject subclasses seen
through IChannelFactory/IDeltaHandler (shared-object-base/src/sharedObject.ts).
The standalone classes in shared_string.py / shared_map.py remain the
direct-wire forms used by the kernel differential harnesses; the op formats
and CRDT semantics are identical.
"""

from __future__ import annotations

import json
from typing import Any

from ..protocol.stamps import ALL_ACKED, encode_stamp
from .markers import (
    MARKER_ID_KEY,
    REF_TILE,
    TILE_LABELS_KEY,
    assert_no_marker_plane,
    marker_char,
    marker_json,
    spec_length,
    strip_markers,
)
from .mergetree_ref import SIDE_AFTER, SIDE_BEFORE, RefMergeTree
from .sequence_intervals import (
    SENTINEL_POS,
    IntervalCollection,
    StringOpLog,
    place_boundary,
    transform_position,
)
from .shared_string import decode_obliterate_places as _decode_obliterate_places
from ..protocol.channel import Channel, MessageCollection

# Default merge-tree backend for channel-hosted SharedStrings: None -> the
# Python oracle.  Callers swap in the device backend (``KernelMergeTree``) here to run the whole
# channel/container suite differentially (the IChannelFactory plugin
# boundary the north star gates on, channel.ts:294).
_STRING_BACKEND_FACTORY = None


def set_string_backend_factory(factory) -> None:
    """Install a zero-arg factory for SharedStringChannel backends (None
    restores the oracle default)."""
    global _STRING_BACKEND_FACTORY
    _STRING_BACKEND_FACTORY = factory


class LocalReference:
    """A position that follows the text (ref merge-tree localReference.ts:232
    LocalReferenceCollection): per-replica, NEVER replicated — cursor
    anchors, selection endpoints.  SlideOnRemove semantics: removing the
    containing range slides the reference to the range start.  Internally
    anchored in converged coordinates and transformed by every sequenced
    edit; ``position`` resolves into the local view (acked + own pending)."""

    def __init__(self, channel: "SharedStringChannel", conv_pos: int) -> None:
        self._channel = channel
        self.conv = conv_pos
        self.alive = True

    @property
    def position(self) -> int:
        assert self.alive, "reference was removed"
        return self._channel.backend.converged_to_local(self.conv)

    def remove(self) -> None:
        self.alive = False
        self._channel._local_refs.discard(self)


class SharedStringChannel(Channel):
    """SharedString over the channel boundary (ref SharedStringClass +
    merge-tree Client, sequence/src/sharedString.ts, merge-tree/src/client.ts).

    Local metadata per pending op: {"localSeq": n} — round-tripped by the
    container's PendingStateManager for ack zip and resubmit.

    Properties are RICH (ref PropertiesManager: arbitrary keys and JSON
    values): the channel interns keys/values to int ids for the columnar
    backends and resolves them at every boundary (wire ops and summaries
    carry raw values, so interning order never has to agree across
    replicas).
    """

    channel_type = "sharedString"

    def __init__(self, channel_id: str, backend: RefMergeTree | None = None) -> None:
        super().__init__(channel_id)
        if backend is None:
            backend = (
                _STRING_BACKEND_FACTORY() if _STRING_BACKEND_FACTORY else RefMergeTree()
            )
        self.backend = backend
        self._local_seq = 0
        # Interval collections (ref sequence/src/intervalCollection.ts):
        # named range sets anchored into this string; endpoints transform
        # with every sequenced string edit (sequence_intervals.py).
        self._collections: dict[str, IntervalCollection] = {}
        self._op_log = StringOpLog()
        # Converged-event listeners: (kind, pos, length, local_seq|None) per
        # sequenced edit, in converged coordinates (undo-redo range tracking).
        self._converged_listeners: list = []
        # Local references (never replicated; converged coordinates).
        self._local_refs: set[LocalReference] = set()
        # Rich-property intern tables: key/value <-> int id (backends are
        # int-columnar).  Replica-local; raw forms ride wire + summaries.
        self._prop_ids: dict[str, int] = {}
        self._prop_names: list[str] = []
        self._val_ids: dict[str, int] = {}
        self._val_raw: list[Any] = []

    # ------------------------------------------------------------ local edits
    def _next_local_seq(self) -> int:
        self._local_seq += 1
        return self._local_seq

    def insert_text(self, pos: int, text: str) -> int:
        assert text
        assert_no_marker_plane(text)
        ls = self._next_local_seq()
        self.backend.apply_insert(
            pos, text, encode_stamp(-1, ls), self.backend.local_client, ALL_ACKED
        )
        self.submit_local_message(
            {"type": 0, "pos1": pos, "seg": text}, {"localSeq": ls}
        )
        return ls

    def insert_marker(
        self, pos: int, ref_type: int = REF_TILE, props: dict | None = None
    ) -> int:
        """Insert a length-1 marker segment (ref sharedString.ts:42
        insertMarker, mergeTreeNodes.ts:495 Marker).  The marker and its
        initial properties apply under ONE stamp, so ack/resubmit treat
        them as the single op they are on the wire."""
        ls = self._next_local_seq()
        key = encode_stamp(-1, ls)
        self._apply_insert_spec(
            marker_json(ref_type, props), pos, key,
            self.backend.local_client, ALL_ACKED,
        )
        self.submit_local_message(
            {"type": 0, "pos1": pos, "seg": marker_json(ref_type, props)},
            {"localSeq": ls},
        )
        return ls

    def _apply_insert_spec(
        self, seg, pos: int, key: int, client: int, ref_seq: int
    ) -> list:
        """Apply one wire insert spec (IJSONSegment: bare text, annotated
        {text, props}, marker {marker:{refType}, props}, or a LIST of those
        — a regenerated insert whose split parts carry different props) to
        the backend.  Properties apply as (pos, pos+1) annotates in the
        SAME perspective: the op's own segment is visible to (ref_seq,
        sender) — own ops have occurred — so the range lands exactly on the
        inserted segment.

        This is the op-apply/decode boundary for the reserved marker plane:
        only a {"marker": {...}} spec may produce U+E000..U+F8FF
        codepoints.  Bare/annotated text smuggling plane codepoints is
        rejected (ValueError) — accepting it would make every replica
        silently reinterpret peer 'text' as markers, breaking the
        text/length invariants the local insert_text API already guards."""
        if isinstance(seg, list):
            out: list = []
            off = 0
            for part in seg:
                out.extend(
                    self._apply_insert_spec(part, pos + off, key, client, ref_seq)
                )
                off += spec_length(part)
            return out
        if isinstance(seg, str):
            text, props = seg, None
            assert_no_marker_plane(text)
        elif "marker" in seg:
            text = marker_char(seg["marker"]["refType"])
            props = seg.get("props")
        else:
            text, props = seg["text"], seg.get("props")
            assert_no_marker_plane(text)
        ins = self.backend.apply_insert(pos, text, key, client, ref_seq)
        for name, value in (props or {}).items():
            self.backend.apply_annotate(
                pos, pos + len(text),
                self._prop_id(name), self._val_id(value),
                key, client, ref_seq,
            )
        return [ins]

    def remove_range(self, pos1: int, pos2: int) -> int:
        assert pos1 < pos2
        ls = self._next_local_seq()
        self.backend.apply_remove(
            pos1, pos2, encode_stamp(-1, ls), self.backend.local_client, ALL_ACKED
        )
        self.submit_local_message(
            {"type": 1, "pos1": pos1, "pos2": pos2}, {"localSeq": ls}
        )
        return ls

    def obliterate_range(self, pos1: int, pos2: int) -> int:
        """Slice-remove [pos1, pos2): also swallows concurrent inserts into
        the range (ref client.ts applyObliterateRangeOp, ops.ts OBLITERATE)."""
        assert pos1 < pos2
        ls = self._next_local_seq()
        self.backend.apply_obliterate(
            pos1, SIDE_BEFORE, pos2 - 1, SIDE_AFTER,
            encode_stamp(-1, ls), self.backend.local_client, ALL_ACKED,
        )
        self.submit_local_message(
            {"type": 4, "pos1": pos1, "pos2": pos2}, {"localSeq": ls}
        )
        return ls

    def obliterate_range_sided(
        self, start: tuple[int, bool], end: tuple[int, bool]
    ) -> int:
        """Sided obliterate: endpoints are (char pos, before) places; an
        After (before=False) start / Before end expands the range to swallow
        concurrent inserts adjacent to the exclusive endpoint
        (ref ops.ts OBLITERATE_SIDED, mergeTreeEnableSidedObliterate)."""
        from .shared_string import validate_obliterate_places

        s1 = SIDE_BEFORE if start[1] else SIDE_AFTER
        s2 = SIDE_BEFORE if end[1] else SIDE_AFTER
        validate_obliterate_places(
            start[0], s1, end[0], s2, self.backend.visible_length()
        )
        ls = self._next_local_seq()
        self.backend.apply_obliterate(
            start[0], s1, end[0], s2,
            encode_stamp(-1, ls), self.backend.local_client, ALL_ACKED,
        )
        self.submit_local_message(
            {
                "type": 5,
                "pos1": {"pos": start[0], "before": start[1]},
                "pos2": {"pos": end[0], "before": end[1]},
            },
            {"localSeq": ls},
        )
        return ls

    # ------------------------------------------------------------- properties
    def _prop_id(self, prop) -> int:
        name = prop if isinstance(prop, str) else str(prop)
        if name not in self._prop_ids:
            self._prop_ids[name] = len(self._prop_names)
            self._prop_names.append(name)
        return self._prop_ids[name]

    def _val_id(self, value) -> int:
        key = json.dumps(value, sort_keys=True, separators=(",", ":"))
        if key not in self._val_ids:
            self._val_ids[key] = len(self._val_raw)
            # Store the JSON-CANONICAL form, not the caller's object: a
            # replica across a real wire sees the round-tripped value (tuple
            # -> list, int dict keys -> str), and resolved views/summaries
            # must agree byte for byte.
            self._val_raw.append(json.loads(key))
        return self._val_ids[key]

    def annotate_range(self, pos1: int, pos2: int, prop, value) -> None:
        """Annotate with an arbitrary key and JSON value (ref
        annotateRange + PropertiesManager rich property maps)."""
        assert pos1 < pos2
        ls = self._next_local_seq()
        self.backend.apply_annotate(
            pos1, pos2, self._prop_id(prop), self._val_id(value),
            encode_stamp(-1, ls), self.backend.local_client, ALL_ACKED,
        )
        name = prop if isinstance(prop, str) else str(prop)
        self.submit_local_message(
            {"type": 2, "pos1": pos1, "pos2": pos2, "props": {name: value}},
            {"localSeq": ls},
        )

    def annotations(self) -> list[dict]:
        """Per local-view POSITION: resolved {key: value} property maps.
        Positions include markers (whose entry is the marker's own props),
        so this list aligns with visible_length / insert positions, NOT
        with ``text`` (which excludes markers) — the reference's
        getPropertiesAtPosition is position-based the same way."""
        out = []
        for d in self.backend.annotations(
            ALL_ACKED, self.backend.local_client
        ):
            out.append(
                {self._prop_names[p]: self._val_raw[v] for p, v in d.items()}
            )
        return out

    # --------------------------------------------------------------- markers
    def _resolve_marker(self, pos: int, rt: int, props: dict) -> dict:
        return {
            "position": pos,
            "refType": rt,
            "props": {
                self._prop_names[p]: self._val_raw[v]
                for p, v in props.items()
            },
        }

    def _raw_marker_prop(self, props: dict, name: str):
        """One resolved property off a raw scan entry without materializing
        the rest (queries over marker-heavy documents stay cheap)."""
        pid = self._prop_ids.get(name)
        return self._val_raw[props[pid]] if pid in props else None

    def markers(self) -> list[dict]:
        """Visible markers in the local view:
        [{"position", "refType", "props"}] (resolved property maps)."""
        return [
            self._resolve_marker(pos, rt, props)
            for pos, rt, props in self.backend.marker_scan(
                ALL_ACKED, self.backend.local_client
            )
        ]

    def get_marker_from_id(self, marker_id: str) -> dict | None:
        """Marker with props[markerId] == id, or None (ref client.ts
        getMarkerFromId via the marker-id hash)."""
        for pos, rt, props in self.backend.marker_scan(
            ALL_ACKED, self.backend.local_client
        ):
            if self._raw_marker_prop(props, MARKER_ID_KEY) == marker_id:
                return self._resolve_marker(pos, rt, props)
        return None

    def annotate_marker(self, marker_id: str, props: dict) -> None:
        """Annotate the marker with this id (ref sharedString.ts
        annotateMarker): ALL properties ride ONE annotate op under one
        stamp over the marker's 1-position range — atomic across
        reconnect resubmission, one ack."""
        m = self.get_marker_from_id(marker_id)
        if m is None:
            raise KeyError(f"no marker with id {marker_id!r}")
        pos = m["position"]
        ls = self._next_local_seq()
        key = encode_stamp(-1, ls)
        for name, value in props.items():
            self.backend.apply_annotate(
                pos, pos + 1, self._prop_id(name), self._val_id(value),
                key, self.backend.local_client, ALL_ACKED,
            )
        self.submit_local_message(
            {"type": 2, "pos1": pos, "pos2": pos + 1, "props": dict(props)},
            {"localSeq": ls},
        )

    def get_text_and_markers(self, label: str) -> tuple[list[str], list[dict]]:
        """Parallel (text runs, tile markers) — one text run PER labeled
        tile (the text since the previous tile), trailing text after the
        last tile excluded, exactly the reference's gatherTextAndMarkers
        shape (ref sharedString.ts getTextAndMarkers)."""
        raw = self.position_text()
        cuts = [
            m for m in self.backend.marker_scan(
                ALL_ACKED, self.backend.local_client
            )
            if label in (self._raw_marker_prop(m[2], TILE_LABELS_KEY) or [])
        ]
        texts: list[str] = []
        markers: list[dict] = []
        start = 0
        for m in cuts:
            texts.append(strip_markers(raw[start:m[0]]))
            markers.append(self._resolve_marker(*m))
            start = m[0] + 1
        return texts, markers

    def search_for_marker(
        self, pos: int, label: str, forwards: bool = True
    ) -> dict | None:
        """Nearest marker at-or-after (forwards) / at-or-before pos whose
        referenceTileLabels include ``label`` — the reference's tile search
        (client.ts searchForMarker / mergeTree searchForMarker)."""
        best = None
        for m in self.backend.marker_scan(
            ALL_ACKED, self.backend.local_client
        ):
            if label not in (self._raw_marker_prop(m[2], TILE_LABELS_KEY) or []):
                continue
            if forwards:
                if m[0] >= pos:
                    return self._resolve_marker(*m)  # scan is position-ordered
            elif m[0] <= pos:
                best = m
            else:
                break
        return self._resolve_marker(*best) if best is not None else None

    # ------------------------------------------------------- local references
    def create_local_reference(self, pos: int) -> LocalReference:
        """Anchor a reference at local-view position ``pos`` (ref
        createLocalReferencePosition, SlideOnRemove)."""
        conv = self.backend.converged_position(
            pos, ALL_ACKED, self.backend.local_client
        )
        ref = LocalReference(self, conv)
        self._local_refs.add(ref)
        return ref

    # ------------------------------------------------------------- intervals
    def _converged_length(self) -> int:
        from ..protocol.stamps import NON_COLLAB_CLIENT

        return self.backend.visible_length(ALL_ACKED, NON_COLLAB_CLIENT)

    def get_interval_collection(self, label: str) -> IntervalCollection:
        """Named interval collection over this string (ref
        sharedString.getIntervalCollection). The collection's length_fn is
        the LOCAL view (what the author sees when adding); converged-space
        lengths are passed explicitly at sequencing time."""
        if label not in self._collections:
            # Length in POSITIONS (markers count), not text chars.
            self._collections[label] = IntervalCollection(
                label, self._submit_interval_op,
                lambda: self.backend.visible_length(),
            )
        return self._collections[label]

    def _submit_interval_op(self, label: str, op: dict) -> None:
        self.submit_local_message(
            {"type": 3, "label": label, "op": op},
            {"intervalRef": self._connection.ref_seq()},
        )

    def _resolve_interval_op(self, op: dict, ref_seq: int, sender: int) -> dict:
        """Resolve the op's endpoints — expressed in the sender's
        perspective (acked at its refSeq + its own prior ops, all sequenced
        by now thanks to per-client FIFO) — into converged coordinates, the
        space interval endpoints live in. Exact perspective walk, so no
        positional drift between replicas (the merge-tree-reference analog).
        Sided endpoints resolve their character position and keep the side;
        the start/end sentinels (pos=-1) pass through untouched."""
        out = dict(op)
        n = self._converged_length()
        for k in ("start", "end"):
            if out.get(k) is not None and out[k] != SENTINEL_POS:
                out[k] = min(
                    self.backend.converged_position(out[k], ref_seq, sender),
                    max(n - 1, 0) if "startSide" in out or "endSide" in out else n,
                )
        if out.get("end") is not None and out.get("start") is not None:
            if "startSide" in out or "endSide" in out:
                ss = out.get("startSide", 0)
                es = out.get("endSide", 0)
                if place_boundary(out["start"], ss) > place_boundary(
                    out["end"], es
                ):
                    out["end"], out["endSide"] = out["start"], ss
            elif out["end"] < out["start"]:
                out["end"] = out["start"]
        return out

    def _record_converged_events(
        self, kind: str, ranges, seq: int, local_seq: int | None = None
    ) -> None:
        """Slide interval endpoints over the converged-coordinate ranges an
        op touched. Removal ranges come in pre-removal coordinates and are
        applied back-to-front so earlier positions stay valid."""
        ordered = ranges if kind == "insert" else list(reversed(ranges))
        for pos, length in ordered:
            self._op_log.record(seq, kind, pos, length)
            for coll in self._collections.values():
                coll.transform_endpoints(kind, pos, length)
            for ref in self._local_refs:
                ref.conv = transform_position(ref.conv, kind, pos, length)
            for listener in list(self._converged_listeners):
                listener(kind, pos, length, local_seq)
        # Sentinel-degrade/crossing cleanup is only meaningful (and the
        # length query only paid) when sided intervals exist.
        if ordered and any(c.has_sided() for c in self._collections.values()):
            n = self._converged_length()
            for coll in self._collections.values():
                coll.finalize_op(n)

    # ---------------------------------------------------------------- inbound
    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            c = m.contents
            sender = self._connection.short_id(env.client_id)
            if c["type"] == 3:
                coll = self.get_interval_collection(c["label"])
                coll.apply_sequenced(
                    self._resolve_interval_op(c["op"], env.ref_seq, sender), m.local
                )
                continue
            # Apply, keeping the exact segments this op touched (identity,
            # not seq: grouped batches share sequence numbers).
            ins_segs: list = []
            rem_segs: list = []
            if m.local:
                ins_segs, rem_segs = self.backend.ack(
                    m.local_metadata["localSeq"], env.seq, sender,
                    ref_seq=env.ref_seq,
                )
            elif c["type"] == 0:
                ins_segs = self._apply_insert_spec(
                    c["seg"], c["pos1"], env.seq, sender, env.ref_seq
                )
            elif c["type"] == 1:
                rem_segs = self.backend.apply_remove(
                    c["pos1"], c["pos2"], env.seq, sender, env.ref_seq
                )
            elif c["type"] == 2:
                for prop, value in c["props"].items():
                    self.backend.apply_annotate(
                        c["pos1"], c["pos2"],
                        self._prop_id(prop), self._val_id(value),
                        env.seq, sender, env.ref_seq,
                    )
            elif c["type"] in (4, 5):
                p1, s1, p2, s2 = _decode_obliterate_places(c)
                rem_segs = self.backend.apply_obliterate(
                    p1, s1, p2, s2, env.seq, sender, env.ref_seq
                )
            else:
                raise ValueError(f"unsupported merge-tree op type {c['type']}")
            ls = m.local_metadata["localSeq"] if m.local else None
            if c["type"] == 0:
                self._record_converged_events(
                    "insert", self.backend.converged_insert_ranges(ins_segs), env.seq, ls
                )
            elif c["type"] in (1, 4, 5):
                self._record_converged_events(
                    "remove",
                    self.backend.converged_removed_ranges(rem_segs, env.seq),
                    env.seq,
                    ls,
                )
        self.backend.update_min_seq(env.min_seq)
        self._op_log.trim(env.min_seq)

    def on_min_seq(self, min_seq: int) -> None:
        self.backend.update_min_seq(min_seq)

    # ----------------------------------------------------- reconnect / stash
    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        if contents.get("type") == 3:
            # Pending interval op: slide its endpoints over everything
            # sequenced since it was authored, then resubmit fresh.
            op = dict(contents["op"])
            ref = local_metadata["intervalRef"]
            sided = "startSide" in op or "endSide" in op
            # Degrade bound: the author's LOCAL view (acked + own pending,
            # including inserts resubmitted ahead of this op) — endpoints
            # anchored in own pending text must NOT collapse, while a
            # genuine forward slide off a removed suffix still degrades to
            # the "end" sentinel exactly like finalize_op on connected
            # replicas.
            n_local = self.backend.visible_length() if sided else 0
            for k, sk in (("start", "startSide"), ("end", "endSide")):
                if op.get(k) is None:
                    continue
                if sided:
                    if op[k] != SENTINEL_POS:
                        op[k], op[sk] = self._op_log.transform_place_from(
                            op[k], op.get(sk, 0), ref
                        )
                        if op[k] >= n_local:
                            from .sequence_intervals import Side

                            op[k], op[sk] = SENTINEL_POS, Side.BEFORE
                else:
                    op[k] = self._op_log.transform_from(op[k], ref)
            if op.get("start") is not None and op.get("end") is not None:
                if sided:
                    if place_boundary(op["start"], op.get("startSide", 0)) > \
                            place_boundary(op["end"], op.get("endSide", 0)):
                        op["end"] = op["start"]
                        op["endSide"] = op.get("startSide", 0)
                elif op["end"] < op["start"]:
                    op["end"] = op["start"]
            self.submit_local_message(
                {"type": 3, "label": contents["label"], "op": op},
                {"intervalRef": self._connection.ref_seq()},
            )
            return
        regenerated = self.backend.regenerate_pending(
            local_metadata["localSeq"], self._next_local_seq, squash=squash
        )
        for fresh_ls, op in regenerated:
            if op.get("type") == 2:
                # The backend speaks interned ids; the wire carries raw
                # property keys/values.
                op = dict(op)
                op["props"] = {
                    self._prop_names[int(p)]: self._val_raw[v]
                    for p, v in op["props"].items()
                }
            elif op.get("type") == 0 and isinstance(op.get("seg"), (dict, list)):
                # Marker / annotated-insert spec (or a per-props-run spec
                # list from regeneration): resolve interned prop ids to
                # their raw wire forms, part by part.
                def resolve(seg):
                    if isinstance(seg, str):
                        return seg
                    seg = dict(seg)
                    seg["props"] = {
                        self._prop_names[int(p)]: self._val_raw[v]
                        for p, v in seg.get("props", {}).items()
                    }
                    return seg

                op = dict(op)
                seg = op["seg"]
                op["seg"] = (
                    [resolve(part) for part in seg]
                    if isinstance(seg, list)
                    else resolve(seg)
                )
            self.submit_local_message(op, {"localSeq": fresh_ls})

    def apply_stashed(self, contents: Any) -> Any:
        """Re-mint a stashed op as a fresh local edit (ref applyStashedOp,
        merge-tree client.ts:1329): apply locally with a pending stamp, do
        NOT submit — the pending-state replay will resubmit it."""
        c = contents
        if c.get("type") == 3:
            coll = self.get_interval_collection(c["label"])
            coll._pending.append(dict(c["op"]))
            return {"intervalRef": self._connection.ref_seq()}
        ls = self._next_local_seq()
        key = encode_stamp(-1, ls)
        short = self.backend.local_client
        if c["type"] == 0:
            self._apply_insert_spec(c["seg"], c["pos1"], key, short, ALL_ACKED)
        elif c["type"] == 1:
            self.backend.apply_remove(c["pos1"], c["pos2"], key, short, ALL_ACKED)
        elif c["type"] == 2:
            for prop, value in c["props"].items():
                self.backend.apply_annotate(
                    c["pos1"], c["pos2"],
                    self._prop_id(prop), self._val_id(value),
                    key, short, ALL_ACKED,
                )
        elif c["type"] in (4, 5):
            p1, s1, p2, s2 = _decode_obliterate_places(c)
            self.backend.apply_obliterate(p1, s1, p2, s2, key, short, ALL_ACKED)
        else:
            raise ValueError(f"unsupported merge-tree op type {c['type']}")
        return {"localSeq": ls}

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        """Merge-tree snapshot (backend-owned; ref snapshotV1.ts:42) plus
        the channel's interval collections and converged op log.  Interned
        property ids resolve to their raw forms so summaries are identical
        across replicas regardless of interning order."""
        out = self.backend.export_summary()
        for seg in out["segments"]:
            seg["props"] = {
                self._prop_names[int(p)]: [self._val_raw[v], k]
                for p, (v, k) in seg["props"].items()
            }
        # Lazily-materialized empty collections are omitted so replicas
        # that never touched a label summarize identically.
        out["intervals"] = {
            label: coll.summarize()
            for label, coll in self._collections.items()
            if coll.sequenced or coll._pending
        }
        out["opLog"] = self._op_log.to_json()
        return out

    def load(self, summary: dict[str, Any]) -> None:
        for label, data in summary.get("intervals", {}).items():
            self.get_interval_collection(label).load(data)
        self._op_log.load_json(summary.get("opLog", []))
        summary = dict(summary)
        summary["segments"] = [
            {
                **seg,
                "props": {
                    str(self._prop_id(p)): [self._val_id(v), k]
                    for p, (v, k) in seg["props"].items()
                },
            }
            for seg in summary["segments"]
        ]
        self.backend.import_summary(summary)

    # ------------------------------------------------------------------ views
    @property
    def text(self) -> str:
        # Local view: all acked ops + own pending (sentinel-stamped) ops.
        return self.backend.visible_text(ALL_ACKED, self.backend.local_client)

    def position_text(self) -> str:
        """The local view as a POSITION-indexed string: marker codepoints
        kept, so len() == visible_length and slicing by positions is exact
        (undo capture; ``text`` excludes markers and is shorter)."""
        return self.backend.visible_text(
            ALL_ACKED, self.backend.local_client, raw=True
        )

    # ------------------------------------------------------- attribution
    @staticmethod
    def _attr_key(key) -> dict[str, Any]:
        """Internal run key -> reference AttributionKey shape
        (runtime-definitions/src/attribution.ts: OpAttributionKey
        {type:"op", seq} / LocalAttributionKey / DetachedAttributionKey)."""
        return {"type": "op", "seq": key} if isinstance(key, int) else key

    def attribution_at(self, pos: int) -> dict[str, Any]:
        """Attribution key for the visible character at ``pos`` (ref
        attributionCollection.ts getAtOffset:203).  Resolve op keys to
        {user, timestamp} through the framework OpStreamAttributor."""
        return self._attr_key(
            self.backend.attribution_at(pos, ALL_ACKED, self.backend.local_client)
        )

    def attribution_range(
        self, start: int = 0, end: int | None = None
    ) -> list[dict[str, Any]]:
        """[{offset, key}] runs covering [start, end) (ref
        getKeysInOffsetRange:213: the first entry's offset may precede
        ``start`` when a run straddles it)."""
        runs = self.backend.attribution_runs(
            ALL_ACKED, self.backend.local_client
        )
        length = self.backend.visible_length(
            ALL_ACKED, self.backend.local_client
        )
        hi = length if end is None else min(end, length)
        out = []
        for i, (off, key) in enumerate(runs):
            run_end = runs[i + 1][0] if i + 1 < len(runs) else length
            # Keep only runs that actually intersect [start, hi).
            if run_end <= start or off >= hi:
                continue
            out.append({"offset": off, "key": self._attr_key(key)})
        return out


class PendingOverlayChannel(Channel):
    """Base for LWW-style DDSes: sequenced state + an ordered overlay of
    pending local ops. Owns the pendingId bookkeeping shared by map/cell:
    head-pop on ack, verbatim resubmit (position-free ops), stash re-entry,
    newest-first rollback. Subclasses implement ``_apply`` (sequenced state
    transition) and read through ``self._pending`` for optimistic views."""

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self._pending: list[tuple[int, dict]] = []  # (pending_id, op)
        self._next_pending = 0

    def _submit(self, op: dict) -> None:
        self._next_pending += 1
        self._pending.append((self._next_pending, op))
        self.submit_local_message(op, {"pendingId": self._next_pending})

    def process_messages(self, collection: MessageCollection) -> None:
        for m in collection.messages:
            if m.local:
                pid = m.local_metadata["pendingId"]
                assert self._pending and self._pending[0][0] == pid, "pending skew"
                self._pending.pop(0)
            self._apply(m.contents)

    def _apply(self, op: dict) -> None:
        raise NotImplementedError

    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        # LWW ops are position-free: verbatim resubmission is exact. The
        # pending entry stays in place; re-register its id with the metadata.
        pid = local_metadata["pendingId"]
        assert any(p[0] == pid for p in self._pending), "resubmit of unknown pending op"
        self.submit_local_message(contents, {"pendingId": pid})

    def apply_stashed(self, contents: Any) -> Any:
        self._next_pending += 1
        self._pending.append((self._next_pending, contents))
        return {"pendingId": self._next_pending}

    def rollback(self, contents: Any, local_metadata: Any) -> None:
        pid = local_metadata["pendingId"]
        assert self._pending and self._pending[-1][0] == pid, (
            "rollback must undo the latest local op first"
        )
        self._pending.pop()


class SharedMapChannel(PendingOverlayChannel):
    """SharedMap over the channel boundary (ref MapKernel, map/src/mapKernel.ts).

    Sequenced state applies ops in order; local reads overlay the pending
    list (a pending set/delete/clear masks remote values until acked —
    mapKernel.ts:707-852).
    """

    channel_type = "sharedMap"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.sequenced: dict[str, Any] = {}

    # ------------------------------------------------------------ local edits
    def set(self, key: str, value: Any) -> None:
        self._submit({"type": "set", "key": key, "value": value})

    def delete(self, key: str) -> None:
        self._submit({"type": "delete", "key": key})

    def clear(self) -> None:
        self._submit({"type": "clear"})

    # ---------------------------------------------------------------- inbound
    def _apply(self, op: dict) -> None:
        kind = op["type"]
        if kind == "set":
            self.sequenced[op["key"]] = op["value"]
        elif kind == "delete":
            self.sequenced.pop(op["key"], None)
        elif kind == "clear":
            self.sequenced.clear()
        else:
            raise ValueError(f"unknown map op {kind}")

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        return {"entries": dict(self.sequenced)}

    def load(self, summary: dict[str, Any]) -> None:
        self.sequenced = dict(summary["entries"])

    # ------------------------------------------------------------------ views
    def get(self, key: str) -> Any:
        for _pid, op in reversed(self._pending):
            if op["type"] == "clear":
                return None
            if op.get("key") == key:
                return op["value"] if op["type"] == "set" else None
        return self.sequenced.get(key)

    def keys(self) -> set[str]:
        out = set(self.sequenced)
        for _pid, op in self._pending:
            if op["type"] == "set":
                out.add(op["key"])
            elif op["type"] == "delete":
                out.discard(op["key"])
            else:
                out.clear()
        return out

    def items(self) -> dict[str, Any]:
        return {k: self.get(k) for k in self.keys()}


class ChannelTypeFactory:
    """Minimal IChannelFactory: a type string bound to a constructor."""

    def __init__(self, cls: type[Channel]) -> None:
        self.channel_type = cls.channel_type
        self._cls = cls

    def create(self, channel_id: str) -> Channel:
        return self._cls(channel_id)


SharedStringFactory = ChannelTypeFactory(SharedStringChannel)
SharedMapFactory = ChannelTypeFactory(SharedMapChannel)


# The reference registry's other channel types, each with the ROADMAP item
# (queue 1) that ports it.  Asking the port's registry for one raises: it
# never falls through to another type.
UNPORTED_CHANNEL_TYPES: dict[str, str] = {
    "sharedTree": "item 9 (the tree family's rest)",
    "sharedMatrix": "item 11 (map and matrix channel halves)",
    **{
        t: "item 13 (the other DDSes)"
        for t in (
            "sharedDirectory", "ink", "sharedSummaryBlock", "sharedCell",
            "sharedCounter", "consensusQueue", "consensusRegisterCollection",
            "taskManager", "pactMap", "sharedJsonOT", "sharedJson1",
            "propertyTree",
        )
    },
}


class ChannelRegistry(dict):
    """Type string -> factory; a type the port has not ported yet raises
    ``NotImplementedError`` naming its ROADMAP item, on lookup by either
    ``registry[t]`` or ``registry.get(t)``."""

    def _unported(self, channel_type: str):
        raise NotImplementedError(
            f"channel type {channel_type!r} is not ported to fluidframework_tpu_torch "
            f"yet: ROADMAP queue 1 {UNPORTED_CHANNEL_TYPES[channel_type]}"
        )

    def __missing__(self, channel_type: str):
        if channel_type in UNPORTED_CHANNEL_TYPES:
            self._unported(channel_type)
        raise KeyError(channel_type)

    def get(self, channel_type, default=None):
        if channel_type not in self and channel_type in UNPORTED_CHANNEL_TYPES:
            self._unported(channel_type)
        return super().get(channel_type, default)


def default_registry() -> ChannelRegistry:
    """Type string -> factory map of the channel types the port has
    (ref ISharedObjectRegistry): ``sharedString`` and ``sharedMap``."""
    return ChannelRegistry({
        SharedStringFactory.channel_type: SharedStringFactory,
        SharedMapFactory.channel_type: SharedMapFactory,
    })
