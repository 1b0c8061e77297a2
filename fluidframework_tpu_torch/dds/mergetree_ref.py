"""Pure-Python merge-tree oracle with reference-exact convergence semantics.

The port's own copy of ``fluidframework_tpu/dds/mergetree_ref.py`` (the
port imports nothing of the JAX package): the host replica behind the
fleet engine's oracle lane, its quarantine lane and the watchdog's replay.
It is held to the original op for op and summary for summary
(tests/test_torch_mergetree_ref.py).  A flat list-of-segments
implementation of the reference's merge-tree CRDT, behaviorally equivalent
to merge-tree/src/mergeTree.ts on the op-application path but with none of
the B-tree machinery (the B-tree + PartialSequenceLengths exist only to
make CPU queries O(log n); a flat walk is the clearest statement of the
semantics).

Semantics captured (studied from the reference, re-implemented):

- **Visibility** (perspective.ts ``PriorPerspective``): a segment is present
  from perspective ``(refSeq, viewClient)`` iff its insert has occurred
  (acked with seq <= refSeq, or issued by viewClient) and no remove on it has
  occurred.

- **Insert walk + tie-break** (mergeTree.ts ``insertRecursive`` /
  ``breakTie:1811``): an insert at position P walks segments left-to-right
  consuming perspective-visible length.  Landing mid-segment splits it.
  Landing on a boundary, the insert skips past invisible segments UNLESS the
  incoming stamp is greater than the segment's insert stamp (so among
  concurrent inserts at one position, later-sequenced ops sit closer to the
  front, and local unacked segments — which outrank every acked stamp — stay
  in front of incoming remote inserts), or the segment was removed by an
  acked remove stamped after the incoming insert (reconnect rebase case).

- **Set-remove** (mergeTree.ts ``markRangeRemoved:2292``): removes exactly
  the perspective-visible segments in [P1, P2), splitting boundary segments;
  overlapping removes keep the earliest stamp as the winner (removes[0]).

- **Annotate** (mergeTree.ts ``annotateRange:2009`` + PropertiesManager):
  per-(segment, key) last-writer-wins by stamp order; a pending local
  annotate outranks (masks) every acked one until acked itself.

- **Ack** (client.ts ``ackPendingSegment``): the originating client converts
  pending stamps (localSeq) to acked stamps (seq) when its own op returns.

- **Zamboni** (zamboni.ts:33): segments whose winning remove is acked at or
  below the MSN are unreferenceable from every legal perspective and are
  evicted.

Overlapping removes: the FULL list of remove stamps is retained per segment
(reference ``seg.removes``, kept stamp-sorted).  This is required for
correctness, not just attribution: a segment must be invisible to any
perspective whose client is among the removers, even when the *winning*
(earliest) remove is outside that perspective's refSeq
(perspective.ts ``isSegmentPresent``: ``removes.some(hasOccurred)``).
The device kernel carries a fixed number of remover slots per segment with
overflow detection for the same reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from ..protocol.stamps import (
    ALL_ACKED,
    NO_REMOVE,
    acked,
    encode_stamp,
    has_occurred,
)

# Endpoint sidedness for obliterate ranges (ref sequencePlace.ts Side).
SIDE_BEFORE = 0
SIDE_AFTER = 1


def attribution_key_at(runs: list, pos: int) -> Any:
    """The run key in effect at ``pos`` (shared by both backends — the walk
    of reference attributionCollection.ts findIndex:258)."""
    key = runs[0][1]
    for start, k in runs:
        if start > pos:
            break
        key = k
    return key


@dataclass
class Obliterate:
    """One obliterate in the collab window (ref mergeTreeNodes.ts
    ObliterateInfo): stamp + boundary anchors.  Anchors are the segments
    CONTAINING the endpoint characters (the reference's StayOnRemove local
    references, mergeTree.ts:2100-2126); on split an anchor follows the half
    holding its character — first char for Before sides, last char for After
    sides — which makes the reference's ordinal-window overlap test
    (Obliterates.findOverlapping, mergeTree.ts:566) a plain index-window
    test over the flat segment list."""

    key: int          # stamp key (acked seq, or LOCAL_BASE+localSeq pending)
    client: int
    start_seg: "Segment | None"   # None = boundary past the end of content
    start_side: int
    end_seg: "Segment | None"
    end_side: int
    ref_seq: int


@dataclass
class Segment:
    """One run of text plus its operation stamps (a columnar row on the device)."""

    text: str
    ins_key: int
    ins_client: int
    # Overlapping remove stamps as (key, client), sorted by key; the first
    # entry is the winning (earliest) remove — reference seg.removes[0].
    # Obliterate stamps live in the same list (visibility is identical);
    # which stamps are slice-removes is recoverable from the Obliterates set.
    removes: list[tuple[int, int]] = field(default_factory=list)
    # prop id -> (value, stamp key of the write that set it)
    props: dict[int, tuple[int, int]] = field(default_factory=dict)
    # Newest concurrent obliterate overlapping this segment's insertion point
    # at insert time (ref ISegmentInsideObliterateInfo
    # .obliteratePrecedingInsertion) — drives the last-obliterater-wins
    # tiebreak when later obliterates consider marking this segment.
    ob_preceding: "Obliterate | None" = None
    # Attribution override runs [(start offset, key)] — set only when the
    # segment was loaded from a snapshot that universalized its insert stamp
    # (ref attributionCollection.ts:63: per-segment AttributionCollection
    # populated from the summary's SequenceOffsets).  Keys: int = op seq,
    # dict = detached key; None = unattributed.  When absent, attribution
    # derives from the live insert stamp (attr_runs below).
    attr: "list[tuple[int, Any]] | None" = None

    @property
    def rem_key(self) -> int:
        return self.removes[0][0] if self.removes else NO_REMOVE

    def attr_runs(self) -> list[tuple[int, Any]]:
        """Attribution runs [(start offset, key)] for this segment's chars.

        Live segments attribute to their insert stamp (int seq when acked,
        the ``{"type": "local"}`` key while pending — reference
        attributionCollection local keys); snapshot-loaded segments use the
        recorded override runs."""
        if self.attr is not None:
            return self.attr
        if acked(self.ins_key):
            return [(0, self.ins_key)]
        return [(0, {"type": "local"})]

    def visible(self, ref_seq: int, view_client: int) -> bool:
        if not has_occurred(self.ins_key, self.ins_client, ref_seq, view_client):
            return False
        return not any(
            has_occurred(key, client, ref_seq, view_client)
            for key, client in self.removes
        )


class RefMergeTree:
    """Flat-array merge-tree replica for one document."""

    def __init__(self, local_client: int = -3) -> None:
        self.segments: list[Segment] = []
        self.local_client = local_client
        self.min_seq = 0
        # Obliterates inside the collab window (ref MergeTree.obliterates).
        self.obliterates: list[Obliterate] = []
        # Every stamp key ever applied by an obliterate — outlives the
        # window record so snapshotV1 encode can tell slice-removes from
        # set-removes (the reference keeps the type on the stamp itself,
        # stamps.ts RemoveOperationStamp.type).
        self.slice_keys: set[int] = set()
        # Stamp keys minted by regenerate_pending during a reconnect replay.
        # When regenerating a LATER pending op, segments carrying these keys
        # must count as "will be sequenced before it" even though the fresh
        # keys are numerically larger than the op's own old key (replay
        # re-stamps in pending order, so fresh keys of earlier ops exceed
        # every original pending key).
        self._regenerated_keys: set[int] = set()

    # ------------------------------------------------------------------ views
    def visible_text(
        self,
        ref_seq: int = ALL_ACKED,
        view_client: int | None = None,
        raw: bool = False,
    ) -> str:
        """Perspective text — EXCLUDES markers (ref getText gathers only
        TextSegments); they still occupy positions (visible_length).
        ``raw=True`` keeps marker codepoints, yielding a string whose
        indices ARE positions (len == visible_length) for position-space
        slicing (undo capture)."""
        from .markers import strip_markers

        vc = self.local_client if view_client is None else view_client
        if raw:
            return "".join(
                s.text for s in self.segments if s.visible(ref_seq, vc)
            )
        return "".join(
            strip_markers(s.text) for s in self.segments if s.visible(ref_seq, vc)
        )

    def marker_scan(
        self, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ) -> list[tuple[int, int, dict]]:
        """Visible markers as (position, refType, {prop_id: value_id}) —
        the host query surface behind getMarkerFromId / searchForMarker
        (ref mergeTreeNodes.ts Marker, sharedString.ts:42)."""
        from .markers import is_marker_text, marker_ref_type

        vc = self.local_client if view_client is None else view_client
        out: list[tuple[int, int, dict]] = []
        pos = 0
        for s in self.segments:
            if not s.visible(ref_seq, vc):
                continue
            if is_marker_text(s.text):
                out.append((
                    pos,
                    marker_ref_type(s.text),
                    {p: v for p, (v, _k) in s.props.items()},
                ))
            pos += len(s.text)
        return out

    def visible_length(self, ref_seq: int = ALL_ACKED, view_client: int | None = None) -> int:
        vc = self.local_client if view_client is None else view_client
        return sum(len(s.text) for s in self.segments if s.visible(ref_seq, vc))

    def annotations(self, ref_seq: int = ALL_ACKED, view_client: int | None = None) -> list[dict[int, int]]:
        """Per visible character: {prop_id: value} (for differential tests)."""
        vc = self.local_client if view_client is None else view_client
        out: list[dict[int, int]] = []
        for s in self.segments:
            if s.visible(ref_seq, vc):
                props = {k: v for k, (v, _key) in sorted(s.props.items())}
                out.extend(props for _ in s.text)
        return out

    def attribution_runs(
        self, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ) -> list[tuple[int, Any]]:
        """Run-length attribution over the visible text: [(start, key)].

        Keys are int op seqs, ``{"type": "local"}`` for pending content, or
        snapshot-recorded override keys (ref attributionCollection.ts
        getKeysInOffsetRange; the merged-run collapse matches its
        serializer, attributionCollection.ts:465)."""
        vc = self.local_client if view_client is None else view_client
        runs: list[tuple[int, Any]] = []
        pos = 0
        for seg in self.segments:
            if not seg.visible(ref_seq, vc):
                continue
            for off, key in seg.attr_runs():
                if not runs or runs[-1][1] != key:
                    runs.append((pos + off, key))
            pos += len(seg.text)
        return runs

    def attribution_at(
        self, pos: int, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ) -> Any:
        """Attribution key for the visible character at ``pos``
        (ref attributionCollection.ts getAtOffset)."""
        vc = self.local_client if view_client is None else view_client
        if not 0 <= pos < self.visible_length(ref_seq, vc):
            raise ValueError(f"attribution offset {pos} out of range")
        return attribution_key_at(self.attribution_runs(ref_seq, vc), pos)

    # ------------------------------------------------------------- primitives
    def _split(self, i: int, offset: int) -> None:
        """Split segment i at text offset, preserving all stamps (ref split)."""
        seg = self.segments[i]
        assert 0 < offset < len(seg.text)
        attr_l = attr_r = None
        if seg.attr is not None:
            attr_l = [(o, k) for o, k in seg.attr if o < offset]
            attr_r = [(o - offset, k) for o, k in seg.attr if o >= offset]
            if not attr_r or attr_r[0][0] > 0:
                # The run containing the split point continues into the
                # right half (reference AttributionCollection.splitAt).
                attr_r.insert(0, (0, attr_l[-1][1]))
        left = replace(
            seg, text=seg.text[:offset], removes=list(seg.removes),
            props=dict(seg.props), attr=attr_l,
        )
        right = replace(
            seg, text=seg.text[offset:], removes=list(seg.removes),
            props=dict(seg.props), attr=attr_r,
        )
        self.segments[i : i + 1] = [left, right]
        # Obliterate anchors follow the half holding their endpoint char:
        # Before sides sit on the segment's first char (left half), After
        # sides on its last char (right half).
        for ob in self.obliterates:
            if ob.start_seg is seg:
                ob.start_seg = left if ob.start_side == SIDE_BEFORE else right
            if ob.end_seg is seg:
                ob.end_seg = left if ob.end_side == SIDE_BEFORE else right

    def _tiebreak(self, seg: Segment, op_key: int) -> bool:
        """mergeTree.ts breakTie leaf case (pos == 0, invisible segment).

        Equal keys (>=) win the tie: they arise only from ops grouped in one
        batch, where the issuer already placed the later op's segment in
        front under its (strictly larger) localSeq stamp — remotes must
        agree after ack collapses the batch onto one sequence number."""
        if op_key >= seg.ins_key:
            return True
        return (
            bool(seg.removes)
            and acked(seg.removes[0][0])
            and seg.removes[0][0] > op_key
        )

    def _find_insert_index(
        self, pos: int, op_key: int, ref_seq: int, view_client: int
    ) -> int:
        """Replicates the inserting walk; may split a segment. Returns index
        at which to insert the new segment into ``self.segments``."""
        rem = pos
        i = 0
        while i < len(self.segments):
            seg = self.segments[i]
            vlen = len(seg.text) if seg.visible(ref_seq, view_client) else 0
            if rem < vlen:
                if rem == 0:
                    return i
                self._split(i, rem)
                return i + 1
            if rem == 0 and vlen == 0 and self._tiebreak(seg, op_key):
                return i
            rem -= vlen
            i += 1
        if rem != 0:
            raise ValueError(f"insert position {pos} beyond visible length")
        return len(self.segments)

    def _range_indices(
        self, pos1: int, pos2: int, ref_seq: int, view_client: int
    ) -> list[int]:
        """Split boundaries and return indices of perspective-visible segments
        wholly inside [pos1, pos2)."""
        assert pos1 <= pos2
        out: list[int] = []
        covered = 0
        i = 0
        while i < len(self.segments) and covered < pos2:
            seg = self.segments[i]
            if not seg.visible(ref_seq, view_client):
                i += 1
                continue
            seg_end = covered + len(seg.text)
            if seg_end <= pos1:
                covered = seg_end
                i += 1
                continue
            if covered < pos1:
                # Split off the prefix before the range.
                self._split(i, pos1 - covered)
                covered = pos1
                i += 1
                continue
            if seg_end > pos2:
                # Split off the suffix after the range.
                self._split(i, pos2 - covered)
                seg_end = pos2
            out.append(i)
            covered = seg_end
            i += 1
        if covered < pos2:
            raise ValueError(f"range [{pos1},{pos2}) beyond visible length")
        return out

    # -------------------------------------------------------------------- ops
    def apply_insert(
        self,
        pos: int,
        text: str,
        op_key: int,
        op_client: int,
        ref_seq: int,
    ) -> Segment:
        idx = self._find_insert_index(pos, op_key, ref_seq, op_client)
        seg = Segment(text=text, ins_key=op_key, ins_client=op_client)
        if self.obliterates:
            self._obliterate_on_insert(seg, idx, op_key, op_client, ref_seq)
        self.segments.insert(idx, seg)
        return seg

    def _obliterate_on_insert(
        self, seg: Segment, idx: int, op_key: int, op_client: int, ref_seq: int
    ) -> None:
        """Mark a just-placed segment removed when it lands inside an
        obliterated range the inserter had not seen (ref mergeTree.ts
        blockInsert obliterate handling, :1647-1745, incl. the
        last-obliterater-gets-to-insert tiebreak)."""
        index_of = {id(s): i for i, s in enumerate(self.segments)}
        concurrent: list[Obliterate] = []
        for ob in self.obliterates:
            if ob.start_seg is None or ob.end_seg is None:
                continue
            s_i = index_of[id(ob.start_seg)]
            e_i = index_of[id(ob.end_seg)]
            # New segment will sit at idx: inside the anchor window iff it
            # lands strictly after the start anchor and at/before the end
            # anchor (ordinal test, findOverlapping).
            if s_i < idx <= e_i and ob.key > ref_seq:
                concurrent.append(ob)
        if not concurrent:
            return
        newest = max(concurrent, key=lambda o: o.key)
        seg.ob_preceding = newest
        others = [o for o in concurrent if o.client != op_client]
        if not others or newest.client == op_client:
            # Inserter performed (or wins with) the newest overlapping
            # obliterate: their insert survives.
            return
        acked_concurrent = [o for o in concurrent if acked(o.key)]
        newest_acked = max(acked_concurrent, key=lambda o: o.key, default=None)
        removes: list[tuple[int, int]] = []
        if newest_acked is None or newest_acked is newest or newest_acked.client != op_client:
            removes = [(o.key, o.client) for o in others if acked(o.key)]
        unacked = [o for o in concurrent if not acked(o.key)]
        if unacked:
            oldest_unacked = min(unacked, key=lambda o: o.key)
            removes.append((oldest_unacked.key, oldest_unacked.client))
        seg.removes = sorted(removes)

    def _split_at(self, pos: int, ref_seq: int, view_client: int) -> None:
        """Split so perspective-position ``pos`` falls on a segment boundary
        (ref ensureIntervalBoundary)."""
        covered = 0
        for i, seg in enumerate(self.segments):
            if not seg.visible(ref_seq, view_client):
                continue
            seg_end = covered + len(seg.text)
            if covered < pos < seg_end:
                self._split(i, pos - covered)
                return
            if seg_end >= pos:
                return
            covered = seg_end

    def _seg_containing(self, p: int, ref_seq: int, view_client: int) -> Segment | None:
        """The perspective-visible segment containing char position ``p``."""
        covered = 0
        for seg in self.segments:
            if not seg.visible(ref_seq, view_client):
                continue
            if covered <= p < covered + len(seg.text):
                return seg
            covered += len(seg.text)
        return None

    def apply_obliterate(
        self,
        pos1: int,
        side1: int,
        pos2: int,
        side2: int,
        op_key: int,
        op_client: int,
        ref_seq: int,
    ) -> list[Segment]:
        """Obliterate the sided range — a slice-remove that also swallows
        concurrent inserts (ref mergeTree.ts obliterateRange:2262 /
        obliterateRangeSided:2083).  ``(pos1, side1)``/``(pos2, side2)`` name
        endpoint CHARACTERS in the op's perspective; the non-sided wire op
        {pos1, pos2} maps to (pos1, Before) .. (pos2-1, After).

        Returns the segments marked removed by this op (for channel events).
        Already-obliterated/removed segments are not re-marked (the marking
        perspective is "everything inserted, nothing removed" — the
        RemoteObliteratePerspective of the reference's design doc)."""
        vis_len = self.visible_length(ref_seq, op_client)
        start_pos = pos1 + (1 if side1 == SIDE_AFTER else 0)
        end_pos = pos2 + (1 if side2 == SIDE_AFTER else 0)
        if not (0 <= pos1 <= pos2 < vis_len and start_pos <= end_pos):
            raise ValueError(
                f"obliterate places ({pos1},{side1})..({pos2},{side2}) invalid "
                f"for visible length {vis_len}"
            )
        self._split_at(start_pos, ref_seq, op_client)
        self._split_at(end_pos, ref_seq, op_client)
        start_seg = self._seg_containing(pos1, ref_seq, op_client)
        end_seg = self._seg_containing(pos2, ref_seq, op_client)
        assert start_seg is not None and end_seg is not None
        ob = Obliterate(
            key=op_key, client=op_client,
            start_seg=start_seg, start_side=side1,
            end_seg=end_seg, end_side=side2,
            ref_seq=ref_seq,
        )
        index_of = {id(s): i for i, s in enumerate(self.segments)}
        lo = index_of[id(start_seg)] + (1 if side1 == SIDE_AFTER else 0)
        hi = index_of[id(end_seg)] - (1 if side2 == SIDE_BEFORE else 0)
        marked: list[Segment] = []
        for i in range(lo, hi + 1):
            seg = self.segments[i]
            # Marking visit rule (ref nodeMap mergeTree.ts:2990-3001 +
            # markRemoved:2144, walking RemoteObliteratePerspective for
            # remote ops, perspective.ts:201): a REMOTE obliterate visits —
            # and splices its stamp into — every window segment EXCEPT those
            # dead in both views: hidden by an acked remove AND not visible
            # at the op's refSeq AND not a local pending insert.  So it
            # still stamps (a) segments covered only by unacked local
            # removes, (b) segments whose acked removes are concurrent with
            # the obliterate (visible at its refSeq), and (c) local pending
            # inserts; skipping any of those diverges the replicas' remove
            # sets.  A LOCAL obliterate walks the local perspective: any
            # remove present locally hides the segment.
            has_acked_rem = any(acked(k) for k, _c in seg.removes)
            if acked(op_key):
                # A concurrent-inserted segment (insert not visible at the
                # op's perspective) is spliced even when acked-removed: the
                # obliterater's replica swallowed it at INSERT time (it held
                # the pending obliterate when the insert arrived, ref
                # blockInsert oldestUnacked, mergeTree.ts:1730-1740), so the
                # walk on every other replica must add the same stamp — the
                # exception being a pre-existing remove stamp from the same
                # client (then the issuer's insert-time rule added only that
                # older one, and the extra stamp would be unobservable).
                ins_concurrent = not has_occurred(
                    seg.ins_key, seg.ins_client, ref_seq, op_client
                )
                # The issuer swallowed this concurrent insert at INSERT time
                # by appending its OLDEST covering pending obliterate (plus
                # all acked stamps).  Our stamp therefore already exists on
                # the issuer iff some same-client stamp came from an
                # obliterate that was pending there when the insert arrived:
                # sequenced after the insert, at or before this op
                # (ins_seq < k <= op_key; == op_key is an earlier op of the
                # same grouped batch, which shares our sequence number).
                same_client_stamp = any(
                    c == op_client and seg.ins_key < k <= op_key
                    for k, c in seg.removes
                )
                if (
                    has_acked_rem
                    and not seg.visible(ref_seq, op_client)
                    and acked(seg.ins_key)
                    and not (ins_concurrent and not same_client_stamp)
                ):
                    continue
            elif seg.removes:
                continue
            if (
                not acked(seg.ins_key)
                and seg.ob_preceding is not None
                and not acked(seg.ob_preceding.key)
                and acked(op_key)
            ):
                # A local pending obliterate is newer than this incoming
                # acked one: last-obliterater-wins lets our insert live.
                continue
            seg.removes.append((op_key, op_client))
            seg.removes.sort()
            # Event list: only segments this op removes from the ACKED view
            # (ref removedSegments vs the splice path, mergeTree.ts:2177).
            if not has_acked_rem:
                marked.append(seg)
        self.obliterates.append(ob)
        self.slice_keys.add(op_key)
        return marked

    def apply_remove(
        self, pos1: int, pos2: int, op_key: int, op_client: int, ref_seq: int
    ) -> list[Segment]:
        out = []
        for i in self._range_indices(pos1, pos2, ref_seq, op_client):
            seg = self.segments[i]
            # Overlapping removes accumulate, stamp-sorted (ref seg.removes).
            seg.removes.append((op_key, op_client))
            seg.removes.sort()
            out.append(seg)
        return out

    def apply_annotate(
        self,
        pos1: int,
        pos2: int,
        prop: int,
        value: int,
        op_key: int,
        op_client: int,
        ref_seq: int,
    ) -> None:
        for i in self._range_indices(pos1, pos2, ref_seq, op_client):
            seg = self.segments[i]
            prev = seg.props.get(prop)
            # LWW by stamp order; pending local writes outrank acked remotes.
            # Ties (>=) go to the later-APPLIED op: ops grouped in one batch
            # share a sequence number, and the issuer resolved them by
            # localSeq order before ack — remotes must agree.
            if prev is None or op_key >= prev[1]:
                seg.props[prop] = (value, op_key)

    # -------------------------------------------------------------------- ack
    def ack(
        self,
        local_seq: int,
        seq: int,
        client: int | None = None,
        ref_seq: int | None = None,
    ) -> None:
        """Convert pending stamps with this localSeq to the acked seq.

        ``client`` (when given) re-stamps the client id to the identity the
        op was sequenced under — channel-hosted replicas stamp local pending
        ops with ``local_client`` and learn their short id only at ack, which
        keeps views stable across reconnection identity changes.
        ``ref_seq`` (when given) rewrites an acked obliterate's recorded
        refSeq to the wire value every remote replica stored (the issuer
        created the record under the ALL_ACKED sentinel; summaries must be
        replica-identical).
        """
        local_key = encode_stamp(-1, local_seq)
        self._regenerated_keys.discard(local_key)
        if local_key in self.slice_keys:
            self.slice_keys.discard(local_key)
            self.slice_keys.add(seq)
        inserted: list[Segment] = []
        removed: list[Segment] = []
        for seg in self.segments:
            if seg.ins_key == local_key:
                seg.ins_key = seq
                if client is not None:
                    seg.ins_client = client
                inserted.append(seg)
            if any(key == local_key for key, _ in seg.removes):
                seg.removes = sorted(
                    (seq if key == local_key else key,
                     client if client is not None and key == local_key else c)
                    for key, c in seg.removes
                )
                removed.append(seg)
            for prop, (value, key) in list(seg.props.items()):
                if key == local_key:
                    seg.props[prop] = (value, seq)
        for ob in self.obliterates:
            if ob.key == local_key:
                # In-place stamp rewrite keeps every seg.ob_preceding
                # reference consistent (the reference mutates ObliterateInfo
                # .stamp the same way on ack).
                ob.key = seq
                if client is not None:
                    ob.client = client
                if ref_seq is not None:
                    ob.ref_seq = ref_seq
        return inserted, removed

    # ----------------------------------------------------- converged queries
    # The "converged view" is the perspective every replica agrees on after
    # full delivery: acked stamps only (refSeq=ALL_ACKED, a client id that
    # matches no pending op). Interval-collection endpoints live in these
    # coordinates (channels.py), so the channel asks, after each sequenced
    # apply, exactly which converged ranges the op touched.

    def converged_position(self, pos: int, ref_seq: int, view_client: int) -> int:
        """Translate a position under perspective (ref_seq, view_client)
        into converged coordinates — the exact slide semantics a merge-tree
        reference would give: landing inside a segment invisible to the
        converged view slides to that segment's converged start."""
        from ..protocol.stamps import NON_COLLAB_CLIENT

        rem = pos
        conv = 0
        for seg in self.segments:
            p_len = len(seg.text) if seg.visible(ref_seq, view_client) else 0
            c_vis = seg.visible(ALL_ACKED, NON_COLLAB_CLIENT)
            if rem < p_len:
                return conv + (rem if c_vis else 0)
            rem -= p_len
            if c_vis:
                conv += len(seg.text)
        if rem == 0:
            return conv
        raise ValueError(f"position {pos} beyond perspective-visible length")

    def converged_insert_ranges(self, segs: list[Segment]) -> list[tuple[int, int]]:
        """(pos, len) of exactly these just-sequenced segments, in post-apply
        converged coordinates, ascending. Identity-based so two ops sharing
        one sequence number (grouped batches) never claim each other's
        segments."""
        from ..protocol.stamps import NON_COLLAB_CLIENT

        wanted = {id(s) for s in segs}
        out: list[tuple[int, int]] = []
        pos = 0
        for seg in self.segments:
            if seg.visible(ALL_ACKED, NON_COLLAB_CLIENT):
                if id(seg) in wanted:
                    out.append((pos, len(seg.text)))
                pos += len(seg.text)
        return out

    def converged_removed_ranges(
        self, segs: list[Segment], op_key: int
    ) -> list[tuple[int, int]]:
        """(pos, len) of what this remove op (stamp ``op_key``, applied to
        exactly ``segs``) deleted from the converged view, in PRE-removal
        converged coordinates, ascending. Segments already dead to the
        converged view (another acked remove also stamped them) are not
        re-reported."""
        wanted = {id(s) for s in segs}
        out: list[tuple[int, int]] = []
        pos = 0
        for seg in self.segments:
            if not acked(seg.ins_key):
                continue
            acked_removes = [k for k, _c in seg.removes if acked(k)]
            newly = id(seg) in wanted and all(k == op_key for k in acked_removes)
            alive = not acked_removes
            if newly:
                out.append((pos, len(seg.text)))
            if newly or alive:
                pos += len(seg.text)
        return out

    def converged_to_local(self, pos: int) -> int:
        """Translate a converged-coordinate position into the LOCAL view
        (acked state plus own pending ops). Landing inside a segment the
        local view cannot see (covered by a pending local remove) slides to
        that segment's local start."""
        from ..protocol.stamps import NON_COLLAB_CLIENT

        conv = 0
        loc = 0
        for seg in self.segments:
            c_vis = seg.visible(ALL_ACKED, NON_COLLAB_CLIENT)
            l_vis = seg.visible(ALL_ACKED, self.local_client)
            n = len(seg.text)
            if c_vis and pos < conv + n:
                return loc + (pos - conv) if l_vis else loc
            if c_vis:
                conv += n
            if l_vis:
                loc += n
        return loc

    def converged_spans_to_local(self, start: int, end: int) -> list[tuple[int, int]]:
        """Map the converged range [start, end) into local-view sub-ranges,
        ascending. Content invisible to the converged view (own pending
        inserts inside the range) produces holes — the caller operating on
        the local view leaves it untouched; content locally hidden by a
        pending remove is skipped (already gone from the local view)."""
        from ..protocol.stamps import NON_COLLAB_CLIENT

        spans: list[list[int]] = []
        conv = 0
        loc = 0
        for seg in self.segments:
            c_vis = seg.visible(ALL_ACKED, NON_COLLAB_CLIENT)
            l_vis = seg.visible(ALL_ACKED, self.local_client)
            n = len(seg.text)
            if c_vis:
                o1 = max(start, conv)
                o2 = min(end, conv + n)
                if o1 < o2 and l_vis:
                    s0 = loc + (o1 - conv)
                    e0 = loc + (o2 - conv)
                    if spans and spans[-1][1] == s0:
                        spans[-1][1] = e0
                    else:
                        spans.append([s0, e0])
                conv += n
            if l_vis:
                loc += n
        return [(s, e) for s, e in spans]

    # --------------------------------------------------------------- reconnect
    def _squashed(self, seg: Segment) -> bool:
        """A pending insert later covered by a pending remove: under squash
        resubmission the pair cancels and the segment never materializes
        remotely (ref reSubmitCore(squash), channel.ts:160)."""
        return not acked(seg.ins_key) and any(not acked(k) for k, _c in seg.removes)

    def _visible_at_prefix(
        self, seg: Segment, max_key: int, exclude_key: int, squash: bool = False
    ) -> bool:
        """Visibility in the local view truncated at pending key ``max_key``:
        everything acked plus own pending ops with stamp key < ``max_key``
        (``exclude_key`` additionally hides one remove stamp — the op being
        regenerated itself). This is the perspective a *resubmitted* op must
        encode positions in: earlier pending ops will be sequenced before it,
        later pending ops after (ref client.ts regeneratePendingOp:1452).
        Under ``squash``, squashed-out segments vanish from position space."""
        if squash and self._squashed(seg):
            return False
        if not self._occurred_before(seg.ins_key, max_key):
            return False
        return not any(
            self._occurred_before(key, max_key) and key != exclude_key
            for key, _client in seg.removes
        )

    def _occurred_before(self, key: int, max_key: int) -> bool:
        """Will the op with this stamp be sequenced before the pending op
        whose (original) key is ``max_key``? True for acked ops, earlier
        original pending ops, and already-regenerated ops of this replay."""
        return acked(key) or key < max_key or key in self._regenerated_keys

    def regenerate_pending(
        self,
        local_seq: int,
        new_local_seq,
        squash: bool = False,
        new_client: int | None = None,
    ) -> list[tuple[int, dict]]:
        """Re-mint the pending op with this localSeq against current state.

        Returns ``[(fresh_local_seq, wire_op_dict), ...]``: a remove/annotate
        whose range was split by interleaved acked removes becomes multiple
        ops; an op whose target content vanished — or, under ``squash``, an
        insert that a later pending remove fully covers — becomes zero ops.
        ``new_local_seq()`` allocates a fresh localSeq per emitted op and the
        affected segments are RE-STAMPED with it, so each re-minted op acks
        independently (ref regeneratePendingOp mints new segment groups,
        client.ts:1452).
        """
        key = encode_stamp(-1, local_seq)
        ob = next((o for o in self.obliterates if o.key == key), None)
        if ob is not None:
            return self._regenerate_obliterate(ob, key, new_local_seq, squash, new_client)
        # (kind, pos1, pos2, payload, [segments]) collected before re-stamping
        # so position math sees unmodified stamps throughout.
        plans: list[tuple[int, int, int, object, list[Segment]]] = []

        # Pending insert: contiguous run of segments carrying this ins stamp.
        ins_segs: list[Segment] = []
        pos = 0
        ins_pos = -1
        for seg in self.segments:
            if seg.ins_key == key and not (squash and self._squashed(seg)):
                if ins_pos < 0:
                    ins_pos = pos
                ins_segs.append(seg)
            if self._visible_at_prefix(seg, key, exclude_key=-1, squash=squash):
                pos += len(seg.text)
        if ins_pos >= 0:
            from .markers import regenerated_insert_spec

            spec = regenerated_insert_spec([
                (s.text, {str(p): v for p, (v, k) in s.props.items() if k == key})
                for s in ins_segs
            ])
            plans.append((0, ins_pos, -1, spec, ins_segs))

        # Pending remove / annotate: maximal visible runs carrying the stamp.
        pos = 0
        rem_run: tuple[int, int, list[Segment]] | None = None
        ann_run: tuple[int, int, dict, list[Segment]] | None = None

        def flush_remove() -> None:
            nonlocal rem_run
            if rem_run is not None:
                plans.append((1, rem_run[0], rem_run[1], None, rem_run[2]))
            rem_run = None

        def flush_annotate() -> None:
            nonlocal ann_run
            if ann_run is not None:
                plans.append((2, ann_run[0], ann_run[1], ann_run[2], ann_run[3]))
            ann_run = None

        for seg in self.segments:
            if not self._visible_at_prefix(seg, key, exclude_key=key, squash=squash):
                continue  # invisible: breaks neither runs nor position space
            if any(k == key for k, _c in seg.removes):
                if rem_run is None:
                    rem_run = (pos, pos + len(seg.text), [seg])
                else:
                    rem_run = (rem_run[0], pos + len(seg.text), rem_run[2] + [seg])
            else:
                flush_remove()
            props = {str(p): v for p, (v, k) in seg.props.items() if k == key}
            if props:
                if ann_run is None or props != ann_run[2]:
                    flush_annotate()
                    ann_run = (pos, pos + len(seg.text), props, [seg])
                else:
                    ann_run = (ann_run[0], pos + len(seg.text), props, ann_run[3] + [seg])
            else:
                flush_annotate()
            pos += len(seg.text)
        flush_remove()
        flush_annotate()

        # Squashed segments are dead: never resubmitted, never acked. Drop
        # (keeping obliterate anchors resident; invisible everywhere anyway).
        if squash:
            anchored = self._anchored_ids()
            self.segments = [
                s for s in self.segments
                if id(s) in anchored or not self._squashed(s)
            ]

        out: list[tuple[int, dict]] = []
        # A remove split into several re-minted ops: the receiver applies
        # them SEQUENTIALLY, and each later op's perspective includes its
        # earlier siblings (same client), so later pieces must shift left by
        # the length the earlier pieces already removed.
        removed_before = 0
        for kind, pos1, pos2, payload, segs in plans:
            fresh = new_local_seq()
            fresh_key = encode_stamp(-1, fresh)
            self._regenerated_keys.add(fresh_key)
            if kind == 0:
                for s in segs:
                    s.ins_key = fresh_key
                    if new_client is not None:
                        # Resubmission happens under a new connection identity;
                        # remote replicas will stamp the new short id.
                        s.ins_client = new_client
                    # Same-op props (insertMarker) re-mint with the insert.
                    for p, (v, k2) in list(s.props.items()):
                        if k2 == key:
                            s.props[p] = (v, fresh_key)
                out.append((fresh, {"type": 0, "pos1": pos1, "seg": payload}))
            elif kind == 1:
                for s in segs:
                    s.removes = sorted(
                        (fresh_key if k == key else k,
                         new_client if new_client is not None and k == key else c)
                        for k, c in s.removes
                    )
                out.append(
                    (fresh, {"type": 1, "pos1": pos1 - removed_before,
                             "pos2": pos2 - removed_before})
                )
                removed_before += pos2 - pos1
            else:
                for s in segs:
                    for p, (v, k) in list(s.props.items()):
                        if k == key:
                            s.props[p] = (v, fresh_key)
                out.append(
                    (fresh, {"type": 2, "pos1": pos1, "pos2": pos2, "props": payload})
                )
        return out

    def _regenerate_obliterate(
        self, ob: Obliterate, key: int, new_local_seq, squash: bool, new_client: int | None
    ) -> list[tuple[int, dict]]:
        """Re-mint a pending obliterate against current state: recompute the
        sided endpoint places in the prefix-visible space the resubmitted op
        will be interpreted in, and re-stamp every segment it marked.  The
        regenerated op is always emitted in sided form (type 5), which
        subsumes the plain form.  Reference analog: the experimental
        mergeTreeEnableObliterateReconnect path (client.ts
        regeneratePendingOp + obliterate range fixup)."""
        index_of = {id(s): i for i, s in enumerate(self.segments)}
        s_i = index_of.get(id(ob.start_seg), len(self.segments))
        e_i = index_of.get(id(ob.end_seg), len(self.segments))
        b_s = b_e = total = 0
        for i, seg in enumerate(self.segments):
            if not self._visible_at_prefix(seg, key, exclude_key=key, squash=squash):
                continue
            n = len(seg.text)
            if i < s_i or (i == s_i and ob.start_side == SIDE_AFTER):
                b_s += n
            if i < e_i or (i == e_i and ob.end_side == SIDE_AFTER):
                b_e += n
            total += n

        # Express the surviving boundaries as sided places; a boundary whose
        # anchor char vanished from the prefix view degrades to the nearest
        # expressible place (slide semantics).
        if ob.start_side == SIDE_AFTER and b_s > 0:
            start = {"pos": b_s - 1, "before": False}
        else:
            start = {"pos": b_s, "before": True}
        if ob.end_side == SIDE_BEFORE and b_e < total:
            end = {"pos": b_e, "before": True}
        elif b_e > 0:
            end = {"pos": b_e - 1, "before": False}
        else:
            end = None

        start_char = start["pos"]
        end_char = end["pos"] if end is not None else -1
        start_bound = start["pos"] + (0 if start["before"] else 1)
        end_bound = (end["pos"] + (0 if end["before"] else 1)) if end is not None else -1
        if (
            end is None
            or not (0 <= start_char <= end_char < total)
            or start_bound > end_bound
        ):
            # The whole range (and any place to re-anchor it) is gone from
            # the prefix view: the op is never resubmitted, so retire the
            # obliterate — strip its (never-to-ack) stamps and drop the
            # record so it stops swallowing future concurrent inserts.
            for seg in self.segments:
                if any(k == key for k, _c in seg.removes):
                    seg.removes = [(k, c) for k, c in seg.removes if k != key]
            self.obliterates.remove(ob)
            self.slice_keys.discard(key)
            return []

        # Re-stamp the marked segments and the obliterate record itself so
        # the re-minted op acks independently.
        fresh = new_local_seq()
        fresh_key = encode_stamp(-1, fresh)
        self._regenerated_keys.add(fresh_key)
        for seg in self.segments:
            if any(k == key for k, _c in seg.removes):
                seg.removes = sorted(
                    (fresh_key if k == key else k,
                     new_client if new_client is not None and k == key else c)
                    for k, c in seg.removes
                )
        ob.key = fresh_key
        if new_client is not None:
            ob.client = new_client
        self.slice_keys.discard(key)
        self.slice_keys.add(fresh_key)
        return [(fresh, {"type": 5, "pos1": start, "pos2": end})]

    # ------------------------------------------------------------ checkpoint
    def export_summary(self) -> dict:
        """Merge-tree snapshot: the acked segment array with full stamps
        (ref snapshotV1.ts:42 — header + segment chunks; we keep one chunk;
        stamps above minSeq are required so concurrent in-flight remote ops
        rebase correctly against the loaded state)."""
        segs = []
        for s in self.segments:
            if not acked(s.ins_key) or any(not acked(k) for k, _c in s.removes):
                raise RuntimeError("summarize with pending merge-tree state")
            entry = {
                "text": s.text,
                "ins": [s.ins_key, s.ins_client],
                "removes": [[k, c] for k, c in s.removes],
                "props": {str(p): [v, k] for p, (v, k) in sorted(s.props.items())},
            }
            if s.attr is not None:
                entry["attr"] = [[o, k] for o, k in s.attr]
            segs.append(entry)
        seg_index = {id(s): i for i, s in enumerate(self.segments)}
        obs = []
        # Issuers append their own obliterate at issuance, remotes at apply:
        # stamp-key order is the replica-independent canonical order.
        for ob in sorted(self.obliterates, key=lambda o: o.key):
            if not acked(ob.key):
                raise RuntimeError("summarize with pending merge-tree state")
            obs.append(
                {
                    "key": ob.key,
                    "client": ob.client,
                    "start": seg_index.get(id(ob.start_seg), -1),
                    "startSide": ob.start_side,
                    "end": seg_index.get(id(ob.end_seg), -1),
                    "endSide": ob.end_side,
                    "refSeq": ob.ref_seq,
                }
            )
        # Slice keys still observable from the summary (present on a segment
        # or in the window) — keeps remove-type labels through round-trips.
        live = {k for s in self.segments for k, _c in s.removes} | {
            ob.key for ob in self.obliterates
        }
        return {
            "segments": segs,
            "obliterates": obs,
            "minSeq": self.min_seq,
            "sliceKeys": sorted(self.slice_keys & live),
        }

    def import_summary(self, summary: dict) -> None:
        self.min_seq = summary["minSeq"]
        self.segments = [
            Segment(
                text=e["text"],
                ins_key=e["ins"][0],
                ins_client=e["ins"][1],
                removes=[(k, c) for k, c in e["removes"]],
                props={int(p): (v, k) for p, (v, k) in e["props"].items()},
                attr=(
                    [(o, k) for o, k in e["attr"]]
                    if "attr" in e else None
                ),
            )
            for e in summary["segments"]
        ]
        segs = self.segments
        self.obliterates = [
            Obliterate(
                key=o["key"],
                client=o["client"],
                start_seg=segs[o["start"]] if o["start"] >= 0 else None,
                start_side=o["startSide"],
                end_seg=segs[o["end"]] if o["end"] >= 0 else None,
                end_side=o["endSide"],
                ref_seq=o["refSeq"],
            )
            for o in summary.get("obliterates", [])
        ]
        self.slice_keys = set(summary.get("sliceKeys", [])) | {
            ob.key for ob in self.obliterates
        }

    # --------------------------------------------------------------- lifetime
    def update_min_seq(self, min_seq: int) -> None:
        if min_seq > self.min_seq:
            self.min_seq = min_seq
            # Obliterates below the window floor can never affect another
            # legal op (every refSeq >= minSeq sees them); release their
            # anchors first (ref Obliterates.setMinSeq).
            self.obliterates = [
                ob for ob in self.obliterates
                if not (acked(ob.key) and ob.key <= min_seq)
            ]
            self.zamboni()

    def _anchored_ids(self) -> set[int]:
        out: set[int] = set()
        for ob in self.obliterates:
            if ob.start_seg is not None:
                out.add(id(ob.start_seg))
            if ob.end_seg is not None:
                out.add(id(ob.end_seg))
        return out

    def zamboni(self) -> None:
        """Evict segments unreferenceable from any legal perspective.

        Segments anchoring a live obliterate are retained even when evictable
        (the anchor defines the obliterate's index window for concurrent
        inserts); they fall out once the obliterate leaves the collab window.
        """
        anchored = self._anchored_ids()
        self.segments = [
            s
            for s in self.segments
            if id(s) in anchored
            or not (s.removes and acked(s.removes[0][0]) and s.removes[0][0] <= self.min_seq)
        ]
