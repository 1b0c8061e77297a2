"""The port's own copy of ``fluidframework_tpu/dds/sequence_intervals.py`` (no JAX in it).

Interval collections: ranges anchored to SharedString positions.

Reference parity: sequence's ``IntervalCollection``
(packages/dds/sequence/src/intervalCollection.ts:736) — named collections of
intervals (id, start, end, properties) anchored into a SharedString, with
add/change/delete ops sequenced through the string's channel, slide-on-remove
endpoint semantics, and overlap queries (intervalIndex/).

Design (derived, not ported): the reference anchors endpoints with merge-tree
local references that slide when segments are removed. Here endpoints live in
the string's current acked coordinate space and are TRANSFORMED by every
sequenced string op; incoming interval ops are first transformed over the
string ops the sender had not seen (its refSeq → now), using a collab-window
log of string ops. Every replica performs identical deterministic transforms
in sequence order, so interval state converges exactly like the string
itself. Endpoint rules (matching reference slide semantics):
- insert at p, length L: positions > p shift by +L; an endpoint exactly at p
  stays (anchors bind to the character they precede).
- remove [a, b): endpoints inside clamp (slide) to a; later positions shift
  by -(b-a).

Conflict rules: last-writer-wins per interval id for change/delete (delete
wins over a concurrent change it hasn't seen; a change to a deleted interval
is a no-op), mirroring intervalCollection.ts ack logic.

Sided endpoints (opt-in, like the reference's intervalStickinessEnabled /
InteriorSequencePlace path, merge-tree/src/sequencePlace.ts:50 +
sequence/src/intervals/intervalUtils.ts computeStickinessFromSide): an
endpoint may be a ``(pos, Side)`` place — the anchor binds to the CHARACTER
at ``pos``, on the flank the side names — or the literals ``"start"`` /
``"end"`` (the special endpoint segments, normalized to pos=-1 exactly as
``normalizePlace`` does). Sides determine:
- inclusion: start Side.BEFORE includes char pos, start Side.AFTER starts at
  pos+1 (exclusive); end Side.AFTER includes char pos, end Side.BEFORE ends
  at pos-1 (exclusive);
- stickiness (emergent): a start bound AFTER keeps its anchor when text is
  inserted just after it, so the inserted text falls inside the interval
  (START sticky); an end bound BEFORE follows its char right when text is
  inserted just before it, pulling the insert inside (END sticky — the
  reference's default);
- slide-on-remove direction: a BEFORE anchor whose character is removed
  slides FORWARD to the next surviving character (or the "end" sentinel
  when none survives); an AFTER anchor slides BACKWARD (or to "start").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator


class Side:
    """Endpoint flank (ref merge-tree sequencePlace.ts:50)."""

    BEFORE = 0
    AFTER = 1


class IntervalStickiness:
    """Which flanks an interval expands across (ref
    sequence/src/intervals/intervalUtils.ts IntervalStickiness)."""

    NONE = 0b00
    START = 0b01
    END = 0b10
    FULL = 0b11


# Sentinel position for the special endpoint segments ("start"/"end"), as
# normalizePlace encodes them: pos=-1, side AFTER = start-of-string anchor,
# pos=-1, side BEFORE = end-of-string anchor.
SENTINEL_POS = -1


def normalize_place(place) -> tuple[int, int]:
    """``pos | (pos, side) | "start" | "end"`` -> (pos, side), mirroring
    normalizePlace (sequencePlace.ts:103): bare ints get Side.BEFORE."""
    if place == "start":
        return (SENTINEL_POS, Side.AFTER)
    if place == "end":
        return (SENTINEL_POS, Side.BEFORE)
    if isinstance(place, int):
        return (place, Side.BEFORE)
    pos, side = place
    return (int(pos), int(side))


def compute_stickiness(start_side: int, end_side: int) -> int:
    """ref intervalUtils.ts computeStickinessFromSide (sentinel endpoints
    are already encoded with the sticky side by normalize_place)."""
    s = IntervalStickiness.NONE
    if start_side == Side.AFTER:
        s |= IntervalStickiness.START
    if end_side == Side.BEFORE:
        s |= IntervalStickiness.END
    return s


def place_boundary(pos: int, side: int) -> float:
    """Order key for validity checks: the inter-character boundary the place
    names (sentinels at +-inf)."""
    if pos == SENTINEL_POS:
        return float("-inf") if side == Side.AFTER else float("inf")
    return pos + (1 if side == Side.AFTER else 0)


def transform_place(
    pos: int, side: int, kind: str, op_pos: int, length: int
) -> tuple[int, int]:
    """Slide one SIDED endpoint over one sequenced string op.

    Char-bound anchor semantics: the anchor follows its character, so an
    insert shifts it iff the insert lands at or before the character. A
    remove that swallows the character slides BEFORE-anchors forward to the
    first survivor (op_pos after the splice) and AFTER-anchors backward to
    op_pos-1, degrading to the start/end sentinels at the string edges —
    the reference's slide with canSlideToEndpoint
    (sequence/src/intervals/sequenceInterval.ts:967)."""
    if pos == SENTINEL_POS:
        return (pos, side)
    if kind == "insert":
        return (pos + length, side) if op_pos <= pos else (pos, side)
    # remove of [op_pos, op_pos + length)
    if pos < op_pos:
        return (pos, side)
    if pos >= op_pos + length:
        return (pos - length, side)
    if side == Side.BEFORE:
        return (op_pos, side)  # forward; may now name one-past-the-end —
        # the caller clamps to the end sentinel when it knows the length
    if op_pos == 0:
        return (SENTINEL_POS, Side.AFTER)  # backward off the front: "start"
    return (op_pos - 1, side)


@dataclass
class SequenceInterval:
    """``start_side``/``end_side`` of ``None`` mark a legacy (unsided)
    interval: plain positions with the original transform rules, byte-stable
    against old summaries."""

    interval_id: str
    start: int
    end: int
    props: dict[str, Any] = field(default_factory=dict)
    start_side: int | None = None
    end_side: int | None = None

    @property
    def sided(self) -> bool:
        return self.start_side is not None

    @property
    def stickiness(self) -> int:
        if not self.sided:
            return IntervalStickiness.END  # the reference default
        return compute_stickiness(self.start_side, self.end_side)

    def first_char(self, length: int) -> int:
        """Smallest character index inside the interval. ``length`` resolves
        a start pinned at the "end" sentinel (empty interval at the back)."""
        if not self.sided:
            return self.start
        if self.start == SENTINEL_POS:
            return 0 if self.start_side == Side.AFTER else length
        return self.start if self.start_side == Side.BEFORE else self.start + 1

    def last_char(self, length: int) -> int:
        """Largest character index inside the interval. ``length`` resolves
        the "end" sentinel; an end pinned at "start" (empty interval at the
        front) reads as -1."""
        if not self.sided:
            return self.end
        if self.end == SENTINEL_POS:
            return length - 1 if self.end_side == Side.BEFORE else -1
        return self.end if self.end_side == Side.AFTER else self.end - 1

    def to_json(self) -> dict:
        out = {
            "id": self.interval_id,
            "start": self.start,
            "end": self.end,
            "props": dict(self.props),
        }
        if self.sided:
            out["startSide"] = self.start_side
            out["endSide"] = self.end_side
        return out

    @staticmethod
    def from_json(d: dict) -> "SequenceInterval":
        return SequenceInterval(
            d["id"], d["start"], d["end"], dict(d["props"]),
            d.get("startSide"), d.get("endSide"),
        )


def transform_position(
    pos: int, kind: str, op_pos: int, length: int, after: bool = False
) -> int:
    """Slide one endpoint over one sequenced string op.

    ``after`` is the insert tie-bias (the reference's reference-type
    before/after slide flags): when an insert lands exactly AT ``pos``,
    after=False keeps the position (it binds to the character it precedes;
    interval semantics), after=True shifts right past the inserted content
    (range-start tracking for undo)."""
    if kind == "insert":
        shift = pos >= op_pos if after else pos > op_pos
        return pos + length if shift else pos
    # remove of [op_pos, op_pos + length)
    if pos <= op_pos:
        return pos
    if pos < op_pos + length:
        return op_pos  # inside the removed range: slide to its start
    return pos - length


class StringOpLog:
    """Collab-window log of sequenced string edits, for transforming interval
    ops issued against an older refSeq (the positional analog of creating a
    merge-tree reference under the op's perspective)."""

    def __init__(self) -> None:
        self._log: list[tuple[int, str, int, int]] = []  # (seq, kind, pos, len)

    def record(self, seq: int, kind: str, pos: int, length: int) -> None:
        """Append, coalescing contiguous same-seq runs: a pending insert the
        author's own later edits split acks as several adjacent converged
        fragments where remote replicas saw one segment — the transform
        effect is identical (adjacent splits compose), so the log normalizes
        to the merged form and summaries stay byte-identical across
        replicas. Inserts record ascending (extend right); removes record
        back-to-front (extend left)."""
        if self._log:
            lseq, lkind, lpos, llen = self._log[-1]
            if lseq == seq and lkind == kind:
                if kind == "insert" and lpos + llen == pos:
                    self._log[-1] = (seq, kind, lpos, llen + length)
                    return
                if kind == "remove" and pos + length == lpos:
                    self._log[-1] = (seq, kind, pos, llen + length)
                    return
        self._log.append((seq, kind, pos, length))

    def transform_from(self, pos: int, ref_seq: int) -> int:
        for seq, kind, op_pos, length in self._log:
            if seq > ref_seq:
                pos = transform_position(pos, kind, op_pos, length)
        return pos

    def transform_place_from(self, pos: int, side: int, ref_seq: int) -> tuple[int, int]:
        """Sided-endpoint form of transform_from (resubmit of pending sided
        interval ops)."""
        for seq, kind, op_pos, length in self._log:
            if seq > ref_seq:
                pos, side = transform_place(pos, side, kind, op_pos, length)
        return pos, side

    def trim(self, min_seq: int) -> None:
        self._log = [e for e in self._log if e[0] > min_seq]

    def to_json(self) -> list:
        return [list(e) for e in self._log]

    def load_json(self, data: list) -> None:
        self._log = [tuple(e) for e in data]


def _apply_change_endpoints(iv: SequenceInterval, op: dict) -> None:
    """Endpoint-moving changes set the interval's sidedness as a whole:
    a sided op (both sides present, enforced at submit) makes it sided,
    a plain-int op reverts it to legacy. Never leaves one side set."""
    if op.get("start") is None and op.get("end") is None:
        return
    if "startSide" in op or "endSide" in op:
        iv.start, iv.end = op["start"], op["end"]
        iv.start_side = op.get("startSide", Side.BEFORE)
        iv.end_side = op.get("endSide", Side.BEFORE)
        return
    if op.get("start") is not None:
        iv.start = op["start"]
    if op.get("end") is not None:
        iv.end = op["end"]
    if iv.sided:
        # Reverting a sided interval via a single-endpoint legacy change:
        # resolve any sentinel left behind to a deterministic legacy pos.
        if iv.start == SENTINEL_POS and op.get("start") is None:
            iv.start = 0
        if iv.end == SENTINEL_POS and op.get("end") is None:
            iv.end = max(iv.start, 1 << 30)
    iv.start_side = iv.end_side = None


class IntervalCollection:
    """One named collection. Sequenced state + optimistic pending overlay
    (pending local add/change/delete mask remote state until acked).

    ``length_fn`` resolves the current string length (for the "end" sentinel
    and forward-slide clamping); hosts that never use sided endpoints may
    omit it."""

    def __init__(self, label: str, submit_fn, length_fn=None) -> None:
        self.label = label
        self._submit = submit_fn
        self._length = length_fn or (lambda: 1 << 30)
        self.sequenced: dict[str, SequenceInterval] = {}
        self._pending: list[dict] = []  # local ops in flight, in order
        self._id_counter = 0

    @staticmethod
    def _is_sided(start, end) -> bool:
        return not (isinstance(start, int) and isinstance(end, int))

    def _validate_places(self, sp, ss, ep, es) -> None:
        n = self._length()
        for pos in (sp, ep):
            assert pos == SENTINEL_POS or 0 <= pos < n, (
                f"interval place {pos} outside string of length {n}"
            )
        assert place_boundary(sp, ss) <= place_boundary(ep, es), (
            "interval end before start"
        )

    # ------------------------------------------------------------ local edits
    def add(self, start, end, props: dict | None = None, interval_id: str | None = None) -> str:
        if interval_id is None:
            self._id_counter += 1
            interval_id = f"{self.label}-{self._id_counter}"
        op = {
            "action": "add",
            "id": interval_id,
            "props": dict(props or {}),
        }
        if self._is_sided(start, end):
            sp, ss = normalize_place(start)
            ep, es = normalize_place(end)
            self._validate_places(sp, ss, ep, es)
            op.update(start=sp, end=ep, startSide=ss, endSide=es)
        else:
            assert 0 <= start <= end
            op.update(start=start, end=end)
        self._pending.append(op)
        self._submit(self.label, op)
        return interval_id

    def change(self, interval_id: str, start=None, end=None, props: dict | None = None) -> None:
        """A change that moves endpoints fully determines the interval's
        sidedness: sided places require BOTH endpoints (like the reference's
        change({start, end}) with InteriorSequencePlaces), plain ints revert
        the interval to legacy semantics."""
        op = {"action": "change", "id": interval_id, "start": start, "end": end, "props": props}
        if (start is not None or end is not None) and self._is_sided(
            start if start is not None else 0, end if end is not None else 0
        ):
            assert start is not None and end is not None, (
                "sided change requires both endpoints"
            )
            sp, ss = normalize_place(start)
            ep, es = normalize_place(end)
            self._validate_places(sp, ss, ep, es)
            op.update(start=sp, end=ep, startSide=ss, endSide=es)
        self._pending.append(op)
        self._submit(self.label, op)

    def delete(self, interval_id: str) -> None:
        op = {"action": "delete", "id": interval_id}
        self._pending.append(op)
        self._submit(self.label, op)

    # ---------------------------------------------------------------- inbound
    def apply_sequenced(self, op: dict, local: bool) -> None:
        if local:
            head = self._pending.pop(0)
            assert head["action"] == op["action"] and head["id"] == op["id"], (
                "interval pending skew"
            )
        action = op["action"]
        if action == "add":
            self.sequenced[op["id"]] = SequenceInterval(
                op["id"], op["start"], op["end"], dict(op["props"]),
                op.get("startSide"), op.get("endSide"),
            )
        elif action == "delete":
            self.sequenced.pop(op["id"], None)
        elif action == "change":
            iv = self.sequenced.get(op["id"])
            if iv is None:
                return  # changed a concurrently-deleted interval: no-op
            _apply_change_endpoints(iv, op)
            if op["props"]:
                iv.props.update(op["props"])
        else:
            raise ValueError(f"unknown interval action {action!r}")

    def transform_endpoints(self, kind: str, pos: int, length: int) -> None:
        """A sequenced string edit landed: slide every acked endpoint.
        Sided endpoints may transiently name one-past-the-end mid-op (a
        forward slide off a removed suffix); ``finalize_op`` clamps them
        once the whole op's ranges have been applied."""
        for iv in self.sequenced.values():
            if iv.sided:
                iv.start, iv.start_side = transform_place(
                    iv.start, iv.start_side, kind, pos, length
                )
                iv.end, iv.end_side = transform_place(
                    iv.end, iv.end_side, kind, pos, length
                )
                continue
            iv.start = transform_position(iv.start, kind, pos, length)
            iv.end = transform_position(iv.end, kind, pos, length)
            if iv.end < iv.start:
                iv.end = iv.start

    def has_sided(self) -> bool:
        return any(iv.sided for iv in self.sequenced.values())

    def finalize_op(self, new_length: int) -> None:
        """After all ranges of one sequenced string op: degrade forward
        slides off the back of the string to the "end" sentinel, and
        collapse crossed endpoints to an empty interval at the start place
        (same boundary on both sides)."""
        for iv in self.sequenced.values():
            if not iv.sided:
                continue
            if iv.start != SENTINEL_POS and iv.start >= new_length:
                iv.start, iv.start_side = SENTINEL_POS, Side.BEFORE
            if iv.end != SENTINEL_POS and iv.end >= new_length:
                iv.end, iv.end_side = SENTINEL_POS, Side.BEFORE
            if place_boundary(iv.start, iv.start_side) > place_boundary(
                iv.end, iv.end_side
            ):
                iv.end, iv.end_side = iv.start, iv.start_side

    # ------------------------------------------------------------------ views
    def get(self, interval_id: str) -> SequenceInterval | None:
        """Optimistic read: pending local ops overlay the sequenced state."""
        iv = self.sequenced.get(interval_id)
        iv = SequenceInterval.from_json(iv.to_json()) if iv is not None else None
        for op in self._pending:
            if op["id"] != interval_id:
                continue
            if op["action"] == "add":
                iv = SequenceInterval(
                    op["id"], op["start"], op["end"], dict(op["props"]),
                    op.get("startSide"), op.get("endSide"),
                )
            elif op["action"] == "delete":
                iv = None
            elif op["action"] == "change" and iv is not None:
                _apply_change_endpoints(iv, op)
                if op["props"]:
                    iv.props.update(op["props"])
        return iv

    def ids(self) -> set[str]:
        out = set(self.sequenced)
        for op in self._pending:
            if op["action"] == "add":
                out.add(op["id"])
            elif op["action"] == "delete":
                out.discard(op["id"])
        return out

    def __iter__(self) -> Iterator[SequenceInterval]:
        n = self._length()
        return iter(sorted(
            (self.get(i) for i in self.ids()),
            key=lambda v: (v.first_char(n), v.last_char(n), v.interval_id),
        ))

    def overlapping(self, start: int, end: int) -> list[SequenceInterval]:
        """Intervals whose covered characters intersect [start, end], bounds
        inclusive — the reference's findOverlappingIntervals contract
        (intervalIndex/overlappingIntervalsIndex.ts)."""
        n = self._length()
        return [
            iv for iv in self
            if iv.first_char(n) <= end and iv.last_char(n) >= start
        ]

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict:
        if self._pending:
            raise RuntimeError("summarize with pending interval ops")
        return {"intervals": [iv.to_json() for iv in self.sequenced.values()]}

    def load(self, data: dict) -> None:
        self.sequenced = {
            e["id"]: SequenceInterval.from_json(e) for e in data["intervals"]
        }
