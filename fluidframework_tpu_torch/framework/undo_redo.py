"""The port's own copy of ``fluidframework_tpu/framework/undo_redo.py`` (no JAX in it).

undo-redo: revertible stacks over DDS local edits.

Reference parity: packages/framework/undo-redo — ``UndoRedoStackManager``
with revertibles capturing enough to build an INVERSE op against the
*current* state (not a state rollback): map sets capture the previous value;
string inserts track their range (sliding under later edits, via the
string's interval machinery); string removes capture the removed text and
re-insert at the slid position; tree edits invert the enriched changeset and
rebase the inverse over everything applied since.

Close/open semantics: edits captured between ``close_current_operation``
calls revert as one unit (ref UndoRedoStackManager operation stacks).
"""

from __future__ import annotations

from typing import Any

from ..dds.channels import SharedMapChannel, SharedStringChannel
from ..dds.markers import strip_markers
from ..dds.sequence_intervals import transform_position
from ..dds.tree.changeset import invert_node_change, rebase_node_change
from ..dds.tree.shared_tree import SharedTreeChannel


class _MapRevertible:
    def __init__(self, channel: SharedMapChannel, op: dict, prev: Any, had: bool) -> None:
        self._ch = channel
        self._op = op
        self._prev = prev
        self._had = had

    def revert(self) -> "_MapRevertible":
        key = self._op["key"]
        now_had = key in self._ch.keys()
        now_val = self._ch.get(key)
        if self._had:
            self._ch.set(key, self._prev)
        else:
            self._ch.delete(key)
        return _MapRevertible(self._ch, {"type": "set", "key": key}, now_val, now_had)


class _StringRangeTracker:
    """Tracks a range created by one local string op through converged
    events: the op's OWN event (matched by localSeq) establishes the range
    in converged coordinates (the reference's local-reference anchors);
    every other event slides it. Positions read back in the local view are
    exact once the channel has no unacked local edits of its own."""

    def __init__(self, channel: SharedStringChannel, local_seq: int, pos: int, length: int) -> None:
        self._ch = channel
        self._ls = local_seq
        # Sub-ranges [start, end): provisional local coords until our own
        # op's converged events land; a pending insert split before ack
        # yields several fragments, each tracked separately.
        self.ranges: list[list[int]] = [[pos, pos + length]]
        self._synced = False
        channel._converged_listeners.append(self._on_event)

    def _on_event(self, kind: str, pos: int, length: int, ls) -> None:
        if ls == self._ls:
            if not self._synced:
                self.ranges = []
                self._synced = True
            if kind == "insert":
                self.ranges.append([pos, pos + length])
            else:  # our own remove sequenced: track its collapse point
                self.ranges.append([pos, pos])
            return
        new_ranges: list[list[int]] = []
        for s0, e0 in self.ranges:
            if kind == "insert" and s0 < pos < e0:
                # Foreign content landed INSIDE the tracked range: the range
                # splits around it (the reference's tracking group follows
                # the split segments, never the foreign middle).
                new_ranges.append([s0, pos])
                new_ranges.append([pos + length, e0 + length])
                continue
            # Start shifts past an insert landing exactly on it (foreign
            # content stays outside); end keeps the stay-bias.
            s1 = transform_position(s0, kind, pos, length, after=True)
            e1 = max(s1, transform_position(e0, kind, pos, length))
            new_ranges.append([s1, e1])
        self.ranges = new_ranges

    @property
    def start(self) -> int:
        return self.ranges[0][0] if self.ranges else 0

    @property
    def end(self) -> int:
        return self.ranges[0][1] if self.ranges else 0

    def release(self) -> None:
        try:
            self._ch._converged_listeners.remove(self._on_event)
        except ValueError:
            pass


class _StringInsertRevertible:
    """Undo an insert = remove the inserted range at its slid position."""

    def __init__(self, channel: SharedStringChannel, local_seq: int, pos: int, length: int) -> None:
        self._ch = channel
        self._range = _StringRangeTracker(channel, local_seq, pos, length)

    def revert(self):
        self._range.release()
        # Tracked ranges are converged-coordinate once synced; translate them
        # into the local view (which may differ while unacked local edits are
        # in flight) before touching the string. Pending local inserts inside
        # a tracked range survive as holes in the mapped spans.
        local_spans: list[tuple[int, int]] = []
        for start, end in self._range.ranges:
            if end <= start:
                continue
            if self._range._synced:
                local_spans.extend(self._ch.backend.converged_spans_to_local(start, end))
            else:
                local_spans.append((start, end))
        # Remove every surviving fragment back-to-front; each removal hands
        # back its own re-insert revertible.
        inverses = []
        for start, end in sorted(local_spans, reverse=True):
            # Position-space slice (markers kept so indices are exact);
            # markers inside the range are not re-created by a later undo
            # (only their text survives capture).
            removed = strip_markers(self._ch.position_text()[start:end])
            ls = self._ch.remove_range(start, end)
            inverses.append(_StringRemoveRevertible(self._ch, ls, start, removed))
        return inverses or None

    def release(self) -> None:
        self._range.release()


class _StringRemoveRevertible:
    """Undo a remove = re-insert the captured text at the slid position."""

    def __init__(self, channel: SharedStringChannel, local_seq: int, pos: int, text: str) -> None:
        self._ch = channel
        self._text = text
        self._range = _StringRangeTracker(channel, local_seq, pos, 0)

    def revert(self) -> "_StringInsertRevertible":
        self._range.release()
        pos = self._range.start
        if self._range._synced:
            pos = self._ch.backend.converged_to_local(pos)
        ls = self._ch.insert_text(pos, self._text)
        return _StringInsertRevertible(self._ch, ls, pos, len(self._text))

    def release(self) -> None:
        self._range.release()


class _TreeRevertible:
    """Undo a tree edit = submit its inverse, rebased over every change the
    forest has applied since capture (the channel's applied_log carries
    local edits and bridged remote commits in exact application order, so
    the inverse lands in current coordinates)."""

    def __init__(self, channel: SharedTreeChannel, change) -> None:
        self._ch = channel
        self._inverse = invert_node_change(change)
        self._log_mark = len(channel.applied_log)

    def revert(self) -> "_TreeRevertible":
        inv = self._inverse
        for applied in self._ch.applied_log[self._log_mark :]:
            inv = rebase_node_change(inv, applied, a_after=True)
        self._ch.submit_change(inv)
        return _TreeRevertible(self._ch, inv)


class UndoRedoStackManager:
    """Groups revertibles into operations and drives undo/redo stacks."""

    def __init__(self) -> None:
        self._undo: list[list] = []
        self._redo: list[list] = []
        self._current: list = []

    # ------------------------------------------------------------ subscribe
    def capture_map_set(self, channel: SharedMapChannel, key: str, value: Any) -> None:
        had = key in channel.keys()
        prev = channel.get(key)
        channel.set(key, value)
        self._push(_MapRevertible(channel, {"type": "set", "key": key}, prev, had))

    def capture_map_delete(self, channel: SharedMapChannel, key: str) -> None:
        had = key in channel.keys()
        prev = channel.get(key)
        channel.delete(key)
        self._push(_MapRevertible(channel, {"type": "delete", "key": key}, prev, had))

    def capture_string_insert(self, channel: SharedStringChannel, pos: int, text: str) -> None:
        ls = channel.insert_text(pos, text)
        self._push(_StringInsertRevertible(channel, ls, pos, len(text)))

    def capture_string_remove(self, channel: SharedStringChannel, pos1: int, pos2: int) -> None:
        # pos1/pos2 are positions; slice the position-indexed view (markers
        # in range are removed but not re-created by undo).
        removed = strip_markers(channel.position_text()[pos1:pos2])
        ls = channel.remove_range(pos1, pos2)
        self._push(_StringRemoveRevertible(channel, ls, pos1, removed))

    def capture_tree_change(self, channel: SharedTreeChannel, change) -> None:
        channel.submit_change(change)
        # submit_change enriched the change in place: invertible now.
        self._push(_TreeRevertible(channel, change))

    # ----------------------------------------------------------- operations
    @staticmethod
    def _release_group(group: list) -> None:
        for r in group:
            release = getattr(r, "release", None)
            if release is not None:
                release()

    def _push(self, revertible) -> None:
        self._current.append(revertible)
        for group in self._redo:
            self._release_group(group)
        self._redo.clear()

    def close_current_operation(self) -> None:
        if self._current:
            self._undo.append(self._current)
            self._current = []

    @property
    def undoable(self) -> int:
        return len(self._undo) + (1 if self._current else 0)

    @property
    def redoable(self) -> int:
        return len(self._redo)

    @staticmethod
    def _revert_group(op: list) -> list:
        inverses: list = []
        for r in reversed(op):
            inv = r.revert()
            if inv is None:
                continue
            inverses.extend(inv if isinstance(inv, list) else [inv])
        return inverses

    def undo(self) -> bool:
        """Revert the newest operation; each revert hands back its own
        inverse revertible(s), which become the redo entry (symmetric
        stacks)."""
        self.close_current_operation()
        if not self._undo:
            return False
        self._redo.append(self._revert_group(self._undo.pop()))
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(self._revert_group(self._redo.pop()))
        return True

    def dispose(self) -> None:
        """Release every tracked revertible (stale listeners unhook)."""
        for stack in (self._undo, self._redo, [self._current]):
            for group in stack:
                self._release_group(group)
        self._undo.clear()
        self._redo.clear()
        self._current.clear()
