"""The port's own copy of ``fluidframework_tpu/dds/shared_matrix.py`` (no JAX in it).

SharedMatrix: 2-D sparse matrix over two permutation merge-trees.

Reference parity: packages/dds/matrix/src/matrix.ts — rows and cols are
independent merge-tree permutation vectors whose elements are stable
*handles*; cells are stored by (rowHandle, colHandle); a set-cell op carries
(row, col) positions that each replica resolves to handles under the op's
perspective (matrix.ts adjustPosition in processMessagesCore:1010).  Cell
conflicts: LWW by sequence order, or FWW once switched
(shouldSetCellBasedOnFWW, matrix.ts:987 — a remote write loses iff another
client wrote the cell after the op's refSeq).

Handle allocation is deterministic-by-sequencing: every replica allocates
real handles when a row/col insert op is *applied in sequence order*, so all
replicas agree without the reference's handle-table ack machinery.  Local
pending inserts use provisional handles from a disjoint range, remapped when
the insert acks (the reference achieves the same with per-op handle metadata).

Permutation vectors reuse ``RefMergeTree`` with handles chr-encoded into the
segment text (a handle is a codepoint; capacity 0x80000 real + provisional).
"""

from __future__ import annotations

from collections import deque
from typing import Any

from ..protocol.messages import MessageType, Nack, SequencedMessage, UnsequencedMessage
from ..protocol.stamps import ALL_ACKED, encode_stamp
from .mergetree_ref import RefMergeTree

PROV_BASE = 0x80000  # provisional (pending-local) handle space


class _Perm:
    """A permutation vector: merge-tree of chr-encoded handles."""

    def __init__(self) -> None:
        self.tree = RefMergeTree()
        self.next_handle = 0
        self.next_prov = PROV_BASE

    def alloc(self, n: int) -> str:
        # Handles are codepoints; the marker plane (U+E000..U+F8FF,
        # dds/markers.py) is reserved and stripped by visible_text, so
        # allocation skips it — handles are opaque, gaps are free.
        from .markers import MARKER_CP_BASE, MARKER_CP_END

        out = []
        for _ in range(n):
            if MARKER_CP_BASE <= self.next_handle < MARKER_CP_END:
                self.next_handle = MARKER_CP_END
            out.append(chr(self.next_handle))
            self.next_handle += 1
        return "".join(out)

    def alloc_prov(self, n: int) -> str:
        h = self.next_prov
        self.next_prov += n
        return "".join(chr(h + i) for i in range(n))

    def handle_at(self, pos: int, ref_seq: int, view_client: int) -> int:
        text = self.tree.visible_text(ref_seq, view_client)
        if pos >= len(text):
            raise IndexError(f"position {pos} beyond permutation length {len(text)}")
        return ord(text[pos])

    def handles(self, ref_seq: int, view_client: int) -> list[int]:
        return [ord(c) for c in self.tree.visible_text(ref_seq, view_client)]

    def remap_acked(self, seq: int) -> dict[int, int]:
        """After ack rewrote stamps localSeq->seq, replace provisional
        handles in just-acked segments with real ones (allocation order =
        segment order = deterministic across replicas)."""
        mapping: dict[int, int] = {}
        for seg in self.tree.segments:
            if seg.ins_key == seq and seg.text and ord(seg.text[0]) >= PROV_BASE:
                real = self.alloc(len(seg.text))
                for old_ch, new_ch in zip(seg.text, real):
                    mapping[ord(old_ch)] = ord(new_ch)
                seg.text = real
        return mapping


class SharedMatrix:
    """One client replica of a collaborative sparse 2-D matrix."""

    def __init__(self, client_id: str) -> None:
        self.client_id = client_id
        self.short_client = -1
        self.rows = _Perm()
        self.cols = _Perm()
        # Consensus cell state: (rowHandle, colHandle) -> value
        self.cells: dict[tuple[int, int], Any] = {}
        # FWW tracker: (rh, ch) -> (seq, clientId) of last applied write
        self._last_write: dict[tuple[int, int], tuple[int, str]] = {}
        self._fww = False
        # Optimistic overlay: (rh, ch) -> list of pending local values
        self._pending_cells: dict[tuple[int, int], list[Any]] = {}
        self._pending: deque[tuple[str, Any]] = deque()  # (kind, metadata)
        self._quorum: dict[str, int] = {}
        self._client_seq = 0
        self._local_seq = 0
        self._ref_seq = 0
        self.outbox: list[UnsequencedMessage] = []

    # ---------------------------------------------------------------- helpers
    def _require_joined(self) -> None:
        if self.short_client < 0:
            raise RuntimeError(
                f"matrix client {self.client_id!r} cannot edit before join delivery"
            )

    def _submit(self, contents: dict, pending_meta: Any) -> None:
        self._client_seq += 1
        self._pending.append((contents["type"], pending_meta))
        self.outbox.append(
            UnsequencedMessage(
                client_id=self.client_id,
                client_seq=self._client_seq,
                ref_seq=self._ref_seq,
                type=MessageType.OP,
                contents=contents,
            )
        )

    def take_outbox(self) -> list[UnsequencedMessage]:
        out = self.outbox
        self.outbox = []
        return out

    # ------------------------------------------------------------ local edits
    def switch_to_fww(self) -> None:
        """Switch cell conflict policy to first-writer-wins (one-way,
        reference switchSetCellPolicy matrix.ts:210); broadcast via the
        fwwMode flag on subsequent set ops."""
        self._fww = True

    def insert_rows(self, pos: int, count: int) -> None:
        self._require_joined()
        assert count > 0
        self._local_seq += 1
        prov = self.rows.alloc_prov(count)
        self.rows.tree.apply_insert(
            pos, prov, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit(
            {"type": "insertRows", "pos": pos, "count": count},
            ("rows", self._local_seq),
        )

    def insert_cols(self, pos: int, count: int) -> None:
        self._require_joined()
        assert count > 0
        self._local_seq += 1
        prov = self.cols.alloc_prov(count)
        self.cols.tree.apply_insert(
            pos, prov, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit(
            {"type": "insertCols", "pos": pos, "count": count},
            ("cols", self._local_seq),
        )

    def remove_rows(self, pos: int, count: int) -> None:
        self._require_joined()
        self._local_seq += 1
        self.rows.tree.apply_remove(
            pos, pos + count, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit(
            {"type": "removeRows", "pos": pos, "count": count},
            ("rows", self._local_seq),
        )

    def remove_cols(self, pos: int, count: int) -> None:
        self._require_joined()
        self._local_seq += 1
        self.cols.tree.apply_remove(
            pos, pos + count, encode_stamp(-1, self._local_seq), self.short_client, ALL_ACKED
        )
        self._submit(
            {"type": "removeCols", "pos": pos, "count": count},
            ("cols", self._local_seq),
        )

    def set_cell(self, row: int, col: int, value: Any) -> None:
        self._require_joined()
        rh = self.rows.handle_at(row, ALL_ACKED, self.short_client)
        ch = self.cols.handle_at(col, ALL_ACKED, self.short_client)
        self._pending_cells.setdefault((rh, ch), []).append(value)
        self._submit(
            {"type": "set", "row": row, "col": col, "value": value,
             "fwwMode": self._fww},
            ("cell", (rh, ch)),
        )

    # ---------------------------------------------------------------- inbound
    def process(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.JOIN:
            self._quorum[msg.contents["clientId"]] = msg.contents["short"]
            if msg.client_id == self.client_id and self.short_client < 0:
                self.short_client = msg.contents["short"]
            self._ref_seq = msg.seq
            return
        if msg.type != MessageType.OP:
            self._ref_seq = msg.seq
            return
        if msg.client_id == self.client_id:
            self._ack(msg)
        else:
            self._apply_remote(msg)
        self._ref_seq = msg.seq
        self.rows.tree.update_min_seq(msg.min_seq)
        self.cols.tree.update_min_seq(msg.min_seq)

    def process_nack(self, nack: Nack) -> None:
        raise RuntimeError(
            f"matrix op nacked for {self.client_id!r}: {nack.reason}; "
            "reconnect/resubmit is required"
        )

    def _remap_cells(self, mapping: dict[int, int], axis: int) -> None:
        if not mapping:
            return
        for store in (self.cells, self._last_write, self._pending_cells):
            for key in [k for k in store if k[axis] in mapping]:
                new_key = (
                    (mapping[key[0]], key[1]) if axis == 0 else (key[0], mapping[key[1]])
                )
                store[new_key] = store.pop(key)
        # Pending set-op metadata also references handles by value.
        remapped = deque()
        for kind, meta in self._pending:
            if kind == "set":
                rh, ch = meta[1]
                if axis == 0 and rh in mapping:
                    rh = mapping[rh]
                elif axis == 1 and ch in mapping:
                    ch = mapping[ch]
                meta = ("cell", (rh, ch))
            remapped.append((kind, meta))
        self._pending = remapped

    def _ack(self, msg: SequencedMessage) -> None:
        kind, meta = self._pending.popleft()
        c = msg.contents
        if kind in ("insertRows", "insertCols", "removeRows", "removeCols"):
            axis_name, local_seq = meta
            perm = self.rows if axis_name == "rows" else self.cols
            perm.tree.ack(local_seq, msg.seq)
            if kind.startswith("insert"):
                mapping = perm.remap_acked(msg.seq)
                self._remap_cells(mapping, 0 if axis_name == "rows" else 1)
        elif kind == "set":
            rh, ch = meta[1]
            pending = self._pending_cells.get((rh, ch))
            assert pending, "cell ack without pending write"
            value = pending.pop(0)
            if not pending:
                del self._pending_cells[(rh, ch)]
            if self._should_set(rh, ch, msg):
                self.cells[(rh, ch)] = value
                self._last_write[(rh, ch)] = (msg.seq, msg.client_id)
        else:
            raise ValueError(f"unknown matrix ack kind {kind}")

    def _should_set(self, rh: int, ch: int, msg: SequencedMessage) -> bool:
        if msg.contents.get("fwwMode") and not self._fww:
            self._fww = True
        if not self._fww:
            return True  # LWW: sequence order decides
        last = self._last_write.get((rh, ch))
        return last is None or last[1] == msg.client_id or msg.ref_seq >= last[0]

    def _apply_remote(self, msg: SequencedMessage) -> None:
        c = msg.contents
        kind = c["type"]
        client = self._quorum[msg.client_id]
        key = msg.seq
        if kind == "insertRows":
            self.rows.tree.apply_insert(
                c["pos"], self.rows.alloc(c["count"]), key, client, msg.ref_seq
            )
        elif kind == "insertCols":
            self.cols.tree.apply_insert(
                c["pos"], self.cols.alloc(c["count"]), key, client, msg.ref_seq
            )
        elif kind == "removeRows":
            self.rows.tree.apply_remove(
                c["pos"], c["pos"] + c["count"], key, client, msg.ref_seq
            )
        elif kind == "removeCols":
            self.cols.tree.apply_remove(
                c["pos"], c["pos"] + c["count"], key, client, msg.ref_seq
            )
        elif kind == "set":
            rh = self.rows.handle_at(c["row"], msg.ref_seq, client)
            ch = self.cols.handle_at(c["col"], msg.ref_seq, client)
            if self._should_set(rh, ch, msg):
                self.cells[(rh, ch)] = c["value"]
                self._last_write[(rh, ch)] = (msg.seq, msg.client_id)
        else:
            raise ValueError(f"unknown matrix op {kind}")

    # ------------------------------------------------------------------ views
    @property
    def row_count(self) -> int:
        return len(self.rows.handles(ALL_ACKED, self.short_client))

    @property
    def col_count(self) -> int:
        return len(self.cols.handles(ALL_ACKED, self.short_client))

    def get_cell(self, row: int, col: int) -> Any:
        """Optimistic read: pending local writes mask consensus."""
        rh = self.rows.handle_at(row, ALL_ACKED, self.short_client)
        ch = self.cols.handle_at(col, ALL_ACKED, self.short_client)
        pending = self._pending_cells.get((rh, ch))
        if pending:
            return pending[-1]
        return self.cells.get((rh, ch))

    def to_grid(self) -> list[list[Any]]:
        """Materialized consensus-perspective grid (for convergence tests)."""
        rows = self.rows.handles(ALL_ACKED, self.short_client)
        cols = self.cols.handles(ALL_ACKED, self.short_client)
        return [[self.cells.get((rh, ch)) for ch in cols] for rh in rows]


# ---------------------------------------------------------------------------
# Channel-boundary form
# ---------------------------------------------------------------------------

from ..protocol.channel import Channel, MessageCollection  # noqa: E402


class SharedMatrixChannel(Channel):
    """SharedMatrix over the channel boundary (ref SharedMatrixClass,
    matrix/src/matrix.ts): two permutation-vector merge-trees (rows/cols)
    plus a sparse consensus cell store with LWW or switchable FWW conflict
    policy. Reconnect regenerates row/col ops through the permutation trees
    (regeneratePendingOp) and re-anchors pending cell writes by handle.

    Local metadata per pending op:
      {"axis": "rows"|"cols", "localSeq": n}   for insert/remove ops
      {"cell": [rh, ch]}                       for set ops
    """

    channel_type = "sharedMatrix"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.rows = _Perm()
        self.cols = _Perm()
        self.cells: dict[tuple[int, int], Any] = {}
        self._last_write: dict[tuple[int, int], tuple[int, str]] = {}
        self._fww = False
        self._pending_cells: dict[tuple[int, int], list[Any]] = {}
        self._local_seq = 0
        # Metadata dicts minted for in-flight set ops: shared by reference
        # with the PendingStateManager, remapped in place when provisional
        # handles become real (insert ack).
        self._minted_md: list[dict] = []

    def _next_ls(self) -> int:
        self._local_seq += 1
        return self._local_seq

    def _perm(self, axis: str) -> _Perm:
        return self.rows if axis == "rows" else self.cols

    # ------------------------------------------------------------ local edits
    def switch_to_fww(self) -> None:
        self._fww = True

    def _insert(self, axis: str, pos: int, count: int) -> None:
        assert count > 0
        ls = self._next_ls()
        perm = self._perm(axis)
        perm.tree.apply_insert(
            pos, perm.alloc_prov(count), encode_stamp(-1, ls),
            perm.tree.local_client, ALL_ACKED,
        )
        op = "insertRows" if axis == "rows" else "insertCols"
        self.submit_local_message(
            {"type": op, "pos": pos, "count": count},
            {"axis": axis, "localSeq": ls},
        )

    def _remove(self, axis: str, pos: int, count: int) -> None:
        ls = self._next_ls()
        perm = self._perm(axis)
        perm.tree.apply_remove(
            pos, pos + count, encode_stamp(-1, ls), perm.tree.local_client, ALL_ACKED
        )
        op = "removeRows" if axis == "rows" else "removeCols"
        self.submit_local_message(
            {"type": op, "pos": pos, "count": count},
            {"axis": axis, "localSeq": ls},
        )

    def insert_rows(self, pos: int, count: int) -> None:
        self._insert("rows", pos, count)

    def insert_cols(self, pos: int, count: int) -> None:
        self._insert("cols", pos, count)

    def remove_rows(self, pos: int, count: int) -> None:
        self._remove("rows", pos, count)

    def remove_cols(self, pos: int, count: int) -> None:
        self._remove("cols", pos, count)

    def set_cell(self, row: int, col: int, value: Any) -> None:
        rh = self.rows.handle_at(row, ALL_ACKED, self.rows.tree.local_client)
        ch = self.cols.handle_at(col, ALL_ACKED, self.cols.tree.local_client)
        self._pending_cells.setdefault((rh, ch), []).append(value)
        md = {"cell": [rh, ch]}
        self._minted_md.append(md)
        self.submit_local_message(
            {"type": "set", "row": row, "col": col, "value": value, "fwwMode": self._fww},
            md,
        )

    # ---------------------------------------------------------------- inbound
    def _remap_cells(self, mapping: dict[int, int], axis: int) -> None:
        if not mapping:
            return
        for store in (self.cells, self._last_write, self._pending_cells):
            for key in [k for k in store if k[axis] in mapping]:
                nk = (mapping[key[0]], key[1]) if axis == 0 else (key[0], mapping[key[1]])
                store[nk] = store.pop(key)

    def _should_set(self, rh: int, ch: int, seq: int, ref_seq: int, client: str) -> bool:
        if not self._fww:
            return True  # LWW: sequence order decides
        last = self._last_write.get((rh, ch))
        return last is None or last[1] == client or ref_seq >= last[0]

    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            c = m.contents
            if c.get("fwwMode"):
                self._fww = True  # one-way switch broadcast (matrix.ts:210)
            if m.local:
                self._ack(c, m.local_metadata, env)
            else:
                self._apply_remote(c, env)
        for perm in (self.rows, self.cols):
            perm.tree.update_min_seq(env.min_seq)

    def _ack(self, c: dict, md: dict, env) -> None:
        if "axis" in md:
            perm = self._perm(md["axis"])
            perm.tree.ack(md["localSeq"], env.seq)
            if c["type"].startswith("insert"):
                mapping = perm.remap_acked(env.seq)
                self._remap_cells(mapping, 0 if md["axis"] == "rows" else 1)
                # Re-key pending metadata is unnecessary: channel metadata
                # holds handle VALUES only for cell ops, remapped above via
                # _pending_cells; later acks look up by (rh, ch) post-remap.
                self._md_remap(mapping, 0 if md["axis"] == "rows" else 1)
        else:
            rh, ch = md["cell"]
            if md in self._minted_md:
                self._minted_md.remove(md)
            pending = self._pending_cells.get((rh, ch))
            assert pending, "cell ack without pending write"
            value = pending.pop(0)
            if not pending:
                del self._pending_cells[(rh, ch)]
            if self._should_set(rh, ch, env.seq, env.ref_seq, env.client_id):
                self.cells[(rh, ch)] = value
                self._last_write[(rh, ch)] = (env.seq, env.client_id)

    def _md_remap(self, mapping: dict[int, int], axis: int) -> None:
        """In-flight set-op metadata references provisional handles; the
        dicts are shared by reference with the PendingStateManager, so remap
        them in place."""
        for md in self._minted_md:
            rh, ch = md["cell"]
            if axis == 0 and rh in mapping:
                md["cell"][0] = mapping[rh]
            elif axis == 1 and ch in mapping:
                md["cell"][1] = mapping[ch]

    def _apply_remote(self, c: dict, env) -> None:
        client = self._connection.short_id(env.client_id)
        kind = c["type"]
        key = env.seq
        if kind == "insertRows":
            self.rows.tree.apply_insert(
                c["pos"], self.rows.alloc(c["count"]), key, client, env.ref_seq
            )
        elif kind == "insertCols":
            self.cols.tree.apply_insert(
                c["pos"], self.cols.alloc(c["count"]), key, client, env.ref_seq
            )
        elif kind == "removeRows":
            self.rows.tree.apply_remove(
                c["pos"], c["pos"] + c["count"], key, client, env.ref_seq
            )
        elif kind == "removeCols":
            self.cols.tree.apply_remove(
                c["pos"], c["pos"] + c["count"], key, client, env.ref_seq
            )
        elif kind == "set":
            rh = self.rows.handle_at(c["row"], env.ref_seq, client)
            ch = self.cols.handle_at(c["col"], env.ref_seq, client)
            if self._should_set(rh, ch, env.seq, env.ref_seq, env.client_id):
                self.cells[(rh, ch)] = c["value"]
                self._last_write[(rh, ch)] = (env.seq, env.client_id)
        else:
            raise ValueError(f"unknown matrix op {kind!r}")

    # ----------------------------------------------------- reconnect / stash
    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        if "axis" in local_metadata:
            axis = local_metadata["axis"]
            perm = self._perm(axis)
            regenerated = perm.tree.regenerate_pending(
                local_metadata["localSeq"], self._next_ls, squash=squash
            )
            for fresh_ls, op in regenerated:
                if op["type"] == 0:  # merge-tree insert -> matrix insert
                    out = {
                        "type": "insertRows" if axis == "rows" else "insertCols",
                        "pos": op["pos1"],
                        "count": len(op["seg"]),
                    }
                else:  # remove
                    out = {
                        "type": "removeRows" if axis == "rows" else "removeCols",
                        "pos": op["pos1"],
                        "count": op["pos2"] - op["pos1"],
                    }
                self.submit_local_message(out, {"axis": axis, "localSeq": fresh_ls})
            return
        # Cell set: re-anchor by handle in the current local view; a write
        # into a removed row/col drops (reference setCell resubmit).
        rh, ch = local_metadata["cell"]
        rows = self.rows.handles(ALL_ACKED, self.rows.tree.local_client)
        cols = self.cols.handles(ALL_ACKED, self.cols.tree.local_client)
        if rh not in rows or ch not in cols:
            pending = self._pending_cells.get((rh, ch))
            if pending:
                pending.pop(0)
                if not pending:
                    del self._pending_cells[(rh, ch)]
            return
        md = {"cell": [rh, ch]}
        self._minted_md.append(md)
        self.submit_local_message(
            {
                "type": "set",
                "row": rows.index(rh),
                "col": cols.index(ch),
                "value": contents["value"],
                "fwwMode": self._fww,
            },
            md,
        )

    def apply_stashed(self, contents: Any) -> Any:
        c = contents
        kind = c["type"]
        if kind in ("insertRows", "insertCols", "removeRows", "removeCols"):
            axis = "rows" if "Rows" in kind else "cols"
            perm = self._perm(axis)
            ls = self._next_ls()
            if kind.startswith("insert"):
                perm.tree.apply_insert(
                    c["pos"], perm.alloc_prov(c["count"]),
                    encode_stamp(-1, ls), perm.tree.local_client, ALL_ACKED,
                )
            else:
                perm.tree.apply_remove(
                    c["pos"], c["pos"] + c["count"],
                    encode_stamp(-1, ls), perm.tree.local_client, ALL_ACKED,
                )
            return {"axis": axis, "localSeq": ls}
        rh = self.rows.handle_at(c["row"], ALL_ACKED, self.rows.tree.local_client)
        ch = self.cols.handle_at(c["col"], ALL_ACKED, self.cols.tree.local_client)
        self._pending_cells.setdefault((rh, ch), []).append(c["value"])
        md = {"cell": [rh, ch]}
        self._minted_md.append(md)
        return md

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        for perm in (self.rows, self.cols):
            for seg in perm.tree.segments:
                if not acked_key(seg.ins_key) or any(
                    not acked_key(k) for k, _c in seg.removes
                ):
                    raise RuntimeError("summarize with pending matrix state")
        if self._pending_cells:
            raise RuntimeError("summarize with pending matrix cell writes")

        def perm_summary(perm: _Perm) -> dict:
            return {
                "segments": [
                    {
                        "handles": [ord(c) for c in s.text],
                        "ins": [s.ins_key, s.ins_client],
                        "removes": [[k, c] for k, c in s.removes],
                    }
                    for s in perm.tree.segments
                ],
                "minSeq": perm.tree.min_seq,
                "nextHandle": perm.next_handle,
            }

        return {
            "rows": perm_summary(self.rows),
            "cols": perm_summary(self.cols),
            "cells": [[list(k), v] for k, v in self.cells.items()],
            "lastWrite": [[list(k), list(v)] for k, v in self._last_write.items()],
            "fww": self._fww,
        }

    def load(self, summary: dict[str, Any]) -> None:
        from .mergetree_ref import Segment

        def load_perm(perm: _Perm, data: dict) -> None:
            perm.tree.min_seq = data["minSeq"]
            perm.next_handle = data["nextHandle"]
            perm.tree.segments = [
                Segment(
                    text="".join(chr(h) for h in e["handles"]),
                    ins_key=e["ins"][0],
                    ins_client=e["ins"][1],
                    removes=[(k, c) for k, c in e["removes"]],
                )
                for e in data["segments"]
            ]

        load_perm(self.rows, summary["rows"])
        load_perm(self.cols, summary["cols"])
        self.cells = {tuple(k): v for k, v in summary["cells"]}
        self._last_write = {tuple(k): tuple(v) for k, v in summary["lastWrite"]}
        self._fww = summary["fww"]

    # ------------------------------------------------------------------ views
    @property
    def row_count(self) -> int:
        return len(self.rows.handles(ALL_ACKED, self.rows.tree.local_client))

    @property
    def col_count(self) -> int:
        return len(self.cols.handles(ALL_ACKED, self.cols.tree.local_client))

    def get_cell(self, row: int, col: int) -> Any:
        rh = self.rows.handle_at(row, ALL_ACKED, self.rows.tree.local_client)
        ch = self.cols.handle_at(col, ALL_ACKED, self.cols.tree.local_client)
        pending = self._pending_cells.get((rh, ch))
        if pending:
            return pending[-1]
        return self.cells.get((rh, ch))

    def to_grid(self) -> list[list[Any]]:
        rows = self.rows.handles(ALL_ACKED, self.rows.tree.local_client)
        cols = self.cols.handles(ALL_ACKED, self.cols.tree.local_client)
        return [[self.cells.get((rh, ch)) for ch in cols] for rh in rows]


from ..protocol.stamps import acked as acked_key  # noqa: E402


class _MatrixFactory:
    channel_type = SharedMatrixChannel.channel_type

    def create(self, channel_id: str) -> SharedMatrixChannel:
        return SharedMatrixChannel(channel_id)


SharedMatrixFactory = _MatrixFactory()
