"""Pooled, slotted columnar mark store for the tree changeset hot path.

The port's own copy of ``fluidframework_tpu/dds/tree/mark_pool.py``
(unchanged): the port imports nothing of the JAX package, so it keeps the
host algebra here.

The object-mark fold (changeset.py) pays one Python object per mark per
rebase — ``Mark.__init__`` alone measured ~30% of config5 host time, and
the EditManager window fold re-materializes every mark of every cached
cross-rebase stream entry on every commit.  This module keeps the SAME
mark algebra but stores sequence-field mark lists as parallel int32/object
columns inside reusable pool blocks:

- ``MarkPool``: fixed-size blocks of four ``array('i')`` columns
  (kind / a / b / c) plus one object column (insert content, removed
  subtrees, nested NodeChanges).  Lists are bump-allocated contiguous
  spans; a block whose spans all died is recycled through a free list, so
  steady-state rebase traffic allocates no new storage at all
  (``mark_pool_hit_rate`` in engine health is the recycle rate).
- ``PooledMarks``: an immutable (pool, block, start, n) span handle.
  Changesets hold these handles in their ``fields`` dicts; the field-kind
  registry dispatches them through ``PooledSequenceFieldKind`` so the
  generic rebase/compose/invert algebra works unchanged.
- rebase runs as COLUMN passes (``_rebase_cols``): the per-input-node fate
  map and sided boundary map of changeset.rebase_marks computed over runs
  instead of per-node Python objects, with two structural fast paths —
  a non-structural ``b`` (only Skip/Modify) returns ``a``'s span UNCHANGED
  when no Modify positions collide (the incremental change-propagation
  reuse: a commit rebasing over a disjoint trunk window keeps its cached
  stream spans instead of re-materializing marks), and the fused
  ``rebase_pair`` computes both legs of the EditManager bridge from one
  pass instead of two mirrored walks.

Byte-identity contract: every pooled operation produces the same wire
JSON (``marks_to_json`` shape) as the object path — the object fold stays
alive as the fuzz oracle (``TreeBatchEngine(mark_pool=False)``,
``EditManager(mark_pool=None)``), the same pattern as every prior kernel
migration.  Mark lists containing moves (both sides structural) fall back
to the object ``rebase_marks`` — materialize, rebase, re-pool — so the
fallback IS the oracle and cannot diverge.

Pooled spans are immutable after ``seal``: enrichment (apply-time
``Remove.detached`` / value priors) only ever happens on the MATERIALIZED
trunk commit the EditManager returns, never on pooled stream state, which
is what makes identity sharing across fold stages safe.
"""

from __future__ import annotations

from array import array
from typing import Any

from .changeset import (
    Commit,
    Insert,
    Modify,
    MoveIn,
    MoveOut,
    NodeChange,
    Remove,
    Skip,
    _commit_meta,
    change_to_json,
    rebase_marks,
)
from .field_kinds import (
    FIELD_KINDS,
    FieldKind,
    OptionalChange,
    field_change_from_json,
    kind_of,
)
from .forest import Node

# Kind codes, span flags and sentinels are the protocol-layer mark schema
# (protocol/mark_schema.py) — shared with the device kernels.  Historical
# local names kept: every pass below reads them, and dds-internal callers
# import them from here.
from ...protocol.mark_schema import (  # noqa: F401  (re-export shim)
    F_CANONICAL,
    F_INSERT,
    F_MODIFY,
    F_MOVE,
    F_REMOVE,
    F_STRUCTURAL as _F_STRUCTURAL,
    K_INSERT,
    K_MODIFY,
    K_MOVEIN,
    K_MOVEOUT,
    K_REMOVE,
    K_SKIP,
    NONE_OFF as _NONE_OFF,
)


class _Block:
    """One pool block: parallel int columns + an object column."""

    __slots__ = ("kind", "a", "b", "c", "obj", "used", "live")

    def __init__(self, size: int) -> None:
        zeros = array("i", bytes(4 * size))
        self.kind = array("i", zeros)
        self.a = array("i", zeros)
        self.b = array("i", zeros)
        self.c = array("i", zeros)
        self.obj: list = [None] * size
        self.used = 0
        self.live = 0  # live spans (block recycles at zero)


class MarkPool:
    """Slab allocator for mark-list spans with whole-block recycling.

    One pool is shared across a fleet (TreeBatchEngine owns one for all
    its EditManagers) so occupancy and reuse gauges are fleet-wide."""

    BLOCK = 4096

    __slots__ = (
        "block_size", "blocks", "_free", "_cur",
        "spans_allocated", "blocks_allocated", "blocks_recycled",
        "reuse_hits", "live_slots",
    )

    def __init__(self, block_size: int = BLOCK) -> None:
        self.block_size = block_size
        self.blocks: list[_Block] = []
        self._free: list[int] = []
        self._cur = -1
        self.spans_allocated = 0
        self.blocks_allocated = 0
        self.blocks_recycled = 0
        self.reuse_hits = 0  # rebases answered by an existing span
        self.live_slots = 0

    # ------------------------------------------------------------ allocation
    def _fresh_block(self, size: int) -> int:
        if size <= self.block_size and self._free:
            self.blocks_recycled += 1
            idx = self._free.pop()
            self.blocks[idx].used = 0
            return idx
        self.blocks_allocated += 1
        self.blocks.append(_Block(max(size, self.block_size)))
        return len(self.blocks) - 1

    def _alloc(self, n: int) -> tuple[int, int]:
        """Reserve a contiguous span of n slots -> (block index, start)."""
        if n > self.block_size:
            bi = self._fresh_block(n)  # oversized: dedicated block
        else:
            bi = self._cur
            if bi < 0 or self.blocks[bi].used + n > len(self.blocks[bi].obj):
                bi = self._cur = self._fresh_block(self.block_size)
        blk = self.blocks[bi]
        start = blk.used
        blk.used += n
        blk.live += 1
        self.spans_allocated += 1
        self.live_slots += n
        return bi, start

    def _release(self, bi: int, start: int, n: int) -> None:
        blk = self.blocks[bi]
        blk.obj[start : start + n] = [None] * n  # drop object refs now
        blk.live -= 1
        self.live_slots -= n
        if blk.live == 0 and bi != self._cur:
            if len(blk.obj) == self.block_size:
                self._free.append(bi)
            # Oversized blocks are one-shot; keep the slot list entry (a
            # tombstone) so span handles stay valid indices.

    # ----------------------------------------------------------------- stats
    def occupancy(self) -> float:
        total = sum(len(b.obj) for b in self.blocks)
        return self.live_slots / total if total else 0.0

    def stats(self) -> dict:
        return {
            "mark_pool_blocks": len(self.blocks),
            "mark_pool_blocks_recycled": self.blocks_recycled,
            "mark_pool_spans": self.spans_allocated,
            "mark_pool_live_slots": self.live_slots,
            "mark_pool_reuse_hits": self.reuse_hits,
            "pool_occupancy": round(self.occupancy(), 4),
        }

    # ------------------------------------------------------------------ seal
    def seal(self, ks: list, as_: list, bs: list, cs: list, objs: list,
             flags: int) -> "PooledMarks":
        n = len(ks)
        bi, start = self._alloc(n)
        blk = self.blocks[bi]
        if n <= 4:
            # Tiny spans (the overwhelming majority): per-element stores
            # beat four list->array conversions.
            bk, ba, bb, bc, bo = blk.kind, blk.a, blk.b, blk.c, blk.obj
            for i in range(n):
                j = start + i
                bk[j] = ks[i]
                ba[j] = as_[i]
                bb[j] = bs[i]
                bc[j] = cs[i]
                bo[j] = objs[i]
        else:
            end = start + n
            blk.kind[start:end] = array("i", ks)
            blk.a[start:end] = array("i", as_)
            blk.b[start:end] = array("i", bs)
            blk.c[start:end] = array("i", cs)
            blk.obj[start:end] = objs
        return PooledMarks(self, bi, start, n, flags)


class PooledMarks:
    """Immutable columnar mark list: a span handle into a MarkPool.

    ``kind`` (the class attribute) routes registry dispatch: the field-kind
    registry resolves pooled lists to PooledSequenceFieldKind, so the
    generic changeset algebra (rebase_node_change & co.) works on pooled
    changesets without modification."""

    __slots__ = ("pool", "blk", "start", "n", "flags", "_mods", "_runs")

    kind = "sequence_pooled"  # registry tag (never an instance attribute)

    def __init__(self, pool: MarkPool, blk: int, start: int, n: int,
                 flags: int) -> None:
        self.pool = pool
        self.blk = blk
        self.start = start
        self.n = n
        self.flags = flags
        self._mods = None  # lazy ((input_pos, span_idx), ...) Modify sites
        self._runs = None  # lazy fate-run decomposition (see _b_runs)

    def __del__(self) -> None:
        pool = getattr(self, "pool", None)
        if pool is not None:
            pool._release(self.blk, self.start, self.n)

    def __len__(self) -> int:
        return self.n

    def modify_sites(self) -> tuple:
        """((input position, index within span), ...) of the Modify marks —
        cached on the immutable span, so collision scans in the identity
        fast path cost one tuple walk instead of a rebuilt dict."""
        sites = self._mods
        if sites is None:
            out = []
            pos = 0
            b = self.pool.blocks[self.blk]
            ks, as_, s = b.kind, b.a, self.start
            for i in range(self.n):
                k = ks[s + i]
                if k == K_MODIFY:
                    out.append((pos, i))
                    pos += 1
                elif k != K_INSERT and k != K_MOVEIN:
                    pos += as_[s + i]  # skip/remove/moveout consume
            sites = self._mods = tuple(out)
        return sites

    # ------------------------------------------------------------- accessors
    def columns(self) -> tuple:
        """(kind, a, b, c, obj, start) raw column views for one pass."""
        b = self.pool.blocks[self.blk]
        return b.kind, b.a, b.b, b.c, b.obj, self.start

    def columns_padded(self, max_marks: int):
        """Device-code padded columns ``(kind[M], count[M], det[M])`` as
        int32 ndarrays — the kernel-encoding export.

        Kinds are DEVICE codes (pool code + DEVICE_CODE_OFFSET; 0 pads),
        counts are the ``a`` column, ``det`` flags Remove marks whose
        detached payload is held host-side.  The int columns are read
        through one ``np.frombuffer`` view over the pool block (no Mark
        objects, no per-mark int boxing); only the object column needs a
        short walk for the det flags.  Raises ValueError when the span is
        wider than ``max_marks`` (callers treat that as kernel
        ineligibility, not an error path)."""
        import numpy as np

        n = self.n
        if n > max_marks:
            raise ValueError(f"span width {n} exceeds kernel width {max_marks}")
        blk = self.pool.blocks[self.blk]
        s = self.start
        kind = np.zeros((max_marks,), np.int32)
        cnt = np.zeros((max_marks,), np.int32)
        det = np.zeros((max_marks,), np.int32)
        if n:
            kv = np.frombuffer(blk.kind, dtype=np.intc)[s : s + n]
            kind[:n] = kv
            kind[:n] += 1  # DEVICE_CODE_OFFSET: 0 becomes the NOOP pad
            cnt[:n] = np.frombuffer(blk.a, dtype=np.intc)[s : s + n]
            objs = blk.obj
            for i in range(n):
                if kv[i] == K_REMOVE and objs[s + i] is not None:
                    det[i] = 1
        return kind, cnt, det

    def iter_runs(self):
        """Yield (kind, a, b, c, obj) per mark without materializing Mark
        objects (the engine's flatten walk and codecs ride this)."""
        ks, as_, bs, cs, objs, s = self.columns()
        for i in range(s, s + self.n):
            yield ks[i], as_[i], bs[i], cs[i], objs[i]

    # ----------------------------------------------------------------- codec
    def to_json(self) -> list:
        out = []
        for k, a, b, c, obj in self.iter_runs():
            if k == K_SKIP:
                out.append(["s", a])
            elif k == K_INSERT:
                out.append(["i", [n.to_json() for n in obj]])
            elif k == K_REMOVE:
                out.append(
                    ["r", a] if obj is None
                    else ["r", a, [n.to_json() for n in obj]]
                )
            elif k == K_MOVEOUT:
                out.append(["mo", a, b, c])
            elif k == K_MOVEIN:
                out.append(["mi", b, a, None if c == _NONE_OFF else c])
            else:
                out.append(["m", change_to_json(obj)])
        return out

    def to_marks(self) -> list:
        """Materialize object Marks (oracle boundary; shares content/nested
        refs exactly like object-mode rebase outputs do)."""
        out: list = []
        for k, a, b, c, obj in self.iter_runs():
            if k == K_SKIP:
                out.append(Skip(a))
            elif k == K_INSERT:
                out.append(Insert(list(obj)))
            elif k == K_REMOVE:
                out.append(Remove(a, list(obj) if obj is not None else None))
            elif k == K_MOVEOUT:
                out.append(MoveOut(a, b, c))
            elif k == K_MOVEIN:
                out.append(MoveIn(b, a, None if c == _NONE_OFF else c))
            else:
                out.append(Modify(unpool_change(obj)))
        return out

    def to_marks_cloned(self) -> list:
        """Materialize with the clone discipline of ``clone_commit`` in ONE
        pass (fresh marks, cloned content/repair nodes) — the trunk-return
        boundary, where the caller apply-enriches the result in place."""
        out: list = []
        for k, a, b, c, obj in self.iter_runs():
            if k == K_SKIP:
                out.append(Skip(a))
            elif k == K_INSERT:
                out.append(Insert([n.clone() for n in obj]))
            elif k == K_REMOVE:
                out.append(Remove(
                    a,
                    [n.clone() for n in obj] if obj is not None else None,
                ))
            elif k == K_MOVEOUT:
                out.append(MoveOut(a, b, c))
            elif k == K_MOVEIN:
                out.append(MoveIn(b, a, None if c == _NONE_OFF else c))
            else:
                out.append(Modify(unpool_change(obj)))
        return out


class _Builder:
    """Coalescing emitter mirroring changeset._emit, writing columns."""

    __slots__ = ("ks", "as_", "bs", "cs", "objs", "flags")

    def __init__(self) -> None:
        self.ks: list[int] = []
        self.as_: list[int] = []
        self.bs: list[int] = []
        self.cs: list[int] = []
        self.objs: list = []
        self.flags = F_CANONICAL

    def emit(self, k: int, a: int, b: int = 0, c: int = 0, obj=None) -> None:
        if a == 0 and k != K_MODIFY:
            return  # zero-count marks drop (MODIFY carries a == 1)
        ks = self.ks
        if ks:
            j = len(ks) - 1
            lk = ks[j]
            if lk == k:
                if k == K_SKIP:
                    self.as_[j] += a
                    return
                if k == K_REMOVE and (
                    (self.objs[j] is None) == (obj is None)
                ):
                    self.as_[j] += a
                    if obj is not None:
                        self.objs[j] = self.objs[j] + obj
                    return
                if k == K_INSERT:
                    self.as_[j] += a
                    self.objs[j] = self.objs[j] + obj
                    return
                if (
                    k == K_MOVEOUT
                    and self.bs[j] == b
                    and self.cs[j] + self.as_[j] == c
                ):
                    self.as_[j] += a
                    return
        if k == K_INSERT:
            self.flags |= F_INSERT
        elif k == K_REMOVE:
            self.flags |= F_REMOVE
        elif k == K_MODIFY:
            self.flags |= F_MODIFY
        elif k != K_SKIP:
            self.flags |= F_MOVE
        ks.append(k)
        self.as_.append(a)
        self.bs.append(b)
        self.cs.append(c)
        self.objs.append(obj)

    def seal(self, pool: MarkPool) -> PooledMarks:
        # The emit path never leaves a trailing Skip (placements only) —
        # from_marks/from_json sealing passes through here too and trims.
        if self.ks and self.ks[-1] == K_SKIP:
            self.flags &= ~F_CANONICAL  # raw list had a trailing skip
        return pool.seal(
            self.ks, self.as_, self.bs, self.cs, self.objs, self.flags
        )


# ---------------------------------------------------------------------------
# Pool / unpool codecs
# ---------------------------------------------------------------------------


def _pool_raw(pool: MarkPool, rows: list) -> PooledMarks:
    """Seal raw (k, a, b, c, obj) rows, computing flags + canonicality
    (no coalescing — the rows mirror an existing wire/object list)."""
    ks: list[int] = []
    as_: list[int] = []
    bs: list[int] = []
    cs: list[int] = []
    objs: list = []
    flags = F_CANONICAL
    for k, a, b, c, obj in rows:
        if k == K_INSERT:
            flags |= F_INSERT
        elif k == K_REMOVE:
            flags |= F_REMOVE
        elif k == K_MODIFY:
            flags |= F_MODIFY
        elif k != K_SKIP:
            flags |= F_MOVE
        if a == 0 and k != K_MODIFY:
            flags &= ~F_CANONICAL  # object _emit would have dropped it
        if ks:
            j = len(ks) - 1
            lk = ks[j]
            if (
                (lk == k == K_SKIP)
                or (lk == k == K_INSERT)
                or (lk == k == K_REMOVE and (objs[j] is None) == (obj is None))
                or (lk == k == K_MOVEOUT and bs[j] == b
                    and cs[j] + as_[j] == c)
            ):
                flags &= ~F_CANONICAL  # object _emit would have coalesced
        ks.append(k)
        as_.append(a)
        bs.append(b)
        cs.append(c)
        objs.append(obj)
    if ks and ks[-1] == K_SKIP:
        flags &= ~F_CANONICAL
    return pool.seal(ks, as_, bs, cs, objs, flags)


def pool_marks(pool: MarkPool, marks: list) -> PooledMarks:
    """Object mark list -> pooled span (shares content/nested refs; nested
    NodeChanges convert recursively so every sequence field in the pooled
    universe dispatches to the pooled kind)."""
    rows = []
    for m in marks:
        if isinstance(m, Skip):
            rows.append((K_SKIP, m.count, 0, 0, None))
        elif isinstance(m, Insert):
            rows.append((K_INSERT, len(m.content), 0, 0, list(m.content)))
        elif isinstance(m, Remove):
            rows.append((
                K_REMOVE, m.count, 0, 0,
                list(m.detached) if m.detached is not None else None,
            ))
        elif isinstance(m, MoveOut):
            rows.append((K_MOVEOUT, m.count, m.id, m.offset, None))
        elif isinstance(m, MoveIn):
            rows.append((
                K_MOVEIN, m.count, m.id,
                _NONE_OFF if m.offset is None else m.offset, None,
            ))
        else:
            rows.append((K_MODIFY, 1, 0, 0, pool_change(pool, m.change)))
    return _pool_raw(pool, rows)


def pool_marks_from_json(pool: MarkPool, data: list) -> PooledMarks:
    """Wire marks JSON -> pooled span directly: the wire decode that never
    constructs a Mark object (pairs with the native tree decoder, which
    hands the numeric plane over as columns already)."""
    rows = []
    for e in data:
        kind = e[0]
        if kind == "s":
            rows.append((K_SKIP, e[1], 0, 0, None))
        elif kind == "i":
            rows.append((
                K_INSERT, len(e[1]), 0, 0,
                [Node.from_json(n) for n in e[1]],
            ))
        elif kind == "r":
            rows.append((
                K_REMOVE, e[1], 0, 0,
                [Node.from_json(n) for n in e[2]] if len(e) > 2 else None,
            ))
        elif kind == "mo":
            rows.append((K_MOVEOUT, e[1], e[2], e[3] if len(e) > 3 else 0,
                         None))
        elif kind == "mi":
            off = e[3] if len(e) > 3 else None
            rows.append((
                K_MOVEIN, e[2], e[1],
                _NONE_OFF if off is None else off, None,
            ))
        else:
            rows.append((K_MODIFY, 1, 0, 0,
                         pool_change_from_json(pool, e[1])))
    return _pool_raw(pool, rows)


def pool_field_change(pool: MarkPool, fc):
    if isinstance(fc, PooledMarks):
        return fc
    if isinstance(fc, list):
        return pool_marks(pool, fc)
    if isinstance(fc, OptionalChange) and fc.nested is not None:
        return OptionalChange(
            kind=fc.kind, set=fc.set, nested=pool_change(pool, fc.nested)
        )
    return fc


def pool_change(pool: MarkPool, change: NodeChange) -> NodeChange:
    return NodeChange(
        value=change.value,
        fields={
            k: pool_field_change(pool, fc) for k, fc in change.fields.items()
        },
    )


def pool_change_from_json(pool: MarkPool, data: dict) -> NodeChange:
    return NodeChange(
        value=tuple(data["v"]) if "v" in data else None,
        fields={
            k: (
                pool_marks_from_json(pool, m)
                if isinstance(m, list)
                else pool_field_change(pool, field_change_from_json(m))
            )
            for k, m in data.get("f", {}).items()
        },
    )


def pool_commit(pool: MarkPool, commit) -> Commit:
    if getattr(commit, "_pooled", False):
        return commit
    constraints, violated = _commit_meta(commit)
    out = Commit(
        [pool_change(pool, c) for c in commit], constraints, violated
    )
    out._pooled = True
    return out


def pool_commit_from_json(pool: MarkPool, data) -> Commit:
    """Wire commit JSON -> pooled Commit (the mark_alloc phase of the
    pooled ingest: zero Mark objects constructed)."""
    if isinstance(data, dict):
        out = Commit(
            [pool_change_from_json(pool, c) for c in data["changes"]],
            data.get("constraints"),
            data.get("violated", False),
        )
    else:
        out = Commit([pool_change_from_json(pool, c) for c in data])
    out._pooled = True
    return out


def _unpool_field(fc):
    from .changeset import _clone_field_change

    if isinstance(fc, PooledMarks):
        return fc.to_marks_cloned()
    return _clone_field_change(fc)


def unpool_change(change: NodeChange) -> NodeChange:
    return NodeChange(
        value=tuple(change.value) if change.value is not None else None,
        fields={k: _unpool_field(fc) for k, fc in change.fields.items()},
    )


def unpool_commit(commit) -> Commit:
    constraints, violated = _commit_meta(commit)
    return Commit(
        [unpool_change(c) for c in commit],
        [dict(c, path=[list(p) for p in c["path"]]) for c in constraints],
        violated,
    )


def pool_commit_from_native(
    pool: MarkPool, data: bytes, msg_row, chgs, flds, marks, spans
) -> Commit:
    """Assemble one wire message's pooled Commit from the native tree
    decoder's column tables (native/ingest.cpp ``ing_tree_decode``): the
    numeric mark plane lands as columns verbatim, and only the object
    payload spans (insert content, removed subtrees, nested changes,
    non-sequence field kinds) pay a ``json.loads``."""
    import json

    chg_start, chg_count = msg_row[8], msg_row[9]
    changes = []
    for ci in range(chg_start, chg_start + chg_count):
        fld_start, fld_count, v_span = chgs[ci]
        fields = {}
        for fi in range(fld_start, fld_start + fld_count):
            key_span, mark_start, mark_count, opaque_span = flds[fi]
            off, ln = spans[key_span]
            key = data[off : off + ln].decode()
            if opaque_span >= 0:
                off, ln = spans[opaque_span]
                fields[key] = pool_field_change(pool, field_change_from_json(
                    json.loads(data[off : off + ln])
                ))
                continue
            rows = []
            for mi in range(mark_start, mark_start + mark_count):
                k, a, b, c, ps = marks[mi]
                if k == K_INSERT:
                    off, ln = spans[ps]
                    content = [
                        Node.from_json(n)
                        for n in json.loads(data[off : off + ln])
                    ]
                    rows.append((K_INSERT, len(content), 0, 0, content))
                elif k == K_REMOVE:
                    det = None
                    if ps >= 0:
                        off, ln = spans[ps]
                        det = [
                            Node.from_json(n)
                            for n in json.loads(data[off : off + ln])
                        ]
                    rows.append((K_REMOVE, a, 0, 0, det))
                elif k == K_MODIFY:
                    off, ln = spans[ps]
                    rows.append((K_MODIFY, 1, 0, 0, pool_change_from_json(
                        pool, json.loads(data[off : off + ln])
                    )))
                else:  # skip / moveout / movein: pure column rows
                    rows.append((k, a, b, c, None))
            fields[key] = _pool_raw(pool, rows)
        value = None
        if v_span >= 0:
            off, ln = spans[v_span]
            value = tuple(json.loads(data[off : off + ln]))
        changes.append(NodeChange(value=value, fields=fields))
    out = Commit(changes)
    out._pooled = True
    return out


# ---------------------------------------------------------------------------
# Columnar rebase
# ---------------------------------------------------------------------------


def _rebase_fallback(pool: MarkPool, a: PooledMarks, b: PooledMarks,
                     a_after: bool) -> PooledMarks:
    """Moves on both sides: materialize and run the object oracle, then
    re-pool — the fallback IS the oracle, so it cannot diverge."""
    return pool_marks(pool, rebase_marks(a.to_marks(), b.to_marks(), a_after))


def _rebase_over_nonstructural(
    pool: MarkPool, a: PooledMarks, b: PooledMarks, a_after: bool
) -> PooledMarks:
    """Fast path: b is only Skip/Modify, a is canonical — positions are
    unchanged, so a's span is reused verbatim unless one of a's own
    Modifies collides with a b Modify (then only those nested changes
    rebase; identical nested results still reuse the span)."""
    if not (b.flags & F_MODIFY) or not (a.flags & F_MODIFY):
        pool.reuse_hits += 1
        return a
    am = a.modify_sites()
    bm = b.modify_sites()
    new_objs = None
    a_objs = pool.blocks[a.blk].obj
    b_objs = b.pool.blocks[b.blk].obj
    bj = 0
    nb = len(bm)
    for pos, ai in am:
        while bj < nb and bm[bj][0] < pos:
            bj += 1
        if bj >= nb:
            break
        if bm[bj][0] == pos:
            cur = a_objs[a.start + ai]
            rebased = rebase_change_id(cur, b_objs[b.start + bm[bj][1]],
                                       a_after)
            if rebased is not cur:
                if new_objs is None:
                    new_objs = list(a_objs[a.start : a.start + a.n])
                new_objs[ai] = rebased
    if new_objs is None:
        pool.reuse_hits += 1
        return a
    ks, as_, bs_, cs_, _objs, s = a.columns()
    out = pool.seal(
        list(ks[s : s + a.n]), list(as_[s : s + a.n]),
        list(bs_[s : s + a.n]), list(cs_[s : s + a.n]), new_objs, a.flags,
    )
    out._mods = a._mods  # same shape, same sites
    return out


def _b_runs(b: PooledMarks):
    """Decompose b into fate runs + boundary productions (the columnar
    _Fates): runs of (in_start, in_end, out_start, gone?, nested) plus
    {boundary: produced} for Insert content.  Cached on the immutable
    span — stream entries reused across fold steps decompose once."""
    cached = b._runs
    if cached is not None:
        return cached
    runs: list[tuple[int, int, int, bool, Any]] = []
    prods: dict[int, int] = {}
    in_pos = out_pos = 0
    for k, a, _bb, _cc, obj in b.iter_runs():
        if k == K_SKIP:
            runs.append((in_pos, in_pos + a, out_pos, False, None))
            in_pos += a
            out_pos += a
        elif k == K_MODIFY:
            runs.append((in_pos, in_pos + 1, out_pos, False, obj))
            in_pos += 1
            out_pos += 1
        elif k == K_REMOVE:
            runs.append((in_pos, in_pos + a, out_pos, True, None))
            in_pos += a
        else:  # K_INSERT (moves excluded by the caller)
            prods[in_pos] = prods.get(in_pos, 0) + a
            out_pos += a
    b._runs = (runs, prods, in_pos, out_pos)
    return b._runs


def _rebase_cols(pool: MarkPool, a: PooledMarks, b: PooledMarks,
                 a_after: bool) -> PooledMarks:
    """General columnar rebase (no moves on either side): fate runs for b,
    one monotone walk over a's columns emitting placements, then the
    sorted gap-and-coalesce emission — changeset.rebase_marks re-expressed
    over runs instead of per-node mark objects."""
    runs, prods, tail_in, tail_out = _b_runs(b)
    nruns = len(runs)

    # Placements: (out_pos, kind_order, seq, (k, a, b, c, obj)).
    placements: list[tuple[int, int, int, tuple]] = []
    in_pos = 0
    seq = 0
    ri = 0  # monotone run pointer (all queries non-decreasing in in_pos)

    def boundary(p: int, after: bool) -> int:
        nonlocal ri
        while ri < nruns and runs[ri][1] < p:
            ri += 1
        if p == 0:
            # Output before boundary 0 excluding productions AT 0 is
            # definitionally 0 — a run starting at 0 has its out_start
            # AFTER any leading-Insert production, so the generic
            # run-relative formula below would double-count it.
            before = 0
        elif ri < nruns and runs[ri][0] <= p:
            s0, _e0, o0, gone, _n = runs[ri]
            before = o0 if gone else o0 + (p - s0)
        else:
            return tail_out + (p - tail_in)  # beyond b: no productions
        return before + prods.get(p, 0) if after else before

    def node(i: int):
        nonlocal ri
        while ri < nruns and runs[ri][1] <= i:
            ri += 1
        if ri < nruns and runs[ri][0] <= i:
            s0, _e0, o0, gone, nested = runs[ri]
            if gone:
                return None, None
            return o0 + (i - s0), nested
        return tail_out + (i - tail_in), None

    ks, as_, bs_, cs_, objs, s = a.columns()
    for idx in range(s, s + a.n):
        k = ks[idx]
        cnt = as_[idx]
        seq += 1
        if k == K_SKIP:
            in_pos += cnt
        elif k == K_INSERT:
            bp = boundary(in_pos, a_after)
            placements.append((bp, 0, seq, (K_INSERT, cnt, 0, 0, objs[idx])))
        elif k == K_MODIFY:
            pos, nested = node(in_pos)
            if pos is not None:
                ch = objs[idx]
                if nested is not None:
                    ch = rebase_change_id(ch, nested, a_after)
                placements.append((pos, 1, seq, (K_MODIFY, 1, 0, 0, ch)))
            in_pos += 1
        elif k == K_REMOVE:
            det = objs[idx]
            off = 0
            while off < cnt:
                pos, _nested = node(in_pos)
                if pos is None:
                    # Inside a gone run: skip to its end in one hop.
                    end = min(runs[ri][1], in_pos + (cnt - off))
                    off += end - in_pos
                    in_pos = end
                    continue
                # Keep segment: contiguous until the run ends.
                end = runs[ri][1] if ri < nruns else in_pos + (cnt - off)
                seg = min(end, in_pos + (cnt - off)) - in_pos
                placements.append((
                    pos, 1, seq,
                    (K_REMOVE, seg, 0, 0,
                     det[off : off + seg] if det is not None else None),
                ))
                off += seg
                in_pos += seg
    # Sort only when a placement landed out of order (move-free lists walk
    # in placement order already; nested b-removals can reorder segments).
    for i in range(1, len(placements)):
        if placements[i][:3] < placements[i - 1][:3]:
            placements.sort(key=lambda t: (t[0], t[1], t[2]))
            break

    out = _Builder()
    cursor = 0
    for pos, _ko, _sq, (k, cnt, bb, cc, obj) in placements:
        if pos > cursor:
            out.emit(K_SKIP, pos - cursor)
            cursor = pos
        out.emit(k, cnt, bb, cc, obj)
        if k == K_REMOVE or k == K_MODIFY:
            cursor += cnt if k == K_REMOVE else 1
    return out.seal(pool)


def _single_insert(x: PooledMarks):
    """[Insert] / [Skip, Insert] pattern -> (skip, content) else None."""
    blk = x.pool.blocks[x.blk]
    s = x.start
    if x.n == 1:
        if blk.kind[s] == K_INSERT:
            return 0, blk.obj[s]
    elif x.n == 2 and blk.kind[s] == K_SKIP and blk.kind[s + 1] == K_INSERT:
        return blk.a[s], blk.obj[s + 1]
    return None


def rebase_pooled_marks(pool: MarkPool, a: PooledMarks, b: PooledMarks,
                        a_after: bool) -> PooledMarks:
    if a.n == 0:
        pool.reuse_hits += 1
        return a  # empty rebases to empty (and empty spans are canonical)
    if not (b.flags & _F_STRUCTURAL) and (a.flags & F_CANONICAL):
        return _rebase_over_nonstructural(pool, a, b, a_after)
    if a.n <= 2 and b.n <= 2 and (a.flags & F_CANONICAL):
        # Closed form for the conflicting-insert hot pair: the sided
        # boundary map of two single-insert lists is one comparison.
        pa = _single_insert(a)
        if pa is not None:
            pb = _single_insert(b)
            if pb is not None and pa[1] and pb[1]:
                j, content = pa
                k, b_content = pb
                if j > k or (j == k and a_after):
                    bp = j + len(b_content)
                else:
                    pool.reuse_hits += 1
                    return a  # b landed after a's boundary: untouched
                return pool.seal(
                    [K_SKIP, K_INSERT], [bp, len(content)], [0, 0], [0, 0],
                    [None, content], F_INSERT | F_CANONICAL,
                )
    if (a.flags | b.flags) & F_MOVE:
        return _rebase_fallback(pool, a, b, a_after)
    return _rebase_cols(pool, a, b, a_after)


# ---------------------------------------------------------------------------
# Registry kind
# ---------------------------------------------------------------------------


class PooledSequenceFieldKind(FieldKind):
    """Sequence-field algebra over pooled spans.  Serializes to the BARE
    wire list (byte-compatible with SequenceFieldKind); compose/invert/
    apply materialize through the object oracle (they are offline paths —
    the trunk pipeline only rebases)."""

    name = "sequence_pooled"
    is_sequence = True

    def __init__(self, pool: MarkPool | None = None) -> None:
        # Operations recover the pool from their operands; the ctor pool
        # is only the from_json target.
        self.pool = pool or MarkPool()

    def as_mark_list(self, change: PooledMarks) -> list:
        return change.to_marks()

    def clone(self, change: PooledMarks) -> PooledMarks:
        return change  # immutable span: sharing is the point

    def rebase(self, a: PooledMarks, b: PooledMarks, a_after: bool):
        return rebase_pooled_marks(a.pool, a, b, a_after)

    def invert(self, change: PooledMarks):
        from .changeset import invert_marks

        return pool_marks(change.pool, invert_marks(change.to_marks()))

    def compose(self, a: PooledMarks, b: PooledMarks):
        from .field_kinds import compose_marks

        return pool_marks(a.pool, compose_marks(a.to_marks(), b.to_marks()))

    def apply(self, nodes: list, change: PooledMarks) -> None:
        # Pooled spans are immutable; enrichment must never target them.
        raise AssertionError(
            "apply on a pooled mark list (materialize with unpool first)"
        )

    def to_json(self, change: PooledMarks):
        return change.to_json()

    def from_json(self, data):
        return pool_marks_from_json(self.pool, data)

    def is_empty(self, change: PooledMarks) -> bool:
        return change.n == 0


POOLED_SEQUENCE = PooledSequenceFieldKind()
FIELD_KINDS[POOLED_SEQUENCE.name] = POOLED_SEQUENCE


# ---------------------------------------------------------------------------
# Identity-aware changeset fold (the EditManager hot path)
# ---------------------------------------------------------------------------


def rebase_change_id(a: NodeChange, b: NodeChange, a_after: bool) -> NodeChange:
    """changeset.rebase_node_change with identity detection: when no field
    actually changed (disjoint keys, pooled fast-path span reuse) the
    ORIGINAL NodeChange is returned, so whole fold stages share structure
    instead of re-materializing equal changesets.  Safe because pooled
    changes are immutable (enrichment happens on the materialized trunk
    clone only); byte-equal to the object path by construction."""
    value = a.value
    if a.value is not None and b.value is not None and not a_after:
        value = None
    changed = value is not a.value
    b_fields = b.fields
    a_fields = a.fields
    if len(a_fields) == 1 and not changed:
        # Single-field commits are the wire norm: resolve the one pair
        # without building a fields dict on the identity path.
        (key, a_fc), = a_fields.items()
        b_fc = b_fields.get(key)
        if b_fc is None:
            return a
        if type(a_fc) is PooledMarks and type(b_fc) is PooledMarks:
            out_fc = rebase_pooled_marks(a_fc.pool, a_fc, b_fc, a_after)
            if out_fc is a_fc:
                return a
            return NodeChange(value=value, fields={key: out_fc})
    fields = {}
    for key, a_fc in a.fields.items():
        b_fc = b_fields.get(key)
        if b_fc is None:
            fields[key] = a_fc  # pooled/optional clone == share
            continue
        if type(a_fc) is PooledMarks and type(b_fc) is PooledMarks:
            # The dominant pair: skip the registry double-dispatch.
            out_fc = rebase_pooled_marks(a_fc.pool, a_fc, b_fc, a_after)
        else:
            kind = kind_of(a_fc)
            b_kind = kind_of(b_fc)
            if kind is not b_kind:
                if getattr(kind, "is_sequence", False) and getattr(
                    b_kind, "is_sequence", False
                ):
                    # Mixed sequence-family storage: rebase through the
                    # shared mark-list view (same as the object algebra).
                    out_fc = rebase_marks(
                        kind.as_mark_list(a_fc),
                        b_kind.as_mark_list(b_fc), a_after,
                    )
                    changed = True
                    fields[key] = out_fc
                    continue
                if a_after:
                    changed = True  # deterministic degrade drops a's change
                    continue
                fields[key] = a_fc
                continue
            out_fc = kind.rebase(a_fc, b_fc, a_after)
        if out_fc is not a_fc:
            changed = True
        fields[key] = out_fc
    if not changed:
        return a
    return NodeChange(value=value, fields=fields)


def _rebase_commit_over_change_id(a: Commit, x: NodeChange,
                                  a_after: bool) -> Commit:
    """Mirror of changeset.rebase_commit_over_change with identity reuse."""
    from .changeset import _rebase_constraints

    constraints, violated = _commit_meta(a)
    if constraints and not violated and a_after:
        constraints, violated = _rebase_constraints(constraints, x)
        if violated:
            out = Commit([], constraints, violated=True)
            out._pooled = True
            return out
    if violated:
        out = Commit([], constraints, violated)
        out._pooled = True
        return out
    changes = []
    changed = False
    for c in a:
        rc = rebase_change_id(c, x, a_after)
        if rc is not c:
            changed = True
        changes.append(rc)
        x = rebase_change_id(x, c, not a_after)
    if not changed and constraints == getattr(a, "constraints", []):
        return a
    out = Commit(changes, constraints, violated)
    out._pooled = True
    return out


def rebase_commit_id(a: Commit, b: Commit, a_after: bool) -> Commit:
    for x in b:
        a = _rebase_commit_over_change_id(a, x, a_after)
    return a


def _swap_modify_objs(pool: MarkPool, a: PooledMarks, new_objs) -> PooledMarks:
    """Copy a span with substituted object column (nested-rebase swaps)."""
    ks, as_, bs_, cs_, _objs, s = a.columns()
    out = pool.seal(
        list(ks[s : s + a.n]), list(as_[s : s + a.n]),
        list(bs_[s : s + a.n]), list(cs_[s : s + a.n]), new_objs, a.flags,
    )
    out._mods = a._mods
    return out


def _rebase_marks_pair(a: PooledMarks, b: PooledMarks):
    """Both bridge legs of one span pair in a single descent:
    ``(rebase(a, b, a_after=True), rebase(b, a, a_after=False))``.
    Fused for the two symmetric hot shapes — non-structural vs
    non-structural (one collision scan serves both sides) and
    single-insert vs single-insert (one boundary comparison serves both
    closed forms); everything else runs the two single-leg rebases."""
    af, bf = a.flags, b.flags
    if not ((af | bf) & _F_STRUCTURAL) and (af & bf & F_CANONICAL):
        if not (af & F_MODIFY) or not (bf & F_MODIFY):
            a.pool.reuse_hits += 2
            return a, b
        am = a.modify_sites()
        bm = b.modify_sites()
        new_a = new_b = None
        a_objs = a.pool.blocks[a.blk].obj
        b_objs = b.pool.blocks[b.blk].obj
        bj = 0
        nb = len(bm)
        for pos, ai in am:
            while bj < nb and bm[bj][0] < pos:
                bj += 1
            if bj >= nb:
                break
            if bm[bj][0] == pos:
                bi = bm[bj][1]
                ca = a_objs[a.start + ai]
                cb = b_objs[b.start + bi]
                na, nbch = rebase_change_pair(ca, cb)
                if na is not ca:
                    if new_a is None:
                        new_a = list(a_objs[a.start : a.start + a.n])
                    new_a[ai] = na
                if nbch is not cb:
                    if new_b is None:
                        new_b = list(b_objs[b.start : b.start + b.n])
                    new_b[bi] = nbch
        if new_a is None:
            a.pool.reuse_hits += 1
            out_a = a
        else:
            out_a = _swap_modify_objs(a.pool, a, new_a)
        if new_b is None:
            b.pool.reuse_hits += 1
            out_b = b
        else:
            out_b = _swap_modify_objs(b.pool, b, new_b)
        return out_a, out_b
    if a.n <= 2 and b.n <= 2 and (af & bf & F_CANONICAL):
        pa = _single_insert(a)
        if pa is not None:
            pb = _single_insert(b)
            if pb is not None and pa[1] and pb[1]:
                j, ca = pa
                k, cb = pb
                # leg1 (a later): shifts when j >= k; leg2 (b earlier):
                # shifts only when k > j — one comparison, both answers.
                if j >= k:
                    out_a = a.pool.seal(
                        [K_SKIP, K_INSERT], [j + len(cb), len(ca)],
                        [0, 0], [0, 0], [None, ca],
                        F_INSERT | F_CANONICAL,
                    )
                    b.pool.reuse_hits += 1
                    return out_a, b
                a.pool.reuse_hits += 1
                out_b = b.pool.seal(
                    [K_SKIP, K_INSERT], [k + len(ca), len(cb)],
                    [0, 0], [0, 0], [None, cb],
                    F_INSERT | F_CANONICAL,
                )
                return a, out_b
    return (
        rebase_pooled_marks(a.pool, a, b, True),
        rebase_pooled_marks(b.pool, b, a, False),
    )


def rebase_change_pair(a: NodeChange, b: NodeChange):
    """Both bridge legs of one NodeChange pair in a single descent —
    byte-equal to ``(rebase_change_id(a, b, True),
    rebase_change_id(b, a, False))``."""
    value_a = a.value  # the later-sequenced side always keeps its value
    value_b = b.value
    if a.value is not None and b.value is not None:
        value_b = None  # earlier side carried over a later set: LWW drop
    a_fields = a.fields
    b_fields = b.fields
    if len(a_fields) == 1 and len(b_fields) == 1:
        (ka, a_fc), = a_fields.items()
        (kb, b_fc), = b_fields.items()
        if ka != kb:
            out_a = a
            out_b = b if value_b is b.value else NodeChange(
                value=value_b, fields={kb: b_fc}
            )
            return out_a, out_b
        if type(a_fc) is PooledMarks and type(b_fc) is PooledMarks:
            na_fc, nb_fc = _rebase_marks_pair(a_fc, b_fc)
            out_a = a if na_fc is a_fc else NodeChange(
                value=value_a, fields={ka: na_fc}
            )
            if nb_fc is b_fc and value_b is b.value:
                out_b = b
            else:
                out_b = NodeChange(value=value_b, fields={kb: nb_fc})
            return out_a, out_b
    return (
        rebase_change_id(a, b, True),
        rebase_change_id(b, a, False),
    )


def rebase_pair(c: Commit, x: Commit) -> tuple[Commit, Commit]:
    """One bridge step of the EditManager fold: returns
    (c rebased over x with a_after=True, x rebased over c with
    a_after=False) — the mirrored pair.  For the dominant single-element
    commits the two legs come out of ONE pass (they are each other's
    carried intermediates); longer commits fall back to the two mirrored
    folds, byte-identical to the object path either way."""
    # Both sides are pooled Commits by contract (the fold pools at entry),
    # so constraint metadata is direct attribute access.
    if len(c) == 1 and len(x) == 1 and not c.constraints \
            and not x.constraints and not c.violated and not x.violated:
        c0, x0 = c[0], x[0]
        nc, nx = rebase_change_pair(c0, x0)
        if nc is c0:
            out_c = c
        else:
            out_c = Commit([nc])
            out_c._pooled = True
        if nx is x0:
            out_x = x
        else:
            out_x = Commit([nx])
            out_x._pooled = True
        return out_c, out_x
    return rebase_commit_id(c, x, True), rebase_commit_id(x, c, False)
