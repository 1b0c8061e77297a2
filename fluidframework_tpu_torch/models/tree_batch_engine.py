"""TreeBatchEngine: batched sequenced tree-edit application across documents.

Counterpart of ``fluidframework_tpu/models/tree_batch_engine.py``: D
SharedTree documents, each with its own totally ordered edit stream, stepped
in lockstep device megasteps.

- host: per-doc ``EditManager`` (``dds/tree/editmanager.py``, over one
  shared ``MarkPool``) runs the deterministic trunk translation; the trunk
  commit flattens (``_flatten`` and the ``_walk_*`` translation, with the
  commit-shape plan cache) into path-addressed op rows staged in a per-doc
  ``RowQueue``.
- device: the forest as nested columnar rows (``ops/tree_kernel.py``
  ``NestedForestState``), doc-indexed: ``step`` packs up to K [D, B]
  slices into the pinned staging ring and applies them with
  ``apply_nested_megastep`` (K7); a host-side upper bound on each doc's row
  and pool watermarks triggers ``compact_nested`` (K8) before a megastep
  could overflow.
- fallback: commits the columns cannot express (paths deeper than
  ``MAX_PATH``, split or cross-field moves, moves mixed with other marks,
  out-of-range ints, leaf values wider than a payload row) and docs whose
  rows latch an error on the device (one error-vector read per ``step``)
  route to a host ``Forest`` rebuilt from the trunk log.
- checkpoints: the host trunk fold is the snapshot, so a record needs no
  device read; ``restore_from_checkpoints`` re-materializes the columns as
  one whole-content insert through the normal step.

Raw columns, views, fallbacks and checkpoint files are identical to the
reference engine's for the same message stream.  ``device_rebase=True``
folds each EditManager window through K9 (``dds/tree/device_rebase.py``)
on the engine's device, with one ``DeviceRebaser`` shared by the fleet;
docs rebuilt by a restore fold on the host, as the reference's do.

``ingest_lines`` takes newline-separated wire JSON: with ``native_wire``
(default) and the mark pool, the envelope and the numeric mark plane decode
in C++ (``native/ingest_native.tree_decode``) straight into pool columns;
otherwise, or when the library is not built, each line takes the Python
parse.  ``telemetry=`` attaches a ``utils.telemetry.Logger`` to the health
counters.  The host fold is spanned for the flight recorder
(``host_fold_mark_alloc`` / ``_rebase`` / ``_compose`` / ``_translate``),
as are ``dispatch``, ``readback``, ``checkpoint_sweep`` and
``restore_scan``.  No recompile watchdog: the port compiles nothing at run
time.

Serving: ``adopt_boot_snapshot`` re-seeds one doc from a historian
snapshot record; ``warmup`` makes the serving programs' first launches
ahead of a standby's promotion.

Placement (``mesh``, ``spare_slots``): a ``placement.PlacementPlane`` maps
each doc to a slot (its state row) of a ``fleet_capacity``-row state, a
shard is a contiguous block of ``docs_per_shard`` rows, and the programs
are one launch over every row.  ``migrate_doc`` folds the trunk suffix,
retires the source slot and re-materializes the forest at a free slot of
the destination shard; ``rebalance_hot_shards`` migrates off shards loaded
past ``factor`` x the mean.

Not ported (``NotImplementedError``): ``plan_cache=False`` (the reference's
per-row emit path).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..dds.tree.changeset import (
    Insert,
    Modify,
    MoveIn,
    MoveOut,
    NodeChange,
    Remove,
    Skip,
    apply_commit,
    commit_from_json,
)
from ..dds.tree.device_rebase import DeviceRebaser
from ..dds.tree.editmanager import EditManager
from ..dds.tree.field_kinds import OptionalChange
from ..dds.tree.forest import ROOT_FIELD, Forest, Node
from ..dds.tree.mark_pool import MarkPool
from ..dds.tree.mark_pool import pool_commit_from_json as _pool_commit_from_json
from ..dds.tree.mark_pool import pool_commit_from_native
from ..device import DEFAULT_DEVICE, resolve_device
from ..native import ingest_native
from ..observability.flight_recorder import instant, span
from ..ops import tree_kernel as tk
from ..protocol.messages import MessageType, SequencedMessage
from ..utils.telemetry import HealthCounters
from . import placement
from .recovery import (
    RecoveryTracker,
    load_checkpoint_records,
    stale_due_docs,
    write_checkpoint_records,
)
from .staging import OverloadGate, RowQueue, StagingRing, warmup_depths


@dataclass
class _TreeHost:
    em: EditManager = field(default_factory=EditManager)
    # Columnar pending op rows (see staging.RowQueue).
    queue: RowQueue = None
    # Trunk-coordinate commit suffix since ``checkpoint`` (replay source for
    # fallback routing); folded into the checkpoint forest every
    # CHECKPOINT_EVERY commits so host memory stays bounded.
    trunk_log: list[list] = field(default_factory=list)
    checkpoint: Forest = field(default_factory=Forest)
    device_commits: int = 0
    total_commits: int = 0
    # Durable-checkpoint floor (ops at or below base_seq are covered by the
    # stored record; a restarted consumer's replay of them is skipped).
    base_seq: int = 0
    last_seq: int = 0
    ops_since_ckpt: int = 0
    # Monotonic time the doc first went dirty after its last durable
    # checkpoint (0.0 = clean).
    dirty_since: float = 0.0
    # Set by restore_from_checkpoints: tail ops count as boot_replay_len
    # until the first post-boot checkpoint.
    restored: bool = False
    boot_counting: bool = False


class UnsupportedShape(Exception):
    """A commit the columnar path cannot express."""


class _FlattenCollector:
    """One walk per trunk commit collects the structural KEY (field path /
    kind / payload arity — everything that determines row layout) and the
    DYNAMIC scalars (path indices, positions, counts, destinations,
    values, payload words).  A commit whose key was seen before skips all
    per-row numpy work: its cached _TranslationPlan turns the dynamics
    into row blocks with two vectorized fills."""

    __slots__ = ("key", "dyn", "pay")

    _PTAG = {"v": 1, "w": 2, "r": 3}

    def __init__(self) -> None:
        self.key: list[tuple] = []
        self.dyn: list[int] = []
        # Per-row payload spec: None | ('v', val) | ('w', words) | ('r', vals)
        self.pay: list[tuple | None] = []

    def reset(self) -> None:
        self.key.clear()
        self.dyn.clear()
        self.pay.clear()

    def emit(self, kind, steps, fld, pos=0, count=0, dst=0, value=0,
             vkind=0, ntype=0, payload=None):
        if len(steps) > tk.MAX_PATH:
            raise UnsupportedShape("path deeper than kernel MAX_PATH")
        ptag = 0 if payload is None else self._PTAG[payload[0]]
        plen = len(payload[1]) if ptag >= 2 else ptag
        self.key.append(
            (kind, fld, ptag, plen, vkind, ntype, len(steps))
            + tuple(f for f, _ in steps)
        )
        dyn = self.dyn
        for _f, i in steps:
            dyn.append(i)
        dyn.append(pos)
        dyn.append(count)
        dyn.append(dst)
        dyn.append(value)
        self.pay.append(payload)


class _TranslationPlan:
    """Cached row layout for one commit shape: a static template block
    plus the (row, col) scatter of every dynamic cell.  ``fill`` reuses
    the plan's own scratch blocks — callers copy them out immediately
    (RowQueue.extend_block does)."""

    __slots__ = (
        "template", "dyn_rows", "dyn_cols", "scratch_ops", "scratch_pay",
    )

    def __init__(self, key: tuple, payload_len: int) -> None:
        t = tk._TGT
        m = len(key)
        self.template = np.zeros((m, tk.NESTED_OP_FIELDS), np.int32)
        dyn_rows: list[int] = []
        dyn_cols: list[int] = []
        for r, (kind, fld, _ptag, _plen, vkind, ntype, depth, *fids) in enumerate(key):
            row = self.template[r]
            row[0] = kind
            row[2] = depth
            for k, f in enumerate(fids):
                row[3 + 2 * k] = f
            row[t] = fld
            row[t + 5] = vkind
            row[t + 6] = ntype
            # Dynamic cells, in collector emission order: path indices,
            # then pos / count / dst / value.
            for k in range(depth):
                dyn_rows.append(r)
                dyn_cols.append(4 + 2 * k)
            for col in (t + 1, t + 2, t + 3, t + 4):
                dyn_rows.append(r)
                dyn_cols.append(col)
        self.dyn_rows = np.asarray(dyn_rows, np.int64)
        self.dyn_cols = np.asarray(dyn_cols, np.int64)
        self.scratch_ops = np.empty_like(self.template)
        # Payload cells beyond each row's fixed arity stay zero forever
        # (arity is part of the key), so one zeroing at build time suffices.
        self.scratch_pay = np.zeros((m, payload_len), np.int32)

    def fill(self, dyn: list[int], pays: list, seq: int):
        ops = self.scratch_ops
        np.copyto(ops, self.template)
        ops[:, 1] = seq
        if self.dyn_rows.size:
            ops[self.dyn_rows, self.dyn_cols] = dyn
        pay = self.scratch_pay
        for r, spec in enumerate(pays):
            if spec is None:
                continue
            tag, data = spec
            if tag == "v":
                pay[r, 0] = data
            else:  # 'w' words / 'r' run values
                pay[r, : len(data)] = data
        return ops, pay


# Watermark-accounting kind sets (the scalar _block_upper fast path).
_GROW_KINDS = (int(tk.NestedOpKind.INSERT), int(tk.NestedOpKind.REPLACE_FIELD))
_POOLED_KINDS = _GROW_KINDS + (int(tk.NestedOpKind.SET),)
_POOLED_VKINDS = tuple(int(p) for p in tk._POOLED)

class TreeBatchEngine:
    """A fleet of tree replicas: host EditManagers + nested device columns."""

    CHECKPOINT_EVERY = 64  # trunk-log fold threshold (bounds host memory)
    COMPACT_FRACTION = 0.75  # row watermark that triggers a device compact

    def __init__(
        self,
        n_docs: int,
        capacity: int = 1024,
        ops_per_step: int = 16,
        max_insert_len: int = 16,
        pool_capacity: int = 4096,
        checkpoint_store=None,
        checkpoint_every: int = 0,
        doc_keys: list[str] | None = None,
        megastep_k: int = 1,
        mark_pool: bool = True,
        device_rebase: bool = False,
        overload_high_watermark: int = 0,
        overload_low_watermark: int = 0,
        native_wire: bool = True,
        telemetry=None,
        mesh=None,
        spare_slots: int = 0,
        plan_cache: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        if not plan_cache:
            # The reference's per-row emit path (its byte-identity oracle
            # for the plan cache) is not carried.
            raise NotImplementedError("plan_cache=False is not ported")
        if mesh is not None:
            # The mesh's device serves the engine; ``device`` may only
            # repeat it.
            if device != DEFAULT_DEVICE and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.n_docs = n_docs
        self.capacity = capacity
        self.pool_capacity = pool_capacity
        self.ops_per_step = ops_per_step
        self.max_insert_len = max_insert_len
        self.megastep_k = max(1, megastep_k)
        budget = self.megastep_k * ops_per_step
        self.overload_gate = OverloadGate(
            high=overload_high_watermark or 8 * budget,
            low=overload_low_watermark or budget,
        )
        # One pooled mark store shared by every doc's EditManager (fleet-wide
        # gauges); ``mark_pool=False`` keeps the object-mark fold.
        self.markpool = MarkPool() if mark_pool else None
        # Device rebase window: one shared DeviceRebaser on the engine's
        # device, so the fleet shares the field-interning table and the
        # gauges (device_rebase_fraction / rebase_fallbacks), as the shared
        # MarkPool.  Requires the pooled fold.
        self.rebaser = None
        if device_rebase and self.markpool is not None:
            self.rebaser = DeviceRebaser(self.markpool, device=self.device)
        # ingest_lines decodes in C++ when the library is built.
        self.native_wire = native_wire
        self.hosts = [
            _TreeHost(
                em=EditManager(mark_pool=self.markpool, device_rebase=self.rebaser),
                queue=RowQueue(tk.NESTED_OP_FIELDS, max_insert_len),
            )
            for _ in range(n_docs)
        ]
        self.fallbacks: dict[int, Forest] = {}
        self.checkpoint_store = checkpoint_store
        self.checkpoint_every = checkpoint_every
        # Checkpoint-plane lock: step/ingest/maybe_checkpoint/restore take
        # it, so a sweep only ever sees an op boundary.  Durable writes
        # happen after release under _ckpt_io_lock, seq-fenced per doc.
        self.ckpt_lock = threading.RLock()
        self._ckpt_io_lock = threading.Lock()
        self._ckpt_saved_seq: dict[int, int] = {}
        self.recovery_tracker = RecoveryTracker()
        # Record-file mtimes last seen by a refresh restore.
        self._trail_mtime: dict[int, float] = {}
        self.doc_keys = list(doc_keys) if doc_keys is not None else [
            str(d) for d in range(n_docs)
        ]
        if len(self.doc_keys) != n_docs:
            raise ValueError(f"{len(self.doc_keys)} doc_keys for {n_docs} docs")
        # Build the native decoder with no lock held: ingest_lines only
        # loads it under ckpt_lock.
        ingest_native.warm()
        self.counters = HealthCounters(telemetry)
        # Interning tables shared by the fleet; ROOT_FIELD must be id 0
        # (the virtual root's field in the materializer).
        self._fields: dict[str, int] = {ROOT_FIELD: 0}
        self._types: dict[str, int] = {}
        # Translation plan cache: commit shape -> row-layout plan.
        self._plans: dict[tuple, _TranslationPlan] = {}
        self._collector = _FlattenCollector()
        self._PLAN_CACHE_MAX = 4096
        # Placement rides the shared plane (models/placement.py): doc -> slot
        # indirection with per-shard spare-slot free pools; free and padding
        # rows are inert pristine rows.  ``_slot`` aliases the plane's array.
        self.n_shards = mesh.n_shards if mesh is not None else 1
        self.placement_plane = placement.PlacementPlane(n_docs, self.n_shards, spare_slots)
        self.fleet_capacity = self.placement_plane.capacity
        self.docs_per_shard = self.placement_plane.docs_per_shard
        self._slot = self.placement_plane.slots
        # Per-shard applied-op counters (host-side), accumulated at drain
        # time: the hot-shard detection signal.
        self._shard_ops = np.zeros((self.n_shards,), np.int64)
        # Pristine row: retires vacated and re-seeded slots.
        self._proto = tk.init_nested_forest(capacity, pool_capacity, device=self.device)
        self.state = tk.batch_nested(self._proto, self.fleet_capacity)
        self._busy: set[int] = set()
        self._stage: StagingRing | None = None
        # Host-side upper bounds on each doc's row and pool watermarks (rows
        # only grow on INSERT/REPLACE_FIELD, words on pooled INSERT/SET):
        # the compaction trigger without a per-batch device read.
        self._rows_upper = np.zeros((n_docs,), np.int64)
        self._pool_upper = np.zeros((n_docs,), np.int64)

    # -------------------------------------------------------------- interning
    def _field_id(self, key: str) -> int:
        return self._fields.setdefault(key, len(self._fields))

    def _type_id(self, t: str) -> int:
        return self._types.setdefault(t, len(self._types))

    def _encode_value(self, v) -> tuple[int, int, list[int] | None]:
        """value -> (vkind, inline-value-or-wordcount, pool words); raises
        UnsupportedShape for values the columns cannot carry (out-of-range
        ints, strings wider than one payload row, other types)."""
        try:
            vk, val, words = tk.encode_pooled_words(v)
        except ValueError as e:
            raise UnsupportedShape(str(e)) from None
        if words is not None and len(words) > self.max_insert_len:
            raise UnsupportedShape(f"leaf value wider than payload row: {v!r}")
        return vk, val, words

    # ------------------------------------------------------------------ ingest
    @staticmethod
    def _unwrap(contents: dict):
        """Yield the tree edit ops inside a wire message: grouped batches and
        the runtime's address envelopes (containerRuntime -> datastore ->
        channel) unwrap to their edits."""
        if not isinstance(contents, dict):
            return
        if contents.get("type") == "groupedBatch":
            for inner in contents.get("contents", []):
                yield from TreeBatchEngine._unwrap(inner)
            return
        if contents.get("type") == "edit":
            yield contents
            return
        if "address" in contents and "contents" in contents:
            yield from TreeBatchEngine._unwrap(contents["contents"])

    def ingest(self, doc_idx: int, msg: SequencedMessage) -> None:
        """Integrate one sequenced message: EditManager translation on the
        host, op-row staging for the device (or fallback apply).
        Serialized on ``ckpt_lock``."""
        if msg.type != MessageType.OP:
            return
        with self.ckpt_lock:
            for edit in self._unwrap(msg.contents):
                self._ingest_edit(doc_idx, msg, edit)

    def ingest_batch(self, doc_idxs, msgs) -> None:
        """Batch-delivery seam: tree translation is per edit (each commit
        rebases before it flattens), so this is ``ingest`` per message."""
        for d, m in zip(doc_idxs, msgs):
            self.ingest(d, m)

    def ingest_lines(self, doc_idx: int, data: bytes) -> int:
        """Stage newline-separated wire JSON for one tree document.  With
        ``native_wire`` and the mark pool, the C++ tree decoder (built)
        decodes the envelope and the numeric mark plane straight into pool
        columns; otherwise every line takes the Python parse.  A malformed
        line lands every earlier line, then raises through the Python
        decode (which owns error semantics).  Returns the op rows staged
        (the commits applied, for a fallback doc)."""
        with self.ckpt_lock:
            return self._ingest_lines(doc_idx, data)

    def _ingest_lines(self, doc_idx: int, data: bytes) -> int:
        h = self.hosts[doc_idx]
        commits_before = h.total_commits
        rows_before = len(h.queue)
        tables = None
        if self.markpool is not None and self.native_wire:
            try:
                tables = ingest_native.tree_decode(data)  # None: not built
            except ValueError:
                # Malformed line: re-decode in Python, so the error carries
                # the Python path's semantics (earlier lines land).
                self.counters.bump("tree_native_decode_errors")
                tables = None
        if tables is not None:
            self.counters.bump("tree_native_batches")
            self._ingest_native_tables(doc_idx, data, tables)
        else:
            for raw in data.split(b"\n"):
                line = raw.strip()
                if line:
                    self.ingest(doc_idx, SequencedMessage.from_json(line.decode()))
        if doc_idx in self.fallbacks:
            return h.total_commits - commits_before
        return len(h.queue) - rows_before

    def _ingest_native_tables(self, doc_idx: int, data: bytes, tables) -> None:
        msgs, chgs, flds, marks, spans = (t.tolist() for t in tables)
        for m in msgs:
            status = m[10]
            if status not in (ingest_native.TREE_ST_EDITS, ingest_native.TREE_ST_OPAQUE):
                continue  # non-op line: the op path ignores it too
            msg = SequencedMessage(
                client_id=data[m[4] : m[4] + m[5]].decode(),
                client_seq=m[13], ref_seq=m[1], seq=m[0], min_seq=m[2],
                type=MessageType.OP, contents=None,
            )
            if status == ingest_native.TREE_ST_OPAQUE:
                # Grouped batches, address envelopes, dict-form commits,
                # escaped ids: the Python walk, as without the library.
                contents = json.loads(data[m[11] : m[11] + m[12]])
                for edit in self._unwrap(contents):
                    self._ingest_edit(doc_idx, msg, edit)
                continue
            with span("host_fold_mark_alloc", doc=doc_idx):
                commit = pool_commit_from_native(
                    self.markpool, data, m, chgs, flds, marks, spans
                )
            self._ingest_edit(
                doc_idx, msg,
                {"sid": data[m[6] : m[6] + m[7]].decode(), "rev": m[3]},
                commit=commit,
            )

    def _ingest_edit(self, doc_idx: int, msg: SequencedMessage, c: dict,
                     commit=None) -> None:
        h = self.hosts[doc_idx]
        if h.base_seq and msg.seq <= h.base_seq:
            # Covered by the durable checkpoint (restart replay): skip.
            self.counters.bump("checkpointed_ops_skipped")
            return
        h.last_seq = max(h.last_seq, msg.seq)
        h.ops_since_ckpt += 1
        if not h.dirty_since:
            h.dirty_since = time.monotonic()
        if h.boot_counting:
            self.counters.bump("boot_replay_len")
        # Host-fold phases (flight recorder): mark_alloc (wire -> commit),
        # rebase (the EditManager window fold), compose (trunk suffix into
        # the checkpoint forest) and translate (``_flatten``).
        if commit is None:
            with span("host_fold_mark_alloc", doc=doc_idx):
                if self.markpool is not None:
                    commit = _pool_commit_from_json(self.markpool, c["changes"])
                else:
                    commit = commit_from_json(c["changes"])
        with span("host_fold_rebase", doc=doc_idx):
            trunk = h.em.add_sequenced(
                client_id=msg.client_id,
                revision=(c["sid"], c["rev"]),
                change=commit,
                ref_seq=msg.ref_seq,
                seq=msg.seq,
            )
            h.em.advance_min_seq(msg.min_seq)
        h.total_commits += 1
        if doc_idx in self.fallbacks:
            # Fallback docs apply directly; their trunk log is dead weight.
            apply_commit(self.fallbacks[doc_idx].root, trunk)
            return
        h.trunk_log.append(trunk)
        if len(h.trunk_log) >= self.CHECKPOINT_EVERY:
            # Fold the suffix into the checkpoint forest: bounded host
            # memory, and fallback routing replays only the tail.
            with span("host_fold_compose", doc=doc_idx):
                for t in h.trunk_log:
                    apply_commit(h.checkpoint.root, t)
                h.trunk_log.clear()
        try:
            with span("host_fold_translate", doc=doc_idx):
                ops_blk, pay_blk = self._flatten(trunk, msg.seq)
        except UnsupportedShape:
            self._route_to_fallback(doc_idx)
            return
        h.device_commits += 1
        rows_up, words_up = self._block_upper(ops_blk)
        self._rows_upper[doc_idx] += rows_up
        self._pool_upper[doc_idx] += words_up
        h.queue.extend_block(ops_blk, pay_blk)
        if h.queue:
            self._busy.add(doc_idx)

    @staticmethod
    def _block_upper(ops_blk: np.ndarray) -> tuple[int, int]:
        """(row, pool-word) upper bounds of an op-row block.  Tiny blocks
        (the per-edit ingest case) take a scalar walk."""
        if not len(ops_blk):
            return 0, 0
        if len(ops_blk) <= 8:
            t = tk._TGT
            rows = words = 0
            for r in ops_blk.tolist():
                if r[0] in _GROW_KINDS:
                    rows += r[t + 2]
                if r[0] in _POOLED_KINDS and r[t + 5] in _POOLED_VKINDS:
                    words += r[t + 4]
            return rows, words
        kinds = ops_blk[:, 0]
        ins = (kinds == tk.NestedOpKind.INSERT) | (
            kinds == tk.NestedOpKind.REPLACE_FIELD
        )
        vk = ops_blk[:, tk._TGT + 5]
        pooled_vk = vk == tk._POOLED[0]
        for p in tk._POOLED[1:]:
            pooled_vk |= vk == p
        pooled = (ins | (kinds == tk.NestedOpKind.SET)) & pooled_vk
        return (
            int(ops_blk[ins, tk._TGT + 2].sum()),
            int(ops_blk[pooled, tk._TGT + 4].sum()),
        )

    def _queued_upper(self, h: _TreeHost) -> tuple[int, int]:
        q_ops, _q_pay = h.queue.pending()
        return self._block_upper(q_ops)

    # --------------------------------------------------------------- flatten
    def _flatten(self, trunk_commit, seq: int) -> tuple[np.ndarray, np.ndarray]:
        """Trunk commit -> nested forest op-row BLOCKS ([M, F], [M, L]).

        Front-to-back walk in OUTPUT coordinates: every emitted op's
        positions (and every path step's sibling index) are valid in the
        state produced by the ops emitted before it, so sequential device
        application reproduces the simultaneous mark semantics exactly.
        The walk only collects, and the row work replays a cached
        per-shape plan."""
        col = self._collector
        col.reset()
        for change in trunk_commit:
            if change.value is not None:
                raise UnsupportedShape("value change on the virtual root")
            for key, fc in change.fields.items():
                self._walk_field(fc, (), self._field_id(key), col.emit)
        key = tuple(col.key)
        plan = self._plans.get(key)
        if plan is None:
            plan = _TranslationPlan(key, self.max_insert_len)
            if len(self._plans) < self._PLAN_CACHE_MAX:
                self._plans[key] = plan
            self.counters.bump("translation_plan_misses")
        else:
            self.counters.bump("translation_plan_hits")
        return plan.fill(col.dyn, col.pay, seq)

    def _walk_field(self, fc, steps: tuple, fid: int, emit) -> None:
        """Dispatch one field change by kind: sequence mark lists walk;
        optional/value whole-content sets become REPLACE_FIELD ops; other
        kinds route to the host fallback."""
        if isinstance(fc, list):
            if fc:
                self._walk_marks(fc, steps, fid, emit)
            return
        if not isinstance(fc, OptionalChange):
            raise UnsupportedShape(f"field kind {getattr(fc, 'kind', fc)!r}")
        if fc.set is not None:
            content = fc.set[0]
            if content is None:
                emit(tk.NestedOpKind.REPLACE_FIELD, steps, fid, count=0)
                return
            vk, val, words = self._encode_value(content.value)
            nt = self._type_id(content.type)
            emit(tk.NestedOpKind.REPLACE_FIELD, steps, fid, count=1,
                 value=val if words is not None else 0, vkind=vk, ntype=nt,
                 payload=("w", words) if words is not None else ("v", val))
            child_steps = steps + ((fid, 0),)
            for key, kids in content.fields.items():
                if kids:
                    self._insert_content(
                        kids, child_steps, self._field_id(key), 0, emit
                    )
            return
        if fc.nested is not None and not fc.nested.is_empty():
            self._walk_node_change(fc.nested, steps, fid, 0, emit)

    def _walk_node_change(self, ch, steps: tuple, fid: int, pos: int, emit) -> None:
        """A NodeChange against the node at (fid, pos) under ``steps``."""
        if ch.value is not None:
            vk, val, words = self._encode_value(ch.value[0])
            emit(tk.NestedOpKind.SET, steps, fid, pos=pos,
                 value=val, vkind=vk,
                 payload=("w", words) if words is not None else None)
        if any(ch.fields.values()):
            child_steps = steps + ((fid, pos),)
            for key, fc in ch.fields.items():
                self._walk_field(fc, child_steps, self._field_id(key), emit)

    def _walk_marks(self, marks, steps: tuple, fid: int, emit) -> None:
        if any(isinstance(m, (MoveOut, MoveIn)) for m in marks):
            self._emit_move_field(marks, steps, fid, emit)
            return
        out_pos = 0
        for m in marks:
            if isinstance(m, Skip):
                out_pos += m.count
            elif isinstance(m, Insert):
                out_pos += self._insert_content(
                    m.content, steps, fid, out_pos, emit
                )
            elif isinstance(m, Remove):
                emit(tk.NestedOpKind.REMOVE, steps, fid, pos=out_pos,
                     count=m.count)
            elif isinstance(m, Modify):
                self._walk_node_change(m.change, steps, fid, out_pos, emit)
                out_pos += 1
            else:
                raise UnsupportedShape(type(m).__name__)

    def _insert_content(self, nodes: list[Node], steps: tuple, fid: int,
                        start: int, emit) -> int:
        """Decompose a content forest into path-addressed inserts,
        parent-first; consecutive childless same-shape inline nodes batch
        into one op row.  Returns the number of nodes inserted here."""
        pos = start
        run_vals: list[int] = []
        run_shape: tuple[int, int] | None = None  # (vkind, ntype)

        def flush() -> None:
            nonlocal run_vals, run_shape
            if run_vals:
                emit(tk.NestedOpKind.INSERT, steps, fid,
                     pos=pos - len(run_vals), count=len(run_vals),
                     vkind=run_shape[0], ntype=run_shape[1],
                     payload=("r", list(run_vals)))
            run_vals, run_shape = [], None

        for node in nodes:
            vk, val, words = self._encode_value(node.value)
            nt = self._type_id(node.type)
            pooled = words is not None
            if pooled or (node.fields and any(node.fields.values())):
                # Pooled values carry their words in the payload row (one
                # node per op); interior nodes need their own op so child
                # inserts can address them parent-first.
                flush()
                emit(tk.NestedOpKind.INSERT, steps, fid, pos=pos, count=1,
                     value=val if pooled else 0, vkind=vk, ntype=nt,
                     payload=("w", words) if pooled else ("v", val))
                child_steps = steps + ((fid, pos),)
                for key, kids in node.fields.items():
                    if kids:
                        self._insert_content(
                            kids, child_steps, self._field_id(key), 0, emit
                        )
                pos += 1
            else:
                if run_shape not in (None, (vk, nt)) or len(run_vals) >= self.max_insert_len:
                    flush()
                run_shape = (vk, nt)
                run_vals.append(val)
                pos += 1
        flush()
        return pos - start

    def _emit_move_field(self, marks, steps: tuple, fid: int, emit) -> None:
        """A field containing a move: only the single-pair contiguous form
        maps to one device op (input coordinates); split moves,
        cross-field pairs and moves mixed with other marks fall back."""
        move_out: dict[int, tuple[int, int]] = {}
        move_in: dict[int, int] = {}
        in_pos = 0
        for m in marks:
            if isinstance(m, Skip):
                in_pos += m.count
            elif isinstance(m, MoveOut):
                if m.id in move_out:
                    raise UnsupportedShape("split move")
                move_out[m.id] = (in_pos, m.count)
                in_pos += m.count
            elif isinstance(m, MoveIn):
                if m.id in move_in:
                    raise UnsupportedShape("split move")
                move_in[m.id] = in_pos
            else:
                raise UnsupportedShape("mixed structural marks with move")
        if len(move_out) != 1 or set(move_out) != set(move_in):
            raise UnsupportedShape("non-single-pair move")
        (mid, (src, count)), = move_out.items()
        emit(tk.NestedOpKind.MOVE, steps, fid, pos=src, count=count,
             dst=move_in[mid])

    # ---------------------------------------------------------------- routing
    def _route_to_fallback(self, doc_idx: int) -> None:
        """Rebuild the document as a host Forest from its trunk log; all
        future commits apply there."""
        h = self.hosts[doc_idx]
        f = h.checkpoint  # trunk state up to the last checkpoint fold
        for trunk in h.trunk_log:
            apply_commit(f.root, trunk)
        self.fallbacks[doc_idx] = f
        h.checkpoint = Forest()
        h.trunk_log.clear()  # never replayed again
        h.queue.clear()
        self._busy.discard(doc_idx)
        # The doc's device rows are dead weight now; its stale watermarks
        # must not keep triggering fleet-wide compactions.
        self._rows_upper[doc_idx] = 0
        self._pool_upper[doc_idx] = 0

    # ------------------------------------------------------------------- step
    def pending_ops(self) -> int:
        return sum(len(h.queue) for h in self.hosts)

    def update_overload(self) -> tuple[list[int], list[int]]:
        """Ingest watermark hysteresis: -> (newly paused, newly resumed)."""
        return self.overload_gate.update(
            self._busy, lambda d: len(self.hosts[d].queue)
        )

    def ingest_watermarks(self) -> dict:
        return self.overload_gate.watermarks(self.megastep_k * self.ops_per_step)

    @property
    def overloaded(self) -> bool:
        return bool(self.overload_gate.paused)

    def device_fraction(self) -> float:
        """Fraction of ingested commits applied on the device path."""
        total = sum(h.total_commits for h in self.hosts)
        dev = sum(h.device_commits for h in self.hosts)
        return dev / total if total else 1.0

    def _staging(self) -> StagingRing:
        if self._stage is None:
            self._stage = StagingRing(
                self.megastep_k, self.fleet_capacity, self.ops_per_step,
                tk.NESTED_OP_FIELDS, self.max_insert_len, self.device,
            )
        return self._stage

    def _select_k(self, busy: list[int]) -> int:
        """Megastep depth from the deepest busy queue (pow2-quantized,
        capped at megastep_k)."""
        if self.megastep_k <= 1:
            return 1
        B = self.ops_per_step
        need = max(-(-len(self.hosts[d].queue) // B) for d in busy)
        return min(self.megastep_k, 1 << (max(need, 1).bit_length() - 1))

    def _drain_into(self, busy: list[int], ops: np.ndarray,
                    payloads: np.ndarray) -> list[int]:
        """Dequeue up to ops_per_step op rows per busy doc into its slot's
        row of the zeroed staging slice, charging the rows to the slot's
        shard; returns the rows written."""
        B = self.ops_per_step
        written: list[int] = []
        for d in busy:
            h = self.hosts[d]
            take = min(B, len(h.queue))
            if not take:
                continue
            r = int(self._slot[d])
            src_ops, src_payloads = h.queue.take(take)
            ops[r, :take] = src_ops
            payloads[r, :take] = src_payloads
            self._shard_ops[r // self.docs_per_shard] += take
            if not h.queue:
                self._busy.discard(d)
            written.append(r)
        return written

    def step(self) -> int:
        """Apply everything staged as batched device megasteps; returns the
        number of [D, B] slices applied.  Holds ``ckpt_lock`` end to end
        and closes an open recovery incident once staged work applied;
        cadence checkpoints are written after the lock releases."""
        with self.ckpt_lock:
            had_work = bool(self._busy)
            steps = self._step_fleet()
            if had_work and self.recovery_tracker.active:
                self.recovery_tracker.complete()
        self.maybe_checkpoint()
        return steps

    def _compact_and_resync(self) -> None:
        """K8 over the fleet, then reset the watermark bounds to the live
        rows/words plus what each doc still has queued (fallback docs to 0:
        no compaction lowers their stale rows)."""
        self.state = tk.compact_nested(self.state)
        queued_pairs = [self._queued_upper(h) for h in self.hosts]
        queued = np.array([q for q, _w in queued_pairs], np.int64)
        queued_words = np.array([w for _q, w in queued_pairs], np.int64)
        active = np.array([d not in self.fallbacks for d in range(self.n_docs)])
        nrow = self.state.nrow.cpu().numpy()[self._slot].astype(np.int64)
        pool_end = self.state.pool_end.cpu().numpy()[self._slot].astype(np.int64)
        self._rows_upper = np.where(active, nrow + queued, 0)
        self._pool_upper = np.where(active, pool_end + queued_words, 0)

    def _step_fleet(self) -> int:
        steps = 0
        while self._busy:
            # Proactive compact on the host-side bounds (dead rows pile up:
            # stable rows never reuse slots).
            if (
                self._rows_upper.max() > self.capacity * self.COMPACT_FRACTION
                or self._pool_upper.max() > self.pool_capacity * self.COMPACT_FRACTION
            ):
                self._compact_and_resync()
            busy = sorted(self._busy)
            K = self._select_k(busy)
            stage = self._staging()
            ops, payloads = stage.acquire(K, self.fleet_capacity)
            for k in range(K):
                stage.mark(k, self._drain_into(busy, ops[k], payloads[k]))
                if k + 1 < K:
                    busy = [d for d in busy if d in self._busy]
            # Kinds and path depths stay on the host: branch selection.
            host_ops = ops[..., :3].copy()
            dev_ops, dev_payloads = stage.upload(ops, payloads)
            with span("dispatch", kind="tree", k=K, shards=self.n_shards):
                self.state = tk.apply_nested_megastep(
                    self.state, dev_ops, dev_payloads, host_ops=host_ops
                )
            steps += K
            self.counters.bump("megastep_dispatches")
            self.counters.bump("megastep_slices", K)
        # One read of the error vector: latched docs replay on the host.
        with span("readback", kind="error_vector"):
            err = self.state.error.cpu().numpy()[self._slot]  # by doc
        routed = []
        for d in np.flatnonzero(err).tolist():
            if d not in self.fallbacks:
                self._route_to_fallback(d)
                self.counters.bump("fallback_routes")
                routed.append(int(self._slot[d]))
        if routed:
            self.state.error[torch.as_tensor(routed, device=self.device)] = 0
        return steps

    # ------------------------------------------------------------- checkpoint
    def maybe_checkpoint(self, force: bool = False, docs=None) -> list[int]:
        """Write durable checkpoint records (forest + EditManager window)
        for docs whose commit count since the last record reached
        ``checkpoint_every``; every dirty doc when ``force``; ``docs``
        restricts the sweep to an explicit list.  The host trunk fold is
        the snapshot, so this reads nothing from the device."""
        if self.checkpoint_store is None:
            return []
        if docs is None and not force and self.checkpoint_every <= 0:
            return []
        with self.ckpt_lock, span("checkpoint_sweep", docs=self.n_docs):
            out, pending = self._checkpoint_sweep(force, docs)
        write_checkpoint_records(self, pending)
        return out

    def checkpoint_stale(self, max_ops_behind: int = 0,
                         max_seconds_behind: float = 0.0) -> list[int]:
        """Bounded-staleness sweep: checkpoint every dirty doc whose durable
        record trails by ``max_ops_behind`` applied ops or
        ``max_seconds_behind`` seconds (0 disables a bound)."""
        if self.checkpoint_store is None or not (
            max_ops_behind or max_seconds_behind
        ):
            return []
        now = time.monotonic()
        with self.ckpt_lock:
            due = stale_due_docs(
                self.hosts, self.n_docs, max_ops_behind, max_seconds_behind, now,
            )
            if not due:
                return []
            with span("checkpoint_sweep", docs=len(due)):
                out, pending = self._checkpoint_sweep(force=False, docs=due)
            if out:
                self.counters.bump("stale_checkpoints_written", len(out))
        write_checkpoint_records(self, pending)
        return out

    def _checkpoint_sweep(
        self, force: bool, docs
    ) -> tuple[list[int], list[tuple[int, int, dict]]]:
        out: list[int] = []
        pending: list[tuple[int, int, dict]] = []
        for d in (range(self.n_docs) if docs is None else docs):
            h = self.hosts[d]
            if h.ops_since_ckpt <= 0:
                continue
            if (
                docs is None and not force
                and h.ops_since_ckpt < self.checkpoint_every
            ):
                continue
            if d in self.fallbacks:
                lane = "fallback"
                forest_json = self.fallbacks[d].to_json()
            else:
                lane = "device"
                # Fold the trunk suffix: the checkpoint forest is the full
                # trunk state.
                for t in h.trunk_log:
                    apply_commit(h.checkpoint.root, t)
                h.trunk_log.clear()
                forest_json = h.checkpoint.to_json()
            record = {
                "engine": "tree_batch",
                "lane": lane,
                "forest": forest_json,
                "em": h.em.summarize(),
                "commits": h.total_commits,
            }
            pending.append((d, h.last_seq, record))
            h.base_seq = h.last_seq
            h.ops_since_ckpt = 0
            h.dirty_since = 0.0
            h.boot_counting = False  # a new durable floor ends the boot phase
            self.counters.bump("checkpoints_written")
            out.append(d)
        return out, pending

    def note_incident(self, started_at: float) -> None:
        """Back-date the current recovery incident to the supervisor's kill
        timestamp (``time.monotonic`` domain)."""
        self.recovery_tracker.begin(started_at)

    def restore_from_checkpoints(self, store=None, parallel: bool = True,
                                 max_workers: int | None = None,
                                 refresh: bool = False) -> list[int]:
        """Engine restart path: rebuild each doc's host forest and
        EditManager window from its durable record, re-materialize the
        device columns from the forest (one whole-content insert commit,
        applied by the next step), and set the seq floor so replayed ops
        the record covers are skipped.  ``parallel`` loads the records on a
        thread pool (builds stay in doc order); ``refresh`` adopts docs
        that gained a newer record since the last pass (re-seeding an
        adopted doc in place) and applies the re-materialization at once,
        without opening a recovery incident."""
        store = store if store is not None else self.checkpoint_store
        if store is None:
            return []
        with self.ckpt_lock:
            return self._restore(store, parallel, max_workers, refresh)

    def _restore(self, store, parallel, max_workers, refresh) -> list[int]:
        t_start = time.monotonic()
        with span("restore_scan", docs=self.n_docs):
            candidates, cand_mtime = placement.restore_candidates(
                self, store, refresh, lambda d: len(self.hosts[d].queue)
            )
        if not candidates:
            return []
        records = load_checkpoint_records(
            store, [self.doc_keys[d] for d in candidates],
            parallel=parallel, max_workers=max_workers,
        )
        restored: list[int] = []
        for i, d in enumerate(candidates):
            rec = records.get(i)
            if rec is not None and d in cand_mtime:
                self._trail_mtime[d] = cand_mtime[d]
            if rec is None or rec.get("engine") != "tree_batch":
                continue
            h = self.hosts[d]
            if refresh and h.restored:
                if int(rec["seq"]) <= h.last_seq:
                    continue  # nothing newer to adopt
                self.counters.bump("checkpoint_refreshes")
            if refresh:
                self._drop_restored_identity(d)
            # Restored EditManagers fold on the host, as the reference's do:
            # the rebaser's gauges count only the docs it was built with.
            h.em = EditManager(mark_pool=self.markpool)
            h.em.load(rec["em"])
            h.base_seq = h.last_seq = int(rec["seq"])
            h.restored = True
            h.boot_counting = True
            h.total_commits = int(rec.get("commits", 0))
            forest = Forest()
            forest.load_json(rec["forest"])
            if rec.get("lane") == "fallback":
                self.fallbacks[d] = forest
                h.checkpoint = Forest()
                restored.append(d)
                self.counters.bump("docs_restored")
                continue
            h.checkpoint = forest
            if forest.root_field:
                # Re-materialize the device columns: the checkpoint forest as
                # one whole-content insert commit (the live flatten path, so
                # interning and accounting match).
                ch = NodeChange()
                ch.fields[ROOT_FIELD] = [
                    Insert([n.clone() for n in forest.root_field])
                ]
                try:
                    ops_blk, pay_blk = self._flatten([ch], seq=h.base_seq)
                except UnsupportedShape:
                    self._route_to_fallback(d)
                    restored.append(d)
                    self.counters.bump("docs_restored")
                    continue
                rows_up, words_up = self._block_upper(ops_blk)
                self._rows_upper[d] += rows_up
                self._pool_upper[d] += words_up
                h.queue.extend_block(ops_blk, pay_blk)
                if h.queue:
                    self._busy.add(d)
            restored.append(d)
            self.counters.bump("docs_restored")
        if restored and not refresh:
            # A real restore opens a recovery incident: closed by the first
            # step that applies staged work (the re-materialization rows).
            self.recovery_tracker.begin(t_start)
        if restored and refresh:
            # Trailing/re-seed hands back live state at once.
            self._step_fleet()
        return restored

    def _drop_restored_identity(self, d: int) -> None:
        """Forget a doc's prior adoption before a refresh re-seed: host
        windows, staged rows and fallback entry go, and the doc's device
        row resets to the pristine proto row (re-materialization lands on
        clean state)."""
        had_fallback = self.fallbacks.pop(d, None) is not None
        h = self.hosts[d]
        h.queue.clear()
        h.trunk_log.clear()
        h.checkpoint = Forest()
        self._busy.discard(d)
        self._rows_upper[d] = 0
        self._pool_upper[d] = 0
        if h.total_commits or h.restored or had_fallback:
            self._reset_row(int(self._slot[d]))

    def _reset_row(self, slot: int) -> None:
        """Retire state row ``slot`` to the pristine row."""
        for x, p in zip(self.state, self._proto):
            x[slot] = p

    # ---------------------------------------------------- placement/migration
    def shard_of(self, doc_idx: int) -> int:
        """The shard hosting this doc's state row."""
        return self.placement_plane.shard_of(doc_idx)

    def placement(self) -> dict[str, int]:
        """doc key -> shard: the summary-ownership alignment surface."""
        return self.placement_plane.placement(self.doc_keys)

    def shard_load(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard (applied ops since the last ``hot_shards`` reset,
        queued ops) — ``placement.shard_load``."""
        return placement.shard_load(self)

    def hot_shards(self, factor: float = 2.0, reset: bool = False, load=None) -> list[int]:
        """Shards whose load exceeds ``factor`` x the fleet mean —
        ``placement.hot_shards``."""
        return placement.hot_shards(self, factor, reset, load)

    def free_slots(self, shard: int) -> int:
        return self.placement_plane.free_slots(shard)

    def migrate_doc(self, d: int, dst_shard: int) -> bool:
        # ckpt_lock: migration mutates the state and the slot map, which the
        # checkpoint sweep and ingest read.
        with self.ckpt_lock:
            return self._migrate_doc_locked(d, dst_shard)

    def _migrate_doc_locked(self, d: int, dst_shard: int) -> bool:
        """Live tree-doc migration between shards.

        The handoff is the restore path's trunk fold and re-materialization:
        the trunk suffix folds into the checkpoint forest (then the doc's
        whole ingested trunk state, rows still queued included, so the
        queue drops), the vacated slot retires to the pristine row, and the
        forest re-materializes at the destination slot as one whole-content
        insert staged through the normal step.  ``tree_json`` is identical
        once the staged rows apply; EditManager windows and checkpoint
        floors travel untouched, so a doc may migrate mid-stream.  Raises
        ``placement.PlacementError`` for a fallback-routed doc; returns
        False (the doc stays) when it is already on ``dst_shard``, its row
        latched, the forest cannot re-flatten, or the destination has no
        free slot."""
        plane = self.placement_plane
        plane.validate(d, dst_shard)
        plane.require_migratable(d, "fallback" if d in self.fallbacks else None)
        reservation = plane.reserve(d, dst_shard)
        if reservation is None:
            return False
        src_slot, dst_slot = reservation
        src_shard = src_slot // self.docs_per_shard
        h = self.hosts[d]
        if int(self.state.error[src_slot]):
            plane.release(dst_slot)
            return False  # recover first; never migrate a latched row
        for t in h.trunk_log:
            apply_commit(h.checkpoint.root, t)
        h.trunk_log.clear()
        ops_blk = pay_blk = None
        if h.checkpoint.root_field:
            ch = NodeChange()
            ch.fields[ROOT_FIELD] = [Insert([n.clone() for n in h.checkpoint.root_field])]
            try:
                ops_blk, pay_blk = self._flatten([ch], seq=h.last_seq)
            except UnsupportedShape:
                plane.release(dst_slot)
                return False  # cannot re-pack: the doc keeps serving in place
        # Queued rows are covered by the folded forest; re-staging them on
        # top of the re-materialization would apply them twice.
        h.queue.clear()
        self._busy.discard(d)
        self._reset_row(src_slot)
        plane.commit(d, src_slot, dst_slot)
        # The destination slot is pristine (spare slots start as pristine
        # rows; retired slots reset above): the watermarks restart at the
        # re-materialization bound.
        self._rows_upper[d] = 0
        self._pool_upper[d] = 0
        if ops_blk is not None and len(ops_blk):
            rows_up, words_up = self._block_upper(ops_blk)
            self._rows_upper[d] += rows_up
            self._pool_upper[d] += words_up
            h.queue.extend_block(ops_blk, pay_blk)
            self._busy.add(d)
        self.counters.bump("doc_migrations")
        instant("migrate_doc", doc=self.doc_keys[d], src=src_shard, dst=dst_shard)
        return True

    def rebalance_hot_shards(self, factor: float = 2.0,
                             max_moves: int = 1) -> list[tuple[int, int, int]]:
        """Detect hot shards and live-migrate their deepest-queued docs to
        the coldest shards with free slots (``placement.rebalance_hot_shards``,
        one trunk fold and re-materialization per move).  Returns the
        ``(doc, src_shard, dst_shard)`` moves made."""
        return placement.rebalance_hot_shards(
            self, self.placement_plane, factor, max_moves,
            in_lane=lambda d: d in self.fallbacks,
        )

    # ---------------------------------------------------------- boot adoption
    def adopt_boot_snapshot(self, doc_idx: int, record: dict) -> placement.AdoptResult:
        """Client half of the fan-out plane's ``{"t":"resync","boot":true}``
        contract (``placement.adopt_boot_snapshot`` over this engine's
        refresh re-seed path): a consumer that fell off the retained log
        re-seeds the document from a historian snapshot record (the scribe
        summary schema, ``engine: tree_batch``) and re-consumes from the
        returned floor; the host EditManager window, checkpoint forest and
        materialized device columns all reset consistently."""
        return placement.adopt_boot_snapshot(self, doc_idx, record, self._clear_staged)

    def _clear_staged(self, doc_idx: int) -> None:
        """Drop a doc's staged pre-gap work ahead of a boot-snapshot
        adoption (the refresh guard refuses docs with pending ops; a boot
        resync REPLACES the doc, so pre-gap rows are covered)."""
        self.hosts[doc_idx].queue.clear()
        self._busy.discard(doc_idx)

    # ----------------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Warm the fleet's serving programs (warm-standby boot): dispatch
        all-NOOP megasteps at K=1, every power of two up to ``megastep_k``
        and a non-power-of-two ``megastep_k`` itself, plus one compact,
        through the serving entry points.  On the card this loads the CUDA
        kernel library and makes each program's first launch before
        promotion.  Zeroed staging rows are NOOP by kernel contract
        (``NestedOpKind.NOOP == 0``) and the compact's result is dropped, so
        the state bytes are untouched.
        Returns the number of warmup dispatches (the reference's count)."""
        warmed = 0
        with self.ckpt_lock, span("warmup", k_max=self.megastep_k):
            if self.device.type == "cuda":
                from ..ops import cuda_build

                cuda_build.load()
            stage = self._staging()
            for k in warmup_depths(self.megastep_k):
                ops, payloads = stage.acquire(k, self.fleet_capacity)
                host_ops = ops[..., :3].copy()
                dev_ops, dev_payloads = stage.upload(ops, payloads)
                self.state = tk.apply_nested_megastep(
                    self.state, dev_ops, dev_payloads, host_ops=host_ops
                )
                warmed += 1
            # The compact's first launch, its result dropped: a warmup never
            # compacts a serving fleet's dead rows (the reference's does).
            tk.compact_nested(self.state)
            warmed += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.counters.gauge("warmup_dispatches", warmed)
        return warmed

    # ----------------------------------------------------------------- health
    def health(self) -> dict:
        """The reference's health surface without ``recompiles`` and
        ``despecializations`` (the port compiles nothing at run time)."""
        self.counters.gauge("megastep_k", self.megastep_k)
        self.counters.gauge(
            "staging_overlap_packs",
            self._stage.overlapped_packs if self._stage is not None else 0,
        )
        self.counters.ratio(
            "steps_per_dispatch", "megastep_slices", "megastep_dispatches"
        )
        hits = self.counters.get("translation_plan_hits")
        misses = self.counters.get("translation_plan_misses")
        self.counters.gauge(
            "translation_plan_hit_rate",
            round(hits / (hits + misses), 4) if hits + misses else 0.0,
        )
        self.counters.gauge("translation_plans", len(self._plans))
        if self.markpool is not None:
            ps = self.markpool.stats()
            hits = ps["mark_pool_reuse_hits"]
            total = hits + ps["mark_pool_spans"]
            self.counters.gauge(
                "mark_pool_hit_rate",
                round(hits / total, 4) if total else 0.0,
            )
            for k, v in ps.items():
                self.counters.gauge(k, v)
        # Device-rebase surface: the share of window steps resolved by K9;
        # fallbacks are the pooled-fold remainder (ineligible commits and
        # invalidated steps), counted, never silent.
        if self.rebaser is not None:
            for k, v in self.rebaser.stats().items():
                self.counters.gauge(k, v)
        self.overload_gate.emit_gauges(
            self.counters, self.megastep_k * self.ops_per_step,
            max((len(self.hosts[d].queue) for d in self._busy), default=0),
        )
        self.counters.gauge("n_shards", self.n_shards)
        if self.n_shards > 1:
            depth = [0] * self.n_shards
            for d in range(self.n_docs):
                q = len(self.hosts[d].queue)
                if q:
                    depth[self.shard_of(d)] += q
            self.counters.gauge("shard_queue_depth", depth)
        self.recovery_tracker.emit_gauges(self.counters)
        now = time.monotonic()
        self.counters.gauge(
            "dirty_docs", sum(1 for h in self.hosts if h.ops_since_ckpt > 0)
        )
        self.counters.gauge(
            "checkpoint_age_s",
            round(
                max(
                    (now - h.dirty_since for h in self.hosts if h.dirty_since),
                    default=0.0,
                ),
                3,
            ),
        )
        snap = self.counters.snapshot()
        snap.update(
            fallback_docs=len(self.fallbacks),
            checkpoint_age_seqs=max(
                (h.last_seq - h.base_seq for h in self.hosts if h.last_seq),
                default=0,
            ),
            device_fraction=round(self.device_fraction(), 4),
        )
        return snap

    # ------------------------------------------------------------------ views
    def _name_tables(self) -> tuple[dict[int, str], dict[int, str]]:
        return (
            {v: k for k, v in self._fields.items()},
            {v: k for k, v in self._types.items()},
        )

    def doc_state(self, doc_idx: int) -> tk.NestedForestState:
        """A doc's device row, at its slot (views of the fleet state)."""
        slot = int(self._slot[doc_idx])
        return tk.tree_map(lambda x: x[slot], self.state)

    def tree_json(self, doc_idx: int) -> list[dict]:
        """The document's root field as forest JSON (Node.to_json shape)."""
        if doc_idx in self.fallbacks:
            return [n.to_json() for n in self.fallbacks[doc_idx].root_field]
        field_names, type_names = self._name_tables()
        return tk.nested_to_json(self.doc_state(doc_idx), field_names, type_names)

    def values(self, doc_idx: int) -> list:
        """The document's root-field node values (None for valueless nodes)."""
        return [n.get("v") for n in self.tree_json(doc_idx)]

    def errors(self) -> np.ndarray:
        """Per-doc error latches (doc-indexed, through the slot map)."""
        return self.state.error.cpu().numpy()[self._slot]
