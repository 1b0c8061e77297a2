"""DocBatchEngine: batched sequenced-op application across many documents.

Counterpart of ``fluidframework_tpu/models/doc_batch_engine.py``: thousands
of SharedString replicas, each with its own totally ordered op stream,
applied in lockstep device megasteps.

- host: per-doc ``RowQueue`` staging of sequenced messages, op encoding
  (stamp keys, positions, payload codepoints), quorum (clientId -> short
  id), prop-slot interning, the retained wire log that recovery replays;
- device: ``step`` packs up to K [D, B] slices into a pinned staging ring,
  uploads them and applies them with ``apply_megastep`` through the
  dispatch plane; ``compact`` advances every doc's MSN and runs zamboni.

The state, the lanes and the checkpoint files are byte-identical to the
reference engine's for the same message stream.

Recovery (``recovery=``, default ``"grow"`` as in the reference): after
every ``step`` the engine reads the fleet's error count (one scalar) and
recovers each flagged document, so no error bit survives a run.

- Capacity errors (ERR_SEG/TEXT/REM/OB_OVERFLOW): ``"grow"`` replays the
  document's retained log (from its checkpoint base) into an *overflow
  lane* — a one-document state on the same device with the implicated
  capacity axes doubled — up to ``max_growths`` times, then falls back to
  the host oracle; ``"oracle"`` goes to the oracle at once.
- Poison errors (ERR_POS_RANGE alone, a decode failure at ingest, a
  divergence the watchdog finds): the document is *quarantined* into a
  host oracle rebuilt from its checkpoint and retained tail, where every
  further op is validated before it applies (malformed ops are dropped and
  counted).  ``readmit`` (or ``readmit_after_steps`` with exponential
  backoff, and ``poison_budget`` for flapping docs) returns it to the batch.
- Checkpoints (``checkpoint_store``, ``checkpoint_every``): a document's
  state is written as a summary record (``dds/kernel_backend.py``) and its
  retained log truncated to the ops after it; ``restore_from_checkpoints``
  rebuilds an engine from the records.
- The divergence watchdog (``watchdog_every``, ``watchdog_sample``)
  re-replays a rotating sample of batch docs through the host oracle and
  quarantines on mismatch; a device digest of every row (``fleet_digest``,
  K4) lets it skip docs whose digest and stream have not moved since they
  last passed.

``recovery="off"`` latches error bits on the per-doc ``error`` column and
leaves them there (``errors()``).

Wire ingest: ``ingest`` decodes one message; ``ingest_batch`` decodes a
whole mixed-doc batch with vectorized numpy into the per-doc row queues,
byte-identical to ``ingest`` per message; ``ingest_lines`` stages JSON
lines through the C++ encoder (``native/ingest_native.py``; the Python
decode when the library is not built or the doc left the batch).  A doc
stays on the path that fed it first.

Flow control and observability: ``update_overload`` / ``ingest_watermarks``
/ ``overloaded`` (``OverloadGate``, pause at ``overload_high_watermark``,
resume at ``overload_low_watermark``); every ``latency_sample_every``-th op
is timed from its sequencer stamp to the end of the ``step`` that applied it
(``op_latency``, ``latency_p50_ms``/``latency_p99_ms`` in ``health()``);
``telemetry=`` attaches a ``utils.telemetry.Logger``; the serving phases are
flight-recorder spans (``observability``).  With ``recovery="off"`` nothing
waits for the device inside ``step``, so a latency sample there times the
launch, not the apply.  ``health()`` carries no ``recompiles``: the port
compiles nothing at run time.

Serving: ``adopt_boot_snapshot`` re-seeds one doc from a historian
snapshot record (``models/placement.py``); ``warmup`` makes the serving
programs' first launches ahead of a standby's promotion; ``note_incident``
back-dates the recovery clock.

Not ported yet (``NotImplementedError``): multi-shard segment lanes
(``seg_shards > 1``, ``seg_lane_segments``, ``seg_rebalance_every``), spare
slots and migration, and cohort steps: every megastep runs fleet-wide.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from ..dds import kernel_backend as kb
from ..dds.mergetree_ref import RefMergeTree
from ..dds.shared_string import validate_obliterate_places
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import mergetree_kernel as mk
from ..native import ingest_native
from ..observability.flight_recorder import span
from ..protocol.messages import (
    DeltaType,
    MessageType,
    SequencedMessage,
    decode_obliterate_places,
)
from ..utils.telemetry import HealthCounters, Histogram, SampledTelemetryHelper
from . import placement
from .dispatch import dispatch_plane
from .recovery import (
    RecoveryTracker,
    load_checkpoint_records,
    stale_due_docs,
    write_checkpoint_records,
)
from .staging import OverloadGate, RowQueue, StagingRing, warmup_depths


class _DocHost:
    """Host-side per-document bookkeeping."""

    __slots__ = (
        "queue", "quorum", "min_seq", "prop_slot", "log", "raw_log", "native",
        "mode", "base_seq", "base_summary", "last_seq", "ops_since_ckpt",
        "dirty_since", "restored", "boot_counting",
    )

    def __init__(self, max_insert_len: int) -> None:
        self.queue = RowQueue(mk.OP_FIELDS, max_insert_len)
        self.quorum: dict[str, int] = {}
        self.min_seq = 0
        self.prop_slot: dict[int, int] = {}  # property id -> kernel prop slot
        # Retained wire log (every OP message with seq > base_seq, in
        # sequence order): the replay source for recovery.  Ops at or below
        # ``base_seq`` live in ``base_summary`` (the checkpoint) instead.
        self.log: list[SequencedMessage] = []
        # Docs fed through the native byte path retain raw lines instead.
        self.raw_log: list[bytes] = []
        self.native = None  # NativeIngestEncoder once the byte path is used
        self.mode: str | None = None  # "obj" | "native", fixed at first ingest
        self.base_seq = 0
        self.base_summary: dict | None = None  # None = empty doc
        self.last_seq = 0  # highest OP seq ingested
        self.ops_since_ckpt = 0
        # Monotonic time the doc first went dirty after its last durable
        # checkpoint (0.0 = clean): ``checkpoint_stale``'s seconds bound.
        self.dirty_since = 0.0
        # Set by restore_from_checkpoints: the doc consumes parsed messages
        # (seq dedupe needs per-message seqs the native encoder cannot skip).
        self.restored = False
        # Count applied ops as boot_replay_len only until the first
        # checkpoint after a restore.
        self.boot_counting = False


class _OverflowLane:
    """A document that outgrew the lockstep batch: its own state (a batch
    of one, on the engine's device), geometry and queue."""

    __slots__ = ("state", "geometry", "growths", "queue")

    def __init__(self, state: mk.DocState, geometry: dict[str, int],
                 growths: int, queue: RowQueue) -> None:
        self.state = state
        self.geometry = geometry
        self.growths = growths
        self.queue = queue


def _i32(v) -> int:
    """Coerce one wire scalar for the batch walk with the per-message
    path's failure shape: ``np.array([...], np.int32)`` raises
    OverflowError on out-of-range ints, where the batch path's int64
    staging columns would wrap silently on the int32 cast."""
    v = int(v)
    if not (-0x80000000 <= v <= 0x7FFFFFFF):
        raise OverflowError(f"op scalar {v} out of int32 range")
    return v


def _fleet_compact_body(state: mk.DocState, min_seqs) -> mk.DocState:
    """Cadence compaction: every doc's MSN advance, then zamboni (the
    reference's ``_fleet_compact_body``; also the overflow lanes')."""
    return mk.compact(mk.set_min_seq(state, min_seqs))


# ----------------------------------------------------------------- K4 digest
#
# The reference computes the digest in uint32 arithmetic that wraps.  Here
# every term is computed in int64 and reduced mod 2**32 before it can
# overflow: a value (any int32, read as its uint32 bit pattern, < 2**32)
# times one 16-bit half of a weight stays below 2**48, so
# x * w mod 2**32 = (x * w_lo mod 2**32 + (x * w_hi mod 2**16) * 2**16)
# mod 2**32 is exact for every input, and a row sum of N reduced terms
# stays below N * 2**32.

_M32 = 0xFFFFFFFF
# Docs per chunk of the digest: [chunk, T] int64 temporaries of at most
# this many elements (32 MiB each), whatever the fleet's size.
DIGEST_CHUNK_ELEMS = 1 << 22


def _split_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return w & 0xFFFF, w >> 16


def _mulsum32(x: torch.Tensor, w: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Per row: sum(x * w) mod 2**32 with uint32 semantics ([C, N] -> [C])."""
    lo, hi = w
    x = x.long() & _M32
    return (
        ((x * lo) & _M32).sum(-1) + (((x * hi) & 0xFFFF).sum(-1) << 16)
    ) & _M32


def fleet_digest(state: mk.DocState) -> torch.Tensor:
    """K4: a per-doc state digest computed on the state's device — a
    position-weighted checksum of the text pool plus the segment layout
    columns (``seg_len``, ``seg_start``, ``rem_keys``) and the ``text_end``
    and ``nseg`` scalars.  The watchdog's pre-filter: a doc whose digest
    and ingested seq have not moved since it last passed cannot have
    diverged since.  Bit-for-bit the reference's ``_fleet_digest``; returns
    int64[D] holding the uint32 values.  Runs in chunks of docs so it adds
    a bounded amount to peak memory."""
    dev = state.text.device
    D, T = state.text.shape
    S = state.seg_len.shape[-1]
    t_iota = torch.arange(T, dtype=torch.int64, device=dev)
    s_iota = torch.arange(S, dtype=torch.int64, device=dev)
    ws_full = (s_iota * 0x85EBCA6B + 0xC2B2AE35) & _M32
    wt = _split_weight((t_iota * 2654435761 + 0x9E3779B9) & _M32)
    ws = _split_weight(ws_full)
    wsx = _split_weight(ws_full ^ 0xA5A5A5A5)
    out = torch.empty((D,), dtype=torch.int64, device=dev)
    chunk = max(1, DIGEST_CHUNK_ELEMS // max(T, S))
    for c0 in range(0, D, chunk):
        rows = slice(c0, min(D, c0 + chunk))
        dig = (
            _mulsum32(state.text[rows], wt)
            + _mulsum32(state.seg_len[rows], ws)
            + _mulsum32(state.seg_start[rows], wsx)
        ) & _M32
        for rk in state.rem_keys:
            dig = (dig * 31 + _mulsum32(rk[rows], ws)) & _M32
        dig = (dig * 31 + (state.text_end[rows].long() & _M32)) & _M32
        dig = (dig * 31 + (state.nseg[rows].long() & _M32)) & _M32
        out[rows] = dig
    return out


# Reference constructor options this port does not carry yet, with the
# values that leave them off (``seg_shards=1`` is a one-shard fleet: off).
_OPTIONS_OFF = {
    "spare_slots": (0,), "seg_shards": (0, 1), "seg_lane_segments": (0,),
    "seg_rebalance_every": (0,),
}


class DocBatchEngine:
    """A fleet of merge-tree replicas stepped as one batched device program."""

    def __init__(
        self,
        n_docs: int,
        max_segments: int = 512,
        remove_slots: int = 4,
        prop_slots: int = 4,
        text_capacity: int = 16384,
        max_insert_len: int = 64,
        ops_per_step: int = 16,
        ob_slots: int = 8,
        megastep_k: int = 1,
        recovery: str = "grow",
        max_growths: int = 4,
        checkpoint_store=None,
        checkpoint_every: int = 0,
        doc_keys: list[str] | None = None,
        watchdog_every: int = 0,
        watchdog_sample: int = 4,
        readmit_after_steps: int = 0,
        poison_budget: int = 0,
        telemetry=None,
        latency_sample_every: int = 16,
        overload_high_watermark: int = 0,
        overload_low_watermark: int = 0,
        device=DEFAULT_DEVICE,
        **options,
    ) -> None:
        if recovery not in ("grow", "oracle", "off"):
            raise ValueError(f"recovery={recovery!r}: expected grow, oracle or off")
        for name, value in options.items():
            if name not in _OPTIONS_OFF:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value not in _OPTIONS_OFF[name]:
                raise NotImplementedError(f"{name}={value!r} is not ported yet")
        self.device = resolve_device(device)
        self.n_docs = n_docs
        self.capacity = n_docs  # one device: no mesh rounding, no spare slots
        self.max_insert_len = max_insert_len
        self.ops_per_step = ops_per_step
        self.megastep_k = max(1, megastep_k)
        # Ingest watermarks: one megastep retires ``budget`` rows per doc;
        # a deeper queue than ``high`` pauses the doc until it drains to
        # ``low``.  Defaults: 8x / 1x the budget.
        budget = self.megastep_k * ops_per_step
        self.overload_gate = OverloadGate(
            high=overload_high_watermark or 8 * budget,
            low=overload_low_watermark or budget,
        )
        self.recovery = recovery
        self.max_growths = max_growths
        self.hosts = [_DocHost(max_insert_len) for _ in range(n_docs)]
        self.geometry = {
            "max_segments": max_segments,
            "remove_slots": remove_slots,
            "prop_slots": prop_slots,
            "text_capacity": text_capacity,
            "ob_slots": ob_slots,
        }
        # Recovery lanes (doc -> overflow lane / oracle replica), and the
        # quarantine lane: docs whose op stream (or device state) proved
        # bad, served by a validated host oracle until readmission.
        self.overflow: dict[int, _OverflowLane] = {}
        self.oracles: dict[int, RefMergeTree] = {}
        self.quarantine: dict[int, RefMergeTree] = {}
        self.quarantine_reason: dict[int, str] = {}
        self.checkpoint_store = checkpoint_store
        self.checkpoint_every = checkpoint_every
        # Checkpoint-plane lock: step/ingest/maybe_checkpoint/restore take
        # it, so a sweep only ever sees the engine at an op boundary.
        # Re-entrant because step() calls into checkpointing under it.
        self.ckpt_lock = threading.RLock()
        # Durable writes happen outside ckpt_lock, serialized here with
        # per-doc seq fencing (models/recovery.write_checkpoint_records).
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
        # Build the native encoder here, with no lock held: ingest_lines
        # only loads it (a compiler run under ckpt_lock would stall ingest).
        ingest_native.warm()
        self.watchdog_every = watchdog_every
        self.watchdog_sample = watchdog_sample
        self._watchdog_cursor = 0
        self._steps_since_watchdog = 0
        # Watchdog pre-filter: per doc the (digest, last_seq) pair recorded
        # when it last PASSED a check.  Skipping needs both unchanged: the
        # digest alone cannot tell "no ops applied" from "ops silently
        # dropped by the kernel".
        self._verified_digest: dict[int, tuple[int, int]] = {}
        # Quarantine readmission policy: retry after ``readmit_after_steps``
        # steps, doubling per flap; more than ``poison_budget`` flaps (0 =
        # no budget) routes the doc to the oracle for good.
        self.readmit_after_steps = readmit_after_steps
        self.poison_budget = poison_budget
        self._step_count = 0
        self._flaps: dict[int, int] = {}
        self._readmit_due: dict[int, int] = {}
        self._readmit_interval: dict[int, int] = {}
        self.counters = HealthCounters(
            telemetry,
            megastep_dispatches=0, megastep_slices=0, ops_staged=0,
            ob_gate_syncs=0,  # device reads of the obliterate gate
        )
        # Sampled step timing (one event per 64 steps; ``flush_telemetry``
        # drains the tail).
        self.sampled = (
            SampledTelemetryHelper(telemetry, "engine_step", sample_every=64)
            if telemetry is not None
            else None
        )
        # Op latency: sequencer stamp -> end of the step that applied it,
        # sampled every ``latency_sample_every`` staged ops; pending samples
        # resolve in ``_lat_flush`` at the end of ``step``.
        self.latency_sample_every = max(1, latency_sample_every)
        self.op_latency = Histogram()
        self._doc_latency: dict[int, Histogram] = {}
        self._lat_tick = 0
        self._lat_pending: list[tuple[float, int]] = []
        pm = self._pm = dispatch_plane()
        self.mesh = pm.doc_mesh(self.device)
        proto = mk.init_state(
            max_segments, remove_slots, prop_slots, text_capacity, ob_slots,
            device=self.device,
        )
        self.state = pm.shard_fleet_state(mk.batch_state(proto, n_docs), self.mesh)
        self._megastep = pm.mesh_fleet_program(mk.apply_megastep, self.mesh)
        self._compact = pm.mesh_fleet_program(_fleet_compact_body, self.mesh)
        # Docs with a nonempty host queue, maintained by ingest and drain.
        self._busy: set[int] = set()
        self._stage: StagingRing | None = None

    # ------------------------------------------------------------------ ingest
    def ingest(self, doc_idx: int, msg: SequencedMessage) -> None:
        """Stage one sequenced message for a document (host-side decode);
        application is deferred to the next ``step``.  Serialized on
        ``ckpt_lock``."""
        with self.ckpt_lock:
            return self._ingest_one(doc_idx, msg)

    def _ingest_one(self, doc_idx: int, msg: SequencedMessage) -> None:
        h = self.hosts[doc_idx]
        assert h.mode != "native" or self._in_lane(doc_idx), (
            f"doc {doc_idx} already fed through the native byte path; "
            "pick one ingest path per document"
        )
        if h.mode is None:
            h.mode = "obj"
        h.min_seq = max(h.min_seq, msg.min_seq)
        if msg.type == MessageType.JOIN:
            h.quorum[msg.contents["clientId"]] = msg.contents["short"]
            return
        if msg.type != MessageType.OP:
            return
        if h.base_seq and msg.seq <= h.base_seq:
            # Already folded into the durable checkpoint (a restarted
            # consumer replaying from an older offset): skip.
            self.counters.bump("checkpointed_ops_skipped")
            return
        h.last_seq = max(h.last_seq, msg.seq)
        h.ops_since_ckpt += 1
        if not h.dirty_since:
            h.dirty_since = time.monotonic()
        self._lat_sample(doc_idx, msg.timestamp)
        if h.boot_counting:
            self.counters.bump("boot_replay_len")
        if doc_idx in self.quarantine:
            # Serviceable while quarantined: validated oracle apply (a
            # malformed op drops, counted); the log keeps the tail.
            self._oracle_apply_validated(self.quarantine[doc_idx], h, msg)
            if self.recovery != "off":
                h.log.append(msg)
            return
        if doc_idx in self.oracles:
            # Oracle-routed docs never replay again: no log retained.
            self._oracle_apply_validated(self.oracles[doc_idx], h, msg)
            return
        if self.recovery != "off":
            h.log.append(msg)
        try:
            rows = self._encode(h, msg)
        except NotImplementedError:
            # Legal-but-unsupported wire form: loud, and never applied, so
            # it leaves the replay log.
            if h.log and h.log[-1] is msg:
                h.log.pop()
            h.ops_since_ckpt -= 1
            raise
        except (ValueError, KeyError, TypeError) as e:
            if self.recovery == "off":
                raise  # no retained log to rebuild from: surface it
            # Decode failure: malformed for THIS doc only.
            self._quarantine_doc(doc_idx, f"decode: {e}")
            return
        self.counters.bump("ops_staged", len(rows))
        if doc_idx in self.overflow:
            self.overflow[doc_idx].queue.extend_rows(rows)
            return
        h.queue.extend_rows(rows)
        if h.queue:
            self._busy.add(doc_idx)

    def _encode(self, h: _DocHost, msg) -> list[tuple[np.ndarray, np.ndarray]]:
        """Wire message -> kernel op rows (+payloads)."""
        c = msg.contents
        kind = c["type"]
        client = h.quorum[msg.client_id]
        empty = np.zeros((self.max_insert_len,), np.int32)
        if kind == DeltaType.INSERT:
            if not isinstance(c["seg"], str):
                # Marker/annotated specs are legal wire forms this engine
                # cannot encode yet: a loud feature gap, never poison.
                raise NotImplementedError(
                    "engine supports plain-text insert segs only; got "
                    f"{type(c['seg']).__name__}"
                )
            return mk.encode_insert(
                c["pos1"], c["seg"], msg.seq, client, msg.ref_seq,
                self.max_insert_len,
            )
        if kind == DeltaType.REMOVE:
            op = np.array(
                [mk.OpKind.REMOVE, msg.seq, client, msg.ref_seq,
                 c["pos1"], c["pos2"], 0, 0],
                np.int32,
            )
            return [(op, empty)]
        if kind == DeltaType.ANNOTATE:
            out = []
            for prop, value in c["props"].items():
                slot = self._prop_slot_for(h, int(prop))
                out.append((
                    np.array(
                        [mk.OpKind.ANNOTATE, msg.seq, client, msg.ref_seq,
                         c["pos1"], c["pos2"], slot, value],
                        np.int32,
                    ),
                    empty,
                ))
            return out
        if kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
            p1, s1, p2, s2 = decode_obliterate_places(c)
            return [(
                mk.encode_obliterate(p1, s1, p2, s2, msg.seq, client, msg.ref_seq),
                empty,
            )]
        raise ValueError(f"unsupported op type {kind}")

    @staticmethod
    def _oracle_apply(tree: RefMergeTree, h: _DocHost, msg: SequencedMessage) -> None:
        """Apply one wire OP message to a host oracle replica."""
        c = msg.contents
        kind = c["type"]
        client = h.quorum[msg.client_id]
        if kind == DeltaType.INSERT:
            tree.apply_insert(c["pos1"], c["seg"], msg.seq, client, msg.ref_seq)
        elif kind == DeltaType.REMOVE:
            tree.apply_remove(c["pos1"], c["pos2"], msg.seq, client, msg.ref_seq)
        elif kind == DeltaType.ANNOTATE:
            for prop, value in c["props"].items():
                tree.apply_annotate(
                    c["pos1"], c["pos2"], int(prop), value,
                    msg.seq, client, msg.ref_seq,
                )
        elif kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
            p1, s1, p2, s2 = decode_obliterate_places(c)
            tree.apply_obliterate(p1, s1, p2, s2, msg.seq, client, msg.ref_seq)
        else:
            raise ValueError(f"unsupported op type {kind}")

    def _prop_slot_for(self, h: _DocHost, prop: int) -> int:
        """Intern a property id to a kernel prop slot (range-checked)."""
        return self._prop_slot_for_geom(h, prop, self.geometry)

    def _prop_slot_for_geom(self, h: _DocHost, prop: int, geom: dict) -> int:
        """Intern a property id against ``geom``'s prop slots (live
        encoding and replay-base restores share one table)."""
        if prop not in h.prop_slot:
            slot = len(h.prop_slot)
            if slot >= geom["prop_slots"]:
                raise ValueError(
                    f"document exhausted its {geom['prop_slots']} prop slots; "
                    f"raise prop_slots to accommodate prop id {prop}"
                )
            h.prop_slot[prop] = slot
        return h.prop_slot[prop]

    # -------------------------------------------------------- batched ingest
    def ingest_batch(self, doc_idxs, msgs) -> int:
        """Flight-recorded entry over ``_ingest_batch`` (the ``ingest``
        phase of a trace).  Holds ``ckpt_lock``, so a checkpoint sweep only
        sees whole-batch boundaries."""
        with self.ckpt_lock, span("ingest", msgs=len(doc_idxs)):
            return self._ingest_batch(doc_idxs, msgs)

    def _ingest_batch(self, doc_idxs, msgs) -> int:
        """Columnar ingest: decode a whole wire batch into [N, OP_FIELDS] op
        rows and payload rows with vectorized numpy and land them in the
        per-doc RowQueues as block copies.  Python touches each message for
        routing and bookkeeping only.

        Byte-identical to ``ingest`` per message:

        - JOINs, non-OP messages, quarantined / oracle / overflow docs and
          native-mode docs take the per-message path (counted in
          ``ingest_fallback_msgs``);
        - a decode error quarantines only the offending doc: its earlier
          batch rows are dropped from the scatter (they rode the retained
          log into the quarantine replay) and its later messages route
          through the validated oracle;
        - an out-of-int32 scalar raises OverflowError after the earlier
          messages' rows land; a non-string insert seg raises
          NotImplementedError with the message unwound from the log.

        Returns the op-row count landed through the batch path."""
        L = self.max_insert_len
        counters = self.counters
        total = 0
        doc_of: list[int] = []  # row id -> doc
        # Per-kind columnar collectors; row ids are reserved in walk order
        # so each doc's mixed-kind stream keeps its order.
        i_start: list[int] = []
        i_nch: list[int] = []
        i_pos: list[int] = []
        i_txt: list[str] = []
        i_key: list[int] = []
        i_cli: list[int] = []
        i_ref: list[int] = []
        s_id: list[int] = []  # single-row ops: global row ids
        s_row: list[tuple[int, int, int, int, int, int, int, int]] = []
        o_id: list[int] = []  # obliterates (vectorized encoder columns)
        o_col: tuple[list[int], ...] = ([], [], [], [], [], [], [])
        pending_raise: BaseException | None = None
        for d, msg in zip(doc_idxs, msgs):
            h = self.hosts[d]
            if (
                msg.type != MessageType.OP
                or d in self.quarantine
                or d in self.oracles
                or d in self.overflow
                or h.mode == "native"
            ):
                counters.bump("ingest_fallback_msgs")
                self.ingest(d, msg)
                continue
            if h.mode is None:
                h.mode = "obj"
            h.min_seq = max(h.min_seq, msg.min_seq)
            if h.base_seq and msg.seq <= h.base_seq:
                counters.bump("checkpointed_ops_skipped")
                continue
            h.last_seq = max(h.last_seq, msg.seq)
            h.ops_since_ckpt += 1
            if not h.dirty_since:
                h.dirty_since = time.monotonic()
            self._lat_sample(d, msg.timestamp)
            if h.boot_counting:
                counters.bump("boot_replay_len")
            if self.recovery != "off":
                h.log.append(msg)
            try:
                c = msg.contents
                kind = c["type"]
                client = h.quorum[msg.client_id]
                if kind == DeltaType.INSERT:
                    seg = c["seg"]
                    if not isinstance(seg, str):
                        # Legal-but-unsupported wire form: loud, never
                        # applied — the same unwinding as ``_ingest_one``.
                        if h.log and h.log[-1] is msg:
                            h.log.pop()
                        h.ops_since_ckpt -= 1
                        pending_raise = NotImplementedError(
                            "engine supports plain-text insert segs only; "
                            f"got {type(seg).__name__}"
                        )
                        break
                    # Every _i32 coercion completes before any collector
                    # append: a malformed scalar raises inside this try
                    # (per-doc quarantine), an out-of-int32 one raises
                    # OverflowError, and a partial append would misalign
                    # the collectors for the whole-batch scatter.
                    pos = _i32(c["pos1"])
                    nch = -(-len(seg) // L)
                    i_start.append(total)
                    i_nch.append(nch)
                    i_pos.append(pos)
                    i_txt.append(seg)
                    i_key.append(_i32(msg.seq))
                    i_cli.append(client)
                    i_ref.append(_i32(msg.ref_seq))
                    doc_of.extend([d] * nch)
                    total += nch
                elif kind == DeltaType.REMOVE:
                    row = (
                        mk.OpKind.REMOVE, _i32(msg.seq), client,
                        _i32(msg.ref_seq), _i32(c["pos1"]), _i32(c["pos2"]),
                        0, 0,
                    )
                    s_id.append(total)
                    s_row.append(row)
                    doc_of.append(d)
                    total += 1
                elif kind == DeltaType.ANNOTATE:
                    seq32, ref32 = _i32(msg.seq), _i32(msg.ref_seq)
                    p1, p2 = _i32(c["pos1"]), _i32(c["pos2"])
                    # Every prop coerces before any append: a failure in
                    # the middle lands nothing for the message.
                    prop_rows = [
                        (self._prop_slot_for(h, int(prop)), _i32(value))
                        for prop, value in c["props"].items()
                    ]
                    for slot, value in prop_rows:
                        s_id.append(total)
                        s_row.append((
                            mk.OpKind.ANNOTATE, seq32, client,
                            ref32, p1, p2, slot, value,
                        ))
                        doc_of.append(d)
                        total += 1
                elif kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
                    places = decode_obliterate_places(c)
                    vals = tuple(
                        _i32(v) for v in (*places, msg.seq, client, msg.ref_seq)
                    )
                    o_id.append(total)
                    for col, v in zip(o_col, vals):
                        col.append(v)
                    doc_of.append(d)
                    total += 1
                else:
                    raise ValueError(f"unsupported op type {kind}")
            except OverflowError as e:
                # Not a quarantine class on the per-message path either:
                # land the earlier messages' rows, then surface it.
                pending_raise = e
                break
            except (ValueError, KeyError, TypeError) as e:
                if self.recovery == "off":
                    pending_raise = e
                    break
                # Decode failure: poison for THIS doc only.
                self._quarantine_doc(d, f"decode: {e}")
        staged = self._scatter_batch_rows(
            total, doc_of, i_start, i_nch, i_pos, i_txt, i_key, i_cli,
            i_ref, s_id, s_row, o_id, o_col,
        )
        if pending_raise is not None:
            raise pending_raise
        return staged

    def _scatter_batch_rows(
        self, total, doc_of, i_start, i_nch, i_pos, i_txt, i_key, i_cli,
        i_ref, s_id, s_row, o_id, o_col,
    ) -> int:
        """Materialize the collected batch rows (vectorized) and land them
        per doc as block copies; rows of docs that left the device path in
        the middle of the batch are dropped (their ops rode the log into
        the lane replay)."""
        if not total:
            return 0
        ops_all = np.zeros((total, mk.OP_FIELDS), np.int32)
        pay_all = np.zeros((total, self.max_insert_len), np.int32)
        if i_txt:
            ops_i, pay_i, _owner = mk.encode_insert_batch(
                np.asarray(i_pos, np.int64), i_txt,
                np.asarray(i_key, np.int64), np.asarray(i_cli, np.int64),
                np.asarray(i_ref, np.int64), self.max_insert_len,
            )
            nch = np.asarray(i_nch, np.int64)
            m = int(nch.sum())
            row0 = np.concatenate(([0], np.cumsum(nch)[:-1]))
            ids = np.repeat(np.asarray(i_start, np.int64), nch) + (
                np.arange(m) - np.repeat(row0, nch)
            )
            ops_all[ids] = ops_i
            pay_all[ids] = pay_i
        if s_row:
            ops_all[np.asarray(s_id, np.int64)] = np.asarray(s_row, np.int32)
        if o_id:
            ops_all[np.asarray(o_id, np.int64)] = mk.encode_obliterate_batch(
                *(np.asarray(col, np.int64) for col in o_col)
            )
        doc_arr = np.asarray(doc_of, np.int64)
        live = np.ones((total,), bool)
        for d in set(doc_of):
            if d in self.quarantine or d in self.oracles or d in self.overflow:
                live[doc_arr == d] = False
        # Stable doc sort: one extend_block per doc, original order kept.
        order = np.argsort(doc_arr, kind="stable")
        order = order[live[order]]
        staged = int(order.size)
        if not staged:
            return 0
        sorted_docs = doc_arr[order]
        cuts = np.flatnonzero(np.diff(sorted_docs)) + 1
        for seg in np.split(order, cuts):
            d = int(doc_arr[seg[0]])
            self.hosts[d].queue.extend_block(ops_all[seg], pay_all[seg])
            self._busy.add(d)
        self.counters.bump("ops_staged", staged)
        self.counters.bump("ingest_batch_rows", staged)
        return staged

    # --------------------------------------------------------- native ingest
    def _in_lane(self, doc_idx: int) -> bool:
        """True when the doc left the lockstep batch (or was restored from
        a checkpoint): its ingest consumes parsed messages.  A live native
        doc that merely checkpointed stays on the C++ path."""
        return (
            doc_idx in self.oracles
            or doc_idx in self.overflow
            or doc_idx in self.quarantine
            or self.hosts[doc_idx].restored
        )

    def ingest_lines(self, doc_idx: int, data: bytes) -> int:
        """Stage newline-separated wire JSON through the native encoder
        (``native/ingest.cpp``): the whole decode and encode runs in C++.
        Returns the op rows staged (the op count, for oracle and quarantine
        docs).  Falls back to the Python decode (through ``ingest_batch``)
        when the library is not built, and for docs in a recovery lane or
        restored from a checkpoint.  A healthy doc stays on the path that
        fed it first (the two paths intern prop slots independently);
        routing to a lane moves a native doc onto the object path."""
        with self.ckpt_lock:
            return self._ingest_lines(doc_idx, data)

    def _ingest_lines(self, doc_idx: int, data: bytes) -> int:
        # loaded(), never warm(): this runs under ckpt_lock.
        h = self.hosts[doc_idx]
        if self._in_lane(doc_idx) or not ingest_native.loaded():
            self._normalize_native(h)
            lane = self.overflow.get(doc_idx)
            before = len(lane.queue) if lane else len(h.queue)
            msgs = [
                SequencedMessage.from_json(line.decode())
                for line in data.split(b"\n")
                if line.strip()
            ]
            n_msgs = sum(m.type == MessageType.OP for m in msgs)
            self.ingest_batch([doc_idx] * len(msgs), msgs)
            if doc_idx in self.oracles or doc_idx in self.quarantine:
                return n_msgs
            lane = self.overflow.get(doc_idx)
            return (len(lane.queue) if lane else len(h.queue)) - before
        assert h.mode != "obj", (
            f"doc {doc_idx} already fed through the object path; "
            "pick one ingest path per document"
        )
        if h.native is None:
            h.native = ingest_native.NativeIngestEncoder(
                self.max_insert_len, self.geometry["prop_slots"]
            )
            h.mode = "native"
        with span("ingest", doc=doc_idx, bytes=len(data)):
            ops, payloads = h.native.encode(data)
            if self.recovery != "off":
                h.raw_log.append(data)
            h.queue.extend_block(ops, payloads)
        if len(ops):
            # One latency sample per chunk (the C++ decode exposes no wire
            # timestamps): stamp 0.0 is receipt time.
            self._lat_sample(doc_idx, 0.0, force=True)
            self.counters.bump("ops_staged", len(ops))
        if h.queue:
            self._busy.add(doc_idx)
        h.min_seq = max(h.min_seq, h.native.min_seq)
        h.ops_since_ckpt += len(ops)
        if len(ops) and not h.dirty_since:
            h.dirty_since = time.monotonic()
        if self.checkpoint_store is not None:
            # Checkpoints need the seq floor: the chunk's last line carries
            # the chunk's highest seq (lines are seq-ordered).
            tail_line = data.rstrip(b"\n").rsplit(b"\n", 1)[-1]
            if tail_line.strip():
                try:
                    h.last_seq = max(
                        h.last_seq, int(json.loads(tail_line)["sequenceNumber"])
                    )
                except (ValueError, KeyError):
                    pass
        return len(ops)

    def _normalize_native(self, h: _DocHost) -> None:
        """Move a native-path doc onto the object path: parse the retained
        raw lines into quorum + message log, PREPENDED (they precede
        anything the object path appended later), so recovery replay,
        oracle takeover and further ingest share one stream and one
        prop-slot interning order."""
        if not h.raw_log:
            if h.mode == "native":
                h.mode = "obj"
                h.native = None
            return
        prefix: list[SequencedMessage] = []
        for chunk in h.raw_log:
            for line in chunk.split(b"\n"):
                if line.strip():
                    m = SequencedMessage.from_json(line.decode())
                    if m.type == MessageType.JOIN:
                        h.quorum[m.contents["clientId"]] = m.contents["short"]
                    elif m.type == MessageType.OP and m.seq > h.base_seq:
                        prefix.append(m)
                        h.last_seq = max(h.last_seq, m.seq)
        h.raw_log.clear()
        h.log[:0] = prefix
        h.mode = "obj"
        h.native = None

    def _sync_native_props(self, h: _DocHost) -> None:
        """Fold the native encoder's prop-interning table into the host
        table, so checkpoints and views of native-mode docs carry the real
        property ids.  No-op for object-path docs; both tables intern in
        first-seen stream order, so entries agree."""
        if h.native is None:
            return
        for prop, slot in h.native.prop_table().items():
            cur = h.prop_slot.setdefault(prop, slot)
            if cur != slot:
                raise RuntimeError(
                    f"native/host prop table skew: id {prop} -> {slot} vs {cur}"
                )

    @staticmethod
    def _truncate_raw_log(raw_log: list[bytes], base_seq: int) -> list[bytes]:
        """Drop raw OP lines the checkpoint covers.  JOIN lines stay
        whatever their seq: a later replay rebuilds the quorum from them
        (``_normalize_native``), and a native doc's record carries no
        parsed quorum to fall back on."""
        kept: list[bytes] = []
        for chunk in raw_log:
            lines = []
            for line in chunk.split(b"\n"):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    if (
                        rec.get("type") == MessageType.JOIN
                        or int(rec.get("sequenceNumber", 0)) > base_seq
                    ):
                        lines.append(line)
                except ValueError:
                    lines.append(line)
            if lines:
                kept.append(b"\n".join(lines) + b"\n")
        return kept

    # ------------------------------------------------------------- op latency
    def _lat_sample(self, doc_idx: int, stamp: float, force: bool = False) -> None:
        """Maybe sample one staged op's latency: keep its sequencer stamp
        (wall clock; 0.0 = unstamped, which falls back to receipt time) to
        resolve at the end of the next ``step``.  Every
        ``latency_sample_every``-th op, so the feed pays one increment."""
        self._lat_tick += 1
        if not force and self._lat_tick % self.latency_sample_every:
            return
        if len(self._lat_pending) < 4096:  # bound a step-starved feed
            self._lat_pending.append((stamp if stamp > 0 else time.time(), doc_idx))

    def _lat_flush(self) -> None:
        """Resolve pending latency samples at the end of ``step`` (after
        the error readback, which waits for the dispatches, unless recovery
        is off) into the fleet and per-doc histograms."""
        if not self._lat_pending:
            return
        now = time.time()
        for stamp, d in self._lat_pending:
            lat = max(0.0, now - stamp)
            self.op_latency.record(lat)
            if 0 <= d < self.n_docs:
                h = self._doc_latency.get(d)
                if h is None:
                    h = self._doc_latency[d] = Histogram()
                h.record(lat)
        self._lat_pending.clear()

    def latency_histograms(self) -> dict[str, Histogram]:
        """Mergeable histograms for the metrics plane: op latency and the
        per-incident recovery time (one device: no per-shard entries)."""
        return {
            "op_latency": self.op_latency,
            "recovery_time": self.recovery_tracker.histogram,
        }

    def doc_latency(self, doc_idx: int) -> Histogram | None:
        return self._doc_latency.get(doc_idx)

    def flush_telemetry(self) -> None:
        """Drain residual sampled-telemetry buckets (status snapshot or
        shutdown): tail samples below ``sample_every`` reach the sink."""
        if self.sampled is not None:
            self.sampled.flush_all()

    # --------------------------------------------------------- flow control
    def pending_ops(self) -> int:
        return sum(len(h.queue) for h in self.hosts) + sum(
            len(ln.queue) for ln in self.overflow.values()
        )

    def update_overload(self) -> tuple[list[int], list[int]]:
        """Advance the ingest watermark hysteresis: -> (docs newly over the
        high watermark, docs drained under the low one).  Overflow-lane docs
        queue on their lane, so the gate reads the combined depth."""
        return self.overload_gate.update(
            self._busy | set(self.overflow), self._queue_depth
        )

    def ingest_watermarks(self) -> dict:
        """The flow-control numbers: one megastep retires
        ``megastep_budget`` rows a doc; pause at ``high``, resume at
        ``low``."""
        return self.overload_gate.watermarks(self.megastep_k * self.ops_per_step)

    @property
    def overloaded(self) -> bool:
        return bool(self.overload_gate.paused)

    # ------------------------------------------------------------------- step
    def _drain_into(self, docs: list[int], ops: np.ndarray,
                    payloads: np.ndarray) -> list[int]:
        """Dequeue up to ops_per_step rows per listed doc into its row of
        the zeroed staging slice (two slice copies per doc); returns the
        rows written."""
        B = self.ops_per_step
        written: list[int] = []
        for d in docs:
            h = self.hosts[d]
            take = min(B, len(h.queue))
            if not take:
                continue
            src_ops, src_payloads = h.queue.take(take)
            ops[d, :take] = src_ops
            payloads[d, :take] = src_payloads
            if not h.queue:
                self._busy.discard(d)
            written.append(d)
        return written

    def _staging(self) -> StagingRing:
        if self._stage is None:
            self._stage = StagingRing(
                self.megastep_k, self.capacity, self.ops_per_step,
                mk.OP_FIELDS, self.max_insert_len, self.device,
            )
        return self._stage

    @staticmethod
    def _pow2_floor(n: int) -> int:
        return 1 << (max(n, 1).bit_length() - 1)

    def _select_k(self, busy: list[int]) -> int:
        """Megastep depth from queue depths: the deepest queue's slice
        count, capped at ``megastep_k`` and quantized to a power of two."""
        if self.megastep_k <= 1:
            return 1
        B = self.ops_per_step
        need = max(-(-len(self.hosts[d].queue) // B) for d in busy)
        return min(self.megastep_k, self._pow2_floor(need))

    def _full_step(self, busy: list[int]) -> int:
        """One fleet-wide megastep of up to K slices; returns K."""
        K = self._select_k(busy)
        stage = self._staging()
        ops, payloads = stage.acquire(K, self.capacity)
        for k in range(K):
            stage.mark(k, self._drain_into(busy, ops[k], payloads[k]))
            busy = [d for d in busy if d in self._busy]
        kinds = ops[..., 0].copy()  # host-side op kinds: branch selection
        dev_ops, dev_payloads = stage.upload(ops, payloads)
        syncs = mk.apply_megastep.ob_gate_syncs
        with span("dispatch", kind="full", k=K, shards=1):
            self.state = self._megastep(self.state, dev_ops, dev_payloads, kinds=kinds)
        self.counters.bump("ob_gate_syncs", mk.apply_megastep.ob_gate_syncs - syncs)
        self.counters.bump("megastep_dispatches")
        self.counters.bump("megastep_slices", K)
        return K

    def step(self) -> int:
        """Run megasteps until all staged ops are applied (batch and
        overflow lanes); returns the number of [D, B] slices applied.  Then,
        unless recovery is off, recover every latched doc (``errors()`` is
        all zero on return), run the watchdog and readmissions when due,
        and write the cadence checkpoints (after ``ckpt_lock`` releases)."""
        with self.ckpt_lock:
            had_work = bool(
                self._busy or any(ln.queue for ln in self.overflow.values())
            )
            steps = self._step_fleet()
            if had_work and self.recovery_tracker.active:
                self.recovery_tracker.complete()
        self.maybe_checkpoint()
        return steps

    def _step_fleet(self) -> int:
        t0 = time.perf_counter() if self.sampled is not None else 0.0
        steps = 0
        while self._busy:
            steps += self._full_step(sorted(self._busy))
        self._step_lanes()
        self._step_count += 1
        if self.recovery != "off":
            self.recover()
            self._steps_since_watchdog += 1
            if (
                self.watchdog_every
                and self._steps_since_watchdog >= self.watchdog_every
            ):
                self._steps_since_watchdog = 0
                self.watchdog()
            if self.readmit_after_steps:
                self._maybe_readmit()
        # Resolve the latency samples (after recover()'s readback waited for
        # the dispatches, unless recovery is off) and feed the sampled step
        # timing when a telemetry sink is attached.
        self._lat_flush()
        if self.sampled is not None:
            self.sampled.record(time.perf_counter() - t0, "step")
        return steps

    def _lane_apply(self, state: mk.DocState, rows_ops: np.ndarray,
                    rows_payloads: np.ndarray) -> mk.DocState:
        """Apply up to B op rows to a one-document lane state (zero-padded
        to one [1, B] slice, as the reference stages a lane chunk)."""
        B = self.ops_per_step
        ops = np.zeros((1, B, mk.OP_FIELDS), np.int32)
        payloads = np.zeros((1, B, self.max_insert_len), np.int32)
        ops[0, : len(rows_ops)] = rows_ops
        payloads[0, : len(rows_payloads)] = rows_payloads
        return mk.apply_ops(state, ops, payloads)

    def _step_lanes(self) -> None:
        B = self.ops_per_step
        for lane in self.overflow.values():
            while lane.queue:
                src_ops, src_payloads = lane.queue.take(min(B, len(lane.queue)))
                lane.state = self._lane_apply(lane.state, src_ops, src_payloads)

    def _maybe_readmit(self) -> None:
        """Backoff-scheduled quarantine readmission."""
        for d, due_step in list(self._readmit_due.items()):
            if self._step_count < due_step or d not in self.quarantine:
                if d not in self.quarantine:
                    self._readmit_due.pop(d, None)
                continue
            if self.readmit(d):
                self.counters.bump("auto_readmissions")
            else:
                # The state no longer fits the batch geometry: double the
                # backoff and retry later (still serviceable meanwhile).
                interval = min(
                    2 * self._readmit_interval.get(d, self.readmit_after_steps),
                    self.readmit_after_steps << 16,
                )
                self._readmit_interval[d] = interval
                self._readmit_due[d] = self._step_count + interval

    def compact(self) -> None:
        """Advance MSNs and run zamboni eviction across the fleet, its
        overflow lanes and its host oracles."""
        mins = np.array([h.min_seq for h in self.hosts], np.int32)
        self.state = self._compact(
            self.state, self._pm.shard_docs(torch.from_numpy(mins), self.mesh)
        )
        for d, lane in self.overflow.items():
            lane.state = _fleet_compact_body(
                lane.state, np.asarray([self.hosts[d].min_seq], np.int32)
            )
        for d, tree in self.oracles.items():
            tree.update_min_seq(self.hosts[d].min_seq)
        for d, tree in self.quarantine.items():
            tree.update_min_seq(self.hosts[d].min_seq)

    # --------------------------------------------------------------- recovery
    def recover(self) -> list[int]:
        """Recover every flagged doc; returns the doc indices recovered.
        One scalar read of the batch's error count per call (the error
        vector is read only when it is nonzero) and one read of the
        overflow lanes' error scalars.  Capacity bits grow-and-replay (or
        oracle-route); poison bits (ERR_POS_RANGE alone) quarantine."""
        recovered: list[int] = []
        with span("readback", kind="error_count"):
            batch_dirty = self.error_count()
        if batch_dirty:
            with span("readback", kind="error_vector"):
                err = self.state.error.cpu().numpy().copy()
            for d in np.flatnonzero(err).tolist():
                if d in self.overflow or d in self.oracles or d in self.quarantine:
                    continue
                bits = int(err[d])
                if mk.is_capacity_error(bits):
                    self._recover_doc(d, bits, growths=0)
                else:  # poison: ERR_POS_RANGE with no capacity bit
                    self._quarantine_doc(d, f"error bits {bits:#x}")
                # Retire the batch row's latch: future ops route to the lane.
                self.state.error[d] = 0
                recovered.append(d)
        if self.overflow:
            lanes = list(self.overflow.items())
            lane_bits = torch.cat([ln.state.error for _, ln in lanes]).tolist()
            for (d, lane), bits in zip(lanes, lane_bits):
                if bits:
                    if mk.is_capacity_error(bits):
                        self._recover_doc(d, bits, growths=lane.growths)
                    else:
                        self._quarantine_doc(d, f"error bits {bits:#x}")
                    recovered.append(d)
        if recovered:
            self.counters.emit(recovered_docs=len(recovered))
        return recovered

    def _make_lane(self, state: mk.DocState, geometry: dict[str, int],
                   growths: int) -> _OverflowLane:
        return _OverflowLane(
            state, geometry, growths, RowQueue(mk.OP_FIELDS, self.max_insert_len)
        )

    def _recover_doc(self, d: int, bits: int, growths: int) -> None:
        # Recovery works on the parsed-message log: fold a native doc's raw
        # lines in first (they precede any object-path appends).
        self._normalize_native(self.hosts[d])
        h = self.hosts[d]
        geom = dict(
            self.overflow[d].geometry if d in self.overflow else self.geometry
        )
        while self.recovery == "grow" and growths < self.max_growths:
            growths += 1
            geom = self._grown_geometry(geom, bits)
            if h.base_summary is not None:
                # The replay base must fit before a single op applies.
                geom = self._fit_geometry(geom, h.base_summary, len(h.prop_slot))
            state = self._replay(h, geom)
            new_bits = int(state.error[0])
            if new_bits == 0:
                self.overflow[d] = self._make_lane(state, geom, growths)
                self.counters.bump("capacity_recoveries")
                return
            bits = new_bits
            if mk.is_poison_error(bits):
                # POS_RANGE surviving replay at grown capacity: the op
                # stream itself is malformed.
                self._quarantine_doc(
                    d, f"error bits {bits:#x} during replay at {geom}"
                )
                return
        # Growth exhausted (or policy is oracle): the host replica takes over.
        self.overflow.pop(d, None)
        tree = self._oracle_from_base(h)
        for msg in h.log:
            self._oracle_apply(tree, h, msg)
        tree.update_min_seq(h.min_seq)
        self.oracles[d] = tree
        self.counters.bump("oracle_routes")

    @staticmethod
    def _grown_geometry(base: dict[str, int], bits: int) -> dict[str, int]:
        geom = dict(base)
        if bits & mk.ERR_SEG_OVERFLOW:
            geom["max_segments"] *= 2
        if bits & mk.ERR_TEXT_OVERFLOW:
            geom["text_capacity"] *= 2
        if bits & mk.ERR_REM_OVERFLOW:
            geom["remove_slots"] *= 2
        if bits & mk.ERR_OB_OVERFLOW:
            geom["ob_slots"] *= 2
        return geom

    @staticmethod
    def _fit_geometry(
        geom: dict[str, int], summary: dict, min_prop_slots: int = 0
    ) -> dict[str, int]:
        """Grow ``geom`` (doubling) until the checkpoint summary fits — a
        replay base must never itself overflow.  ``min_prop_slots`` covers
        the slots the doc's prop table already interned."""
        geom = dict(geom)
        n_seg = len(summary["segments"])
        n_text = sum(len(e["text"]) for e in summary["segments"])
        n_rem = max((len(e["removes"]) for e in summary["segments"]), default=0)
        n_ob = len(summary.get("obliterates", []))
        while geom["max_segments"] < n_seg:
            geom["max_segments"] *= 2
        while geom["text_capacity"] < n_text:
            geom["text_capacity"] *= 2
        while geom["remove_slots"] < n_rem:
            geom["remove_slots"] *= 2
        while geom["ob_slots"] < n_ob:
            geom["ob_slots"] *= 2
        while geom["prop_slots"] < min_prop_slots:
            geom["prop_slots"] *= 2
        return geom

    def _replay(self, h: _DocHost, geom: dict[str, int]) -> mk.DocState:
        """Re-apply the retained wire log on a one-document state with
        ``geom`` on the engine's device — from the checkpoint base when
        one exists (bounded replay), from scratch otherwise."""
        if h.base_summary is not None:
            state = kb.summary_to_state(
                h.base_summary, geom,
                lambda p: self._prop_slot_for_geom(h, p, geom), device=self.device,
            )
        else:
            state = mk.init_state(
                geom["max_segments"], geom["remove_slots"], geom["prop_slots"],
                geom["text_capacity"], geom["ob_slots"], device=self.device,
            )
        state = mk.batch_state(state, 1)
        rows: list[tuple[np.ndarray, np.ndarray]] = []
        for msg in h.log:
            rows.extend(self._encode(h, msg))
        self.counters.gauge("recovery_replay_len", len(h.log))
        B = self.ops_per_step
        for i in range(0, len(rows), B):
            chunk = rows[i : i + B]
            state = self._lane_apply(
                state, np.stack([op for op, _ in chunk]),
                np.stack([payload for _, payload in chunk]),
            )
        return state

    # ------------------------------------------------------------- quarantine
    def _oracle_from_base(self, h: _DocHost) -> RefMergeTree:
        """A host oracle seeded with the doc's checkpoint base (or empty)."""
        tree = RefMergeTree()
        if h.base_summary is not None:
            tree.import_summary(h.base_summary)
        return tree

    def _oracle_apply_validated(
        self, tree: RefMergeTree, h: _DocHost, msg: SequencedMessage
    ) -> bool:
        """Apply one wire op to a quarantine oracle behind a validation
        gate: positions must resolve inside the op's own perspective and
        the sender must be in the quorum.  A malformed op is dropped and
        counted — it can corrupt neither this replica nor the batch."""
        try:
            c = msg.contents
            client = h.quorum[msg.client_id]  # KeyError: unknown sender
            n = tree.visible_length(msg.ref_seq, client)
            kind = c["type"]
            if kind == DeltaType.INSERT:
                if not isinstance(c["seg"], str):
                    raise NotImplementedError(
                        f"unsupported seg spec {type(c['seg']).__name__}"
                    )
                if not (0 <= c["pos1"] <= n):
                    raise ValueError(f"insert pos {c['pos1']} > length {n}")
            elif kind in (DeltaType.REMOVE, DeltaType.ANNOTATE):
                if not (0 <= c["pos1"] < c["pos2"] <= n):
                    raise ValueError(
                        f"range [{c['pos1']},{c['pos2']}) outside length {n}"
                    )
            elif kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
                p1, s1, p2, s2 = decode_obliterate_places(c)
                validate_obliterate_places(p1, s1, p2, s2, n)
            self._oracle_apply(tree, h, msg)
            return True
        except NotImplementedError:
            raise  # feature gap, not poison: stay loud
        except Exception as e:  # noqa: BLE001 — the gate IS the handler
            self.counters.bump("poison_ops_dropped")
            if self.counters.logger is not None:
                self.counters.logger.error("poison_op_dropped", e, seq=msg.seq)
            return False

    def _quarantine_doc(self, d: int, reason: str) -> None:
        """Evict one doc from the device batch into the validated host
        oracle lane: checkpoint base + validated replay of the retained
        tail (malformed ops drop).  The rest of the batch is untouched."""
        h = self.hosts[d]
        self._normalize_native(h)
        tree = self._oracle_from_base(h)
        self.counters.gauge("quarantine_replay_len", len(h.log))
        for msg in h.log:
            self._oracle_apply_validated(tree, h, msg)
        tree.update_min_seq(h.min_seq)
        self.overflow.pop(d, None)
        flaps = self._flaps[d] = self._flaps.get(d, 0) + 1
        if self.poison_budget and flaps > self.poison_budget:
            # Flapping: route to the oracle lane permanently (serviceable,
            # never auto-readmitted).
            self.quarantine.pop(d, None)
            self.quarantine_reason.pop(d, None)
            self._readmit_due.pop(d, None)
            self._readmit_interval.pop(d, None)
            self.oracles[d] = tree
            self.counters.bump("poison_routed_docs")
            if self.counters.logger is not None:
                self.counters.logger.error(
                    "doc_poison_routed", reason, doc=self.doc_keys[d], flaps=flaps,
                )
        else:
            self.quarantine[d] = tree
            self.quarantine_reason[d] = reason
            if self.readmit_after_steps:
                # Exponential backoff: 1 flap -> base, 2 -> 2x, 3 -> 4x...
                interval = self.readmit_after_steps << min(flaps - 1, 16)
                self._readmit_interval[d] = interval
                self._readmit_due[d] = self._step_count + interval
        h.queue.clear()
        self._busy.discard(d)
        self.state.error[d] = 0
        self.counters.bump("quarantines")
        if self.counters.logger is not None:
            self.counters.logger.error("doc_quarantined", reason, doc=self.doc_keys[d])

    def _put_row(self, d: int, row: mk.DocState) -> None:
        """Write a one-document state (tensors or numpy) into batch row d."""
        for x, y in zip(mk.leaves(self.state), mk.leaves(row)):
            x[d] = torch.as_tensor(y).to(x.device)

    def readmit(self, d: int) -> bool:
        """Re-admit a quarantined doc to the lockstep batch: pack the
        oracle's (validated) state at the batch geometry into the doc's
        row.  Returns False — the doc stays quarantined — when the state no
        longer fits the batch geometry."""
        tree = self.quarantine.get(d)
        if tree is None:
            return False
        h = self.hosts[d]
        summary = tree.export_summary()
        try:
            row = kb.summary_to_state_host(
                summary, self.geometry,
                lambda p: self._prop_slot_for_geom(h, p, self.geometry),
            )
        except (ValueError, IndexError):
            return False
        self._put_row(d, row)
        del self.quarantine[d]
        self.quarantine_reason.pop(d, None)
        self._readmit_due.pop(d, None)
        self._readmit_interval.pop(d, None)
        # Fresh device truth: the watchdog re-verifies it next sweep.
        self._verified_digest.pop(d, None)
        # The oracle state becomes the new replay base: the dropped poison
        # ops are gone from both the state and the log.
        h.base_summary = summary
        h.base_seq = max(h.base_seq, h.last_seq)
        h.log = [m for m in h.log if m.seq > h.base_seq]
        self.counters.bump("readmissions")
        return True

    def migrate_doc(self, d: int, dst_shard: int) -> bool:
        raise NotImplementedError("doc migration is not ported yet")

    def enable_segment_sharding(self, d: int, s_local: int = 0,
                                text_capacity: int = 0) -> bool:
        raise NotImplementedError("engine-promoted segment lanes are not ported yet")

    # ------------------------------------------------ boot adoption, warmup
    def adopt_boot_snapshot(self, doc_idx: int, record: dict) -> placement.AdoptResult:
        """Client half of the fan-out plane's ``{"t":"resync","boot":true}``
        contract (``placement.adopt_boot_snapshot`` over this engine's
        refresh re-seed path): a consumer that fell off the retained log
        re-seeds the document from a historian snapshot record (the scribe
        summary schema, ``engine: doc_batch``) and re-consumes from the
        returned floor; lanes, quorum, prop tables and the replay floor all
        reset consistently."""
        return placement.adopt_boot_snapshot(self, doc_idx, record, self._clear_staged)

    def _clear_staged(self, doc_idx: int) -> None:
        """Drop a doc's staged pre-gap work ahead of a boot-snapshot
        adoption: the refresh guard refuses docs with pending ops
        (trailing must not race serving), but a boot resync REPLACES the
        doc — pre-gap rows are covered by the snapshot."""
        self.hosts[doc_idx].queue.clear()
        lane = self.overflow.get(doc_idx)
        if lane is not None:
            lane.queue.clear()
        self._busy.discard(doc_idx)

    def warmup(self) -> int:
        """Warm the fleet's serving programs (warm-standby boot): dispatch
        all-NOOP megasteps at K=1, every power of two up to ``megastep_k``
        and a non-power-of-two ``megastep_k`` itself (``_select_k`` clamps
        to it), plus one compact, through the serving entry points.  On the
        card this loads the CUDA kernel library and makes each program's
        first launch, so lazy module loading and allocator growth happen
        before promotion, not on the first real step.  NOOP slices are
        identity by kernel contract and the compact's result is dropped, so
        the state bytes are untouched.
        Returns the number of warmup dispatches (the reference's count: the
        port compiles nothing, so there is no recompile poll)."""
        warmed = 0
        with self.ckpt_lock, span("warmup", k_max=self.megastep_k):
            if self.device.type == "cuda":
                from ..ops import cuda_build

                cuda_build.load()
            stage = self._staging()
            for k in warmup_depths(self.megastep_k):
                ops, payloads = stage.acquire(k, self.capacity)
                kinds = ops[..., 0].copy()
                dev_ops, dev_payloads = stage.upload(ops, payloads)
                self.state = self._megastep(self.state, dev_ops, dev_payloads, kinds=kinds)
                warmed += 1
            # The compact program's first launch runs on the live state and
            # its result is dropped: a warmup never compacts a serving fleet
            # (the reference's keeps it, which changes a fleet whose MSN
            # moved since its last compact).
            mins = np.array([h.min_seq for h in self.hosts], np.int32)
            self._compact(self.state, self._pm.shard_docs(torch.from_numpy(mins), self.mesh))
            warmed += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.counters.gauge("warmup_dispatches", warmed)
        return warmed

    # --------------------------------------------------------------- watchdog
    def watchdog(self, sample: int | None = None) -> list[int]:
        """Cross-check a rotating sample of batch docs against a host-oracle
        replay of checkpoint + tail; quarantine (the oracle wins) on
        mismatch.  Returns the doc indices that failed the check."""
        if self.recovery == "off":
            return []
        eligible = [
            d for d in range(self.n_docs)
            if not (
                d in self.overflow or d in self.oracles or d in self.quarantine
            )
            and self.hosts[d].mode == "obj"
            and not self.hosts[d].queue
        ]
        if not eligible:
            return []
        # Device-digest pre-filter: one digest of the fleet per sweep (one
        # device-to-host read).  A doc whose digest AND ingested seq both
        # match its last passed check is skipped (counted).
        digests = fleet_digest(self.state).cpu().tolist()
        drifted = []
        for d in eligible:
            if self._verified_digest.get(d) == (digests[d], self.hosts[d].last_seq):
                self.counters.bump("watchdog_prefiltered")
            else:
                drifted.append(d)
        eligible = drifted
        if not eligible:
            return []
        k = sample if sample is not None else self.watchdog_sample
        start = self._watchdog_cursor
        picks = [
            eligible[(start + i) % len(eligible)]
            for i in range(min(k, len(eligible)))
        ]
        self._watchdog_cursor = (start + len(picks)) % max(len(eligible), 1)
        failed: list[int] = []
        for d in picks:
            h = self.hosts[d]
            try:
                tree = self._oracle_from_base(h)
                for msg in h.log:
                    self._oracle_apply(tree, h, msg)
                expected = tree.visible_text()
            except Exception:  # noqa: BLE001 — a log the strict path rejects
                self._quarantine_doc(d, "watchdog: oracle replay failed")
                failed.append(d)
                continue
            self.counters.bump("watchdog_checks")
            if mk.visible_text(self.doc_state(d)) != expected:
                self.counters.bump("watchdog_mismatches")
                self._quarantine_doc(d, "watchdog: device/oracle divergence")
                failed.append(d)
            else:
                # Passed: pin (digest, seq) until the row or stream moves.
                self._verified_digest[d] = (digests[d], self.hosts[d].last_seq)
        return failed

    # ------------------------------------------------------------- checkpoint
    def maybe_checkpoint(self, force: bool = False, docs=None) -> list[int]:
        """Write durable checkpoint records for docs whose op count since
        the last checkpoint reached ``checkpoint_every`` (every dirty doc
        when ``force``; ``docs`` restricts the sweep to an explicit list,
        checkpointed whenever dirty), then truncate their replay logs to
        the tail.  The records are built under ``ckpt_lock`` and written
        after it is released.  Returns the doc indices checkpointed."""
        if self.checkpoint_store is None:
            return []
        if docs is None and not force and self.checkpoint_every <= 0:
            return []
        with self.ckpt_lock, span("checkpoint_sweep", docs=self.n_docs):
            out, pending = self._checkpoint_sweep(force, docs)
        write_checkpoint_records(self, pending)
        return out

    def checkpoint_stale(
        self, max_ops_behind: int = 0, max_seconds_behind: float = 0.0
    ) -> list[int]:
        """Bounded-staleness sweep: checkpoint every dirty doc whose
        durable record is ``max_ops_behind`` applied ops or
        ``max_seconds_behind`` seconds behind the live stream (0 disables
        that bound).  Returns the doc indices checkpointed."""
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
        """Build-and-account half of a checkpoint sweep (under
        ``ckpt_lock``); the returned records are written after release."""
        candidates = range(self.n_docs) if docs is None else docs
        due = [
            d for d in candidates
            if self.hosts[d].ops_since_ckpt > 0
            and (
                force or docs is not None
                or self.hosts[d].ops_since_ckpt >= self.checkpoint_every
            )
        ]
        if not due:
            return [], []  # host-side check only: no device read paid
        out: list[int] = []
        pending: list[tuple[int, int, dict]] = []
        # ONE bulk device-to-host copy of the fleet state covers every due
        # batch doc; the per-doc summary walks then slice host arrays.
        host_state = (
            mk.to_numpy(self.state)
            if any(
                d not in self.quarantine
                and d not in self.oracles
                and d not in self.overflow
                for d in due
            )
            else None
        )
        for d in due:
            h = self.hosts[d]
            if h.queue or (d in self.overflow and self.overflow[d].queue):
                continue  # staged-but-unapplied ops: state is mid-step
            lane = "batch"
            geometry = None
            prop_names = {v: k for k, v in h.prop_slot.items()}
            if d in self.quarantine:
                lane = "quarantine"
                summary = self.quarantine[d].export_summary()
            elif d in self.oracles:
                lane = "oracle"
                summary = self.oracles[d].export_summary()
            elif d in self.overflow:
                lane = "overflow"
                ln = self.overflow[d]
                row = mk.to_numpy(mk.doc_row(ln.state, 0))
                if int(row.error):
                    continue
                geometry = ln.geometry
                growths = ln.growths
                summary = kb.state_to_summary(row, prop_names)
            else:
                row = mk.tree_map(lambda x, _d=d: x[_d], host_state)
                if int(row.error):
                    continue  # never checkpoint a poisoned row
                self._sync_native_props(h)
                prop_names = {v: k for k, v in h.prop_slot.items()}
                summary = kb.state_to_summary(row, prop_names)
            record = {
                "engine": "doc_batch",
                "lane": lane,
                "summary": summary,
                "quorum": h.quorum,
                "prop_slot": {str(k): v for k, v in h.prop_slot.items()},
                "min_seq": h.min_seq,
                "mode": h.mode,
            }
            if geometry is not None:
                record["geometry"] = geometry
                record["growths"] = growths
            pending.append((d, h.last_seq, record))
            h.base_seq = h.last_seq
            h.base_summary = summary
            h.log = [m for m in h.log if m.seq > h.base_seq]
            if h.raw_log:
                h.raw_log = self._truncate_raw_log(h.raw_log, h.base_seq)
            h.ops_since_ckpt = 0
            h.dirty_since = 0.0
            h.boot_counting = False  # a new durable floor ends the boot phase
            self.counters.bump("checkpoints_written")
            out.append(d)
        return out, pending

    def _queue_depth(self, d: int) -> int:
        """Staged-but-unapplied rows of doc ``d`` (batch queue + lane)."""
        lane = self.overflow.get(d)
        return len(self.hosts[d].queue) + (len(lane.queue) if lane else 0)

    def note_incident(self, started_at: float) -> None:
        """Back-date the current recovery incident to the supervisor's
        kill timestamp (``time.monotonic`` domain): the recovery histogram
        then measures kill -> first post-restore op applied, not merely
        restore -> applied."""
        self.recovery_tracker.begin(started_at)

    def restore_from_checkpoints(
        self,
        store=None,
        parallel: bool = True,
        max_workers: int | None = None,
        refresh: bool = False,
    ) -> list[int]:
        """Engine restart path: load each doc's durable checkpoint record,
        rebuild its state (batch row, overflow lane, or oracle/quarantine
        replica) and set the seq floor so the upstream replay of ops the
        checkpoint already covers is skipped.  Returns restored doc
        indices.

        ``parallel`` (default) loads the records concurrently and seeds
        every batch-lane doc with one host stack and one ``index_copy_``
        per state leaf; ``parallel=False`` loads and writes doc by doc —
        the same state.  ``refresh`` re-adopts, for already-restored docs
        with no staged work, a record strictly newer than their floor."""
        store = store if store is not None else self.checkpoint_store
        if store is None:
            return []
        with self.ckpt_lock:
            return self._restore(store, parallel, max_workers, refresh)

    def _restore(self, store, parallel, max_workers, refresh) -> list[int]:
        t_start = time.monotonic()
        with span("restore_scan", docs=self.n_docs):
            candidates, cand_mtime = placement.restore_candidates(
                self, store, refresh, self._queue_depth
            )
        if not candidates:
            return []
        records = load_checkpoint_records(
            store, [self.doc_keys[d] for d in candidates],
            parallel=parallel, max_workers=max_workers,
        )
        restored: list[int] = []
        batch_rows: list[tuple[int, mk.DocState]] = []
        with span("restore_build", records=len(records)):
            for i, d in enumerate(candidates):
                rec = records.get(i)
                if rec is not None and d in cand_mtime:
                    self._trail_mtime[d] = cand_mtime[d]
                if rec is None or rec.get("engine") != "doc_batch":
                    continue
                h = self.hosts[d]
                if refresh and h.restored:
                    if int(rec["seq"]) <= h.last_seq:
                        continue  # nothing newer to adopt
                    self.counters.bump("checkpoint_refreshes")
                if refresh:
                    self._drop_restored_identity(d)
                h.quorum = dict(rec.get("quorum", {}))
                h.prop_slot = {int(k): v for k, v in rec.get("prop_slot", {}).items()}
                h.min_seq = rec.get("min_seq", 0)
                h.base_seq = h.last_seq = int(rec["seq"])
                h.base_summary = rec["summary"]
                h.mode = "obj"
                h.restored = True
                h.boot_counting = True
                lane = rec.get("lane", "batch")
                if lane in ("oracle", "quarantine"):
                    tree = RefMergeTree()
                    tree.import_summary(rec["summary"])
                    tree.update_min_seq(h.min_seq)
                    if lane == "oracle":
                        self.oracles[d] = tree
                    else:
                        self.quarantine[d] = tree
                        self.quarantine_reason[d] = "restored"
                        if self.readmit_after_steps:
                            # Schedule readmission like a first flap.
                            self._flaps.setdefault(d, 1)
                            self._readmit_interval[d] = self.readmit_after_steps
                            self._readmit_due[d] = (
                                self._step_count + self.readmit_after_steps
                            )
                elif lane == "overflow":
                    geom = {k: int(v) for k, v in rec["geometry"].items()}
                    self.overflow[d] = self._make_lane(
                        self._lane_state(rec["summary"], h, geom), geom,
                        int(rec.get("growths", 1)),
                    )
                else:
                    try:
                        row = kb.summary_to_state_host(
                            rec["summary"], self.geometry,
                            lambda p, _h=h: self._prop_slot_for_geom(
                                _h, p, self.geometry
                            ),
                        )
                    except (ValueError, IndexError):
                        # The record outgrew the batch geometry (a restart with
                        # smaller capacity): an overflow lane at a fitted one.
                        geom = self._fit_geometry(
                            self.geometry, rec["summary"], len(h.prop_slot)
                        )
                        self.overflow[d] = self._make_lane(
                            self._lane_state(rec["summary"], h, geom), geom, 1
                        )
                    else:
                        if parallel:
                            batch_rows.append((d, row))
                        else:
                            self._put_row(d, row)
                restored.append(d)
                self.counters.bump("docs_restored")
        if batch_rows:
            with span("restore_scatter", rows=len(batch_rows)):
                self._scatter_rows(
                    [d for d, _ in batch_rows],
                    mk.tree_map(lambda *xs: np.stack(xs), *[r for _, r in batch_rows]),
                )
        if restored and not refresh:
            # A real restore opens a recovery incident: the clock runs until
            # the first post-restore op applies.
            self.recovery_tracker.begin(t_start)
        return restored

    def _scatter_rows(self, docs: list[int], stacked: mk.DocState) -> None:
        """The parallel restore's scatter: host rows stacked [n, ...] (numpy)
        into the batch rows ``docs`` — one host-to-device copy and one
        ``index_copy_`` per state leaf."""
        idx = torch.tensor(docs, device=self.device)
        for x, y in zip(mk.leaves(self.state), mk.leaves(stacked)):
            x.index_copy_(0, idx, torch.from_numpy(y).to(x.device))

    def _lane_state(self, summary: dict, h: _DocHost, geom: dict) -> mk.DocState:
        """A summary packed at ``geom`` as an overflow lane's state."""
        return mk.batch_state(
            kb.summary_to_state(
                summary, geom, lambda p: self._prop_slot_for_geom(h, p, geom),
                device=self.device,
            ),
            1,
        )

    def _drop_restored_identity(self, d: int) -> None:
        """Forget a doc's prior adoption before a refresh re-seed (the doc
        has no staged work by contract)."""
        self.overflow.pop(d, None)
        self.oracles.pop(d, None)
        self.quarantine.pop(d, None)
        self.quarantine_reason.pop(d, None)
        self._readmit_due.pop(d, None)
        self._readmit_interval.pop(d, None)
        self._verified_digest.pop(d, None)
        h = self.hosts[d]
        h.log.clear()
        h.raw_log.clear()
        h.queue.clear()
        self._busy.discard(d)

    # ------------------------------------------------------------------ views
    def error_count(self) -> int:
        """Batch docs with a latched error bit (one scalar read)."""
        return self._pm.error_count(self.state.error)

    def health(self) -> dict:
        """Degraded-mode health counters: the engine's counters and gauges,
        the overload gate, the sampled op latency, the recovery clock, and
        the lane and checkpoint surfaces.  The reference's ``recompiles``
        and ``despecializations`` are left out: they count XLA executable
        growth, and the port compiles nothing at run time."""
        self.counters.gauge("megastep_k", self.megastep_k)
        self.counters.gauge(
            "staging_overlap_packs",
            self._stage.overlapped_packs if self._stage is not None else 0,
        )
        self.counters.ratio(
            "steps_per_dispatch", "megastep_slices", "megastep_dispatches"
        )
        self.overload_gate.emit_gauges(
            self.counters, self.megastep_k * self.ops_per_step,
            max(
                (self._queue_depth(d) for d in self._busy | set(self.overflow)),
                default=0,
            ),
        )
        self.counters.gauge("n_shards", 1)
        # Sampled op latency (sequencer stamp -> end of the applying step),
        # ms percentiles.  No ``recompiles`` / ``despecializations``: the
        # port compiles nothing at run time, so there is nothing to count.
        self.counters.gauge("latency_samples", self.op_latency.count)
        if self.op_latency.count:
            self.counters.gauge(
                "latency_p50_ms", round(self.op_latency.percentile(0.5) * 1e3, 3)
            )
            self.counters.gauge(
                "latency_p99_ms", round(self.op_latency.percentile(0.99) * 1e3, 3)
            )
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
            quarantined_docs=len(self.quarantine),
            overflow_docs=len(self.overflow),
            oracle_docs=len(self.oracles),
            checkpoint_age_seqs=max(
                (h.last_seq - h.base_seq for h in self.hosts if h.last_seq),
                default=0,
            ),
            retained_log_msgs=sum(len(h.log) for h in self.hosts),
            quarantine_flaps=sum(self._flaps.values()),
            readmits_scheduled=len(self._readmit_due),
        )
        return snap

    def doc_state(self, doc_idx: int) -> mk.DocState:
        """A doc's one-document state: its overflow lane's, else its batch
        row (views)."""
        if doc_idx in self.overflow:
            return mk.doc_row(self.overflow[doc_idx].state, 0)
        return mk.doc_row(self.state, doc_idx)

    def text(self, doc_idx: int) -> str:
        if doc_idx in self.quarantine:
            return self.quarantine[doc_idx].visible_text()
        if doc_idx in self.oracles:
            return self.oracles[doc_idx].visible_text()
        return mk.visible_text(self.doc_state(doc_idx))

    def annotations(self, doc_idx: int) -> list[dict[int, int]]:
        if doc_idx in self.quarantine:
            return self.quarantine[doc_idx].annotations()
        if doc_idx in self.oracles:
            return self.oracles[doc_idx].annotations()
        raw = mk.annotations(self.doc_state(doc_idx))
        # Live native-path docs intern props in C++: fold the table in so
        # the view names real prop ids.
        self._sync_native_props(self.hosts[doc_idx])
        inv = {v: k for k, v in self.hosts[doc_idx].prop_slot.items()}
        return [{inv[p]: v for p, v in d.items()} for d in raw]

    def errors(self) -> np.ndarray:
        """Per-doc error vector across batch and overflow lanes.  Oracle
        and quarantined docs read 0: they are isolated and serviceable —
        their degraded state surfaces through ``health()``."""
        err = self.state.error.cpu().numpy().copy()
        for d, lane in self.overflow.items():
            err[d] = int(lane.state.error[0])
        for d in self.oracles:
            err[d] = 0
        for d in self.quarantine:
            err[d] = 0
        return err
