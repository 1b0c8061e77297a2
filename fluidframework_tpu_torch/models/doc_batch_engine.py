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

Placement (``mesh``, ``spare_slots``): the engine owns a
``placement.PlacementPlane``; a doc's state row is its slot (``_slot``),
the fleet state has ``capacity`` rows (the fleet rounded up to a shard
multiple plus the spare slots), a shard is a contiguous block of
``docs_per_shard`` rows, and the fleet programs are one launch over every
row.  ``migrate_doc`` moves a doc's row to another shard's free slot
through the checkpoint codec; ``rebalance_hot_shards`` migrates off shards
loaded past ``factor`` x the mean, or promotes a doc that is itself the
hotspot to a segment lane.

Segment lanes (``seg_shards > 1``): ``enable_segment_sharding`` re-blocks a
hot doc's row over the mesh's ``segs`` axis and serves it with
``apply_megastep_seg`` (K6 over n shards, K1 inside); its batch slot stays
reserved.  ``rebalance_segments`` re-blocks, ``disable_segment_sharding``
demotes.

Cohort steps (``use_mesh=False``): with no mesh, a busy set at or below a
quarter of the fleet steps as a gathered power-of-two cohort
(``_cohort_step``) instead of a fleet-wide megastep.

Rank mesh (``mesh=parallel.mesh.rank_mesh(...)``: one process a card over
``torch.distributed``): every rank builds the same engine and ingests the
whole stream, so the host state (queues, logs, quorum, lanes, placement,
counters) is the same on every rank; each rank's state holds only its own
shard's rows.  Each rank packs the whole staging ring, uploads its rows'
slice and applies K2 and K3 once on its rows, its obliterate gate read
from its own rows (the reference's per-shard gate).  Overflow lanes and
the host oracles are replicated (every rank replays them); a segment lane
holds the rank's block, its collectives over the rank's ``segs`` group.
A read of one doc's row is a broadcast from the rank that owns it, a
fleet-wide figure a reduction over the group; each rank writes the
checkpoint files of the docs it owns and restores its own rows.  The
public methods are collective there: every rank calls them in the same
order, from one thread (the background checkpoint writer and a warm
standby are refused).  No collective runs under ``ckpt_lock``: the
collective parts run with it released and the mesh raises on one that
does not.
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
from ..device import DEFAULT_DEVICE, count_launch, resolve_device
from ..ops import mergetree_kernel as mk
from ..native import ingest_native
from ..observability.flight_recorder import instant, span
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
    mark_write_failures,
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


class _SegmentLane:
    """A hot document promoted to the segment-parallel serving path: its
    merge-tree segment columns block-shard over the mesh's ``segs`` axis
    (the stacked state of ``mk.seg_stack``: per-segment work splits across
    shards; text, scalars and obliterate table replicate), served by
    ``mk.apply_megastep_seg`` with the single lane as the byte-identity
    oracle.  Inserts land shard-local; the layout re-blocks at rebalance
    points (``rebalance_segments``)."""

    __slots__ = ("state", "n_shards", "s_local", "queue", "rebalances",
                 "ops_since_rebalance", "version")

    def __init__(self, state: mk.DocState, n_shards: int, s_local: int,
                 queue: RowQueue) -> None:
        self.state = state
        self.n_shards = n_shards
        self.s_local = s_local
        self.queue = queue
        self.rebalances = 0
        self.ops_since_rebalance = 0
        # Bumped at every state reassignment (dispatch, rebalance, compact):
        # the watchdog's change mark for a lane doc, whose slot digest is
        # the pristine reserved row.
        self.version = 0


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


def gather_cohort(state: mk.DocState, idx: np.ndarray) -> mk.DocState:
    """A cohort's state rows (``idx[Kc]`` slots, pad lanes repeating a busy
    slot) as a [Kc, ...] sub-fleet: the reference's ``_gather_cohort_jit``,
    one ``index_select`` per leaf."""
    count_launch(state.nseg, gather_cohort)
    idx_t = torch.as_tensor(idx, dtype=torch.int64).to(state.nseg.device)
    return mk.tree_map(lambda x: x.index_select(0, idx_t), state)


def scatter_cohort(state: mk.DocState, sub: mk.DocState, idx: np.ndarray,
                   valid: np.ndarray) -> mk.DocState:
    """Write a stepped cohort back into its slots, in place: the reference's
    ``_scatter_cohort_jit``, a masked ``index_copy_`` per leaf.  Pad lanes
    (``valid`` false, host-side) are dropped, never written, so no slot is
    written twice."""
    count_launch(state.nseg, scatter_cohort)
    rows = np.flatnonzero(valid)
    dev = state.nseg.device
    rows_t = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    slots_t = torch.as_tensor(np.asarray(idx)[rows], dtype=torch.int64).to(dev)
    for x, y in zip(mk.leaves(state), mk.leaves(sub)):
        x.index_copy_(0, slots_t, y.index_select(0, rows_t))
    return state


def scatter_rows(state: mk.DocState, slots: list[int], stacked: mk.DocState) -> None:
    """The parallel restore's scatter (``DocBatchEngine._restore``):
    host rows stacked [n, ...] (numpy) into the state rows ``slots``, in
    place — one host-to-device copy and one ``index_copy_`` per state leaf."""
    count_launch(state.nseg, scatter_rows)
    idx = torch.tensor(slots, device=state.nseg.device)
    for x, y in zip(mk.leaves(state), mk.leaves(stacked)):
        x.index_copy_(0, idx, torch.from_numpy(y).to(x.device))


gather_cohort.launches = 0
scatter_cohort.launches = 0
scatter_rows.launches = 0


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
        mesh=None,
        use_mesh: bool = True,
        spare_slots: int = 0,
        seg_shards: int = 0,
        seg_lane_segments: int = 0,
        seg_lane_text_capacity: int = 0,
        seg_rebalance_every: int = 0,
        max_seg_lanes: int = 4,
        device=DEFAULT_DEVICE,
    ) -> None:
        if recovery not in ("grow", "oracle", "off"):
            raise ValueError(f"recovery={recovery!r}: expected grow, oracle or off")
        if mesh is not None:
            # The mesh's device serves the engine; ``device`` may only
            # repeat it.
            if device != DEFAULT_DEVICE and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.n_docs = n_docs
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
        if use_mesh:
            if mesh is not None:
                self.mesh = mesh
            elif seg_shards > 1:
                # The 2-D docs x segs serving mesh, one shard per segment
                # shard on the engine's device: cold docs shard over both
                # axes flattened, hot docs carve the segs axis.
                self.mesh = pm.docs_segs_mesh([self.device] * seg_shards, seg_shards)
            else:
                self.mesh = pm.doc_mesh(self.device)
            n_shards = self.mesh.n_shards
            self.seg_shards = self.mesh.seg_shards
        else:
            self.mesh = None
            n_shards = 1
            self.seg_shards = 1
        # Segment-lane knobs (hot-doc opt-in; see _SegmentLane).
        self.seg_lanes: dict[int, _SegmentLane] = {}
        self.seg_lane_segments = seg_lane_segments
        self.seg_lane_text_capacity = seg_lane_text_capacity
        self.seg_rebalance_every = seg_rebalance_every
        self.max_seg_lanes = max_seg_lanes
        self.n_shards = n_shards
        self._shard_latency = [Histogram() for _ in range(n_shards)]
        # Row placement rides the shared plane (models/placement.py): doc ->
        # slot indirection with per-shard spare-slot free pools.  ``_slot``
        # aliases the plane's live array for the staging packs.
        self.placement_plane = placement.PlacementPlane(n_docs, n_shards, spare_slots)
        self.capacity = self.placement_plane.capacity
        self.docs_per_shard = self.placement_plane.docs_per_shard
        self._slot = self.placement_plane.slots
        # Per-shard applied-op counters (host-side), accumulated at drain
        # time: the hot-shard detection signal.
        self._shard_ops = np.zeros((n_shards,), np.int64)
        proto = mk.init_state(
            max_segments, remove_slots, prop_slots, text_capacity, ob_slots,
            device=self.device,
        )
        self._proto = proto  # pristine row: retires vacated and reserved slots
        # Where the fleet state lives: the mesh, or one shard on the device.
        self._fleet_mesh = self.mesh if self.mesh is not None else pm.doc_mesh(self.device)
        # A rank mesh: this rank holds slots [lo, hi) (``_rows``) and no
        # collective may run under ckpt_lock.
        self._ranked = bool(getattr(self._fleet_mesh, "ranked", False))
        self._rows = (
            self._fleet_mesh.row_range(self.capacity) if self._ranked else (0, self.capacity)
        )
        if self._ranked:
            self._fleet_mesh.forbid_collectives_under(self.ckpt_lock)
            self.state = mk.batch_state(proto, self._rows[1] - self._rows[0])
        else:
            self.state = pm.shard_fleet_state(
                mk.batch_state(proto, self.capacity), self._fleet_mesh
            )
        # The fleet programs: one launch over every slot of every shard.
        self._megastep = pm.mesh_fleet_program(mk.apply_megastep, self._fleet_mesh)
        self._compact = pm.mesh_fleet_program(_fleet_compact_body, self._fleet_mesh)
        self._seg_megastep = self._seg_compact = None
        if self.seg_shards > 1:
            # A plane without segment-lane programs (the native plane)
            # raises NotImplementedError here: the engine serves every doc
            # on the fleet path and counts the downgrade, never silently.
            try:
                seg_specs = pm.seg_state_specs(proto)
                self._seg_megastep = pm.mesh_seg_program(mk.apply_megastep_seg, self.mesh,
                                                         seg_specs)
                self._seg_compact = pm.mesh_seg_program(mk.compact_seg, self.mesh, seg_specs)
            except NotImplementedError:
                self._seg_megastep = self._seg_compact = None
                self.seg_shards = 1
                self.counters.bump("seg_plane_unsupported")
        # Docs with a nonempty host queue, maintained by ingest and drain.
        self._busy: set[int] = set()
        self._stage: StagingRing | None = None
        # Zipf straggler bucketing: with no mesh, a busy set of at most a
        # quarter of the fleet gathers its rows into a power-of-two cohort,
        # steps it, and scatters the rows back (pad lanes dropped).  Under
        # a mesh every megastep runs fleet-wide, as the reference's does.
        self.bucketing = self.mesh is None
        # Fleet-wide slices whose obliterate gate opened on this process's
        # rows (on a rank mesh, its own shard's: the per-shard gate).
        self.ob_gate_opens = 0
        self.full_steps = 0     # fleet-wide slices applied
        self.cohort_steps = 0   # bucketed slices applied
        self.cohort_lanes = 0   # sum of cohort sizes (work proxy)

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
        if doc_idx in self.seg_lanes:
            self.seg_lanes[doc_idx].queue.extend_rows(rows)
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

        - JOINs, non-OP messages, quarantined / oracle / overflow /
          segment-lane docs and native-mode docs take the per-message path
          (counted in ``ingest_fallback_msgs``);
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
                or d in self.seg_lanes
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
            if (
                d in self.quarantine or d in self.oracles
                or d in self.overflow or d in self.seg_lanes
            ):
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
            or doc_idx in self.seg_lanes
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
            lane = self.overflow.get(doc_idx) or self.seg_lanes.get(doc_idx)
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
            lane = self.overflow.get(doc_idx) or self.seg_lanes.get(doc_idx)
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
                self._shard_latency[self.shard_of(d)].record(lat)
                h = self._doc_latency.get(d)
                if h is None:
                    h = self._doc_latency[d] = Histogram()
                h.record(lat)
        self._lat_pending.clear()

    def latency_histograms(self) -> dict[str, Histogram]:
        """Mergeable histograms for the metrics plane: op latency, one per
        shard on a multi-shard mesh, and the per-incident recovery time."""
        out = {
            "op_latency": self.op_latency,
            "recovery_time": self.recovery_tracker.histogram,
        }
        if self.n_shards > 1:
            for s, h in enumerate(self._shard_latency):
                out[f"op_latency_shard{s}"] = h
        return out

    def doc_latency(self, doc_idx: int) -> Histogram | None:
        return self._doc_latency.get(doc_idx)

    def flush_telemetry(self) -> None:
        """Drain residual sampled-telemetry buckets (status snapshot or
        shutdown): tail samples below ``sample_every`` reach the sink."""
        if self.sampled is not None:
            self.sampled.flush_all()

    # --------------------------------------------------------- flow control
    def pending_ops(self) -> int:
        return (
            sum(len(h.queue) for h in self.hosts)
            + sum(len(ln.queue) for ln in self.overflow.values())
            + sum(len(ln.queue) for ln in self.seg_lanes.values())
        )

    def update_overload(self) -> tuple[list[int], list[int]]:
        """Advance the ingest watermark hysteresis: -> (docs newly over the
        high watermark, docs drained under the low one).  Lane docs
        (overflow or segment) queue on their lane, so the gate reads the
        combined depth."""
        return self.overload_gate.update(
            self._busy | set(self.seg_lanes) | set(self.overflow), self._queue_depth
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
    def _drain_into(self, docs: list[int], ops: np.ndarray, payloads: np.ndarray,
                    rows: list[int] | None = None, slots: bool = False) -> list[int]:
        """Dequeue up to ops_per_step rows per listed doc into the zeroed
        staging slice (``docs[j]`` fills row ``rows[j]``, default ``j``; two
        slice copies per doc) — the one drain of full-fleet and cohort
        packing.  ``slots``: the rows are device slots, so the ops count
        toward their shard's load.  Returns the rows written."""
        B = self.ops_per_step
        written: list[int] = []
        for j, d in enumerate(docs):
            h = self.hosts[d]
            take = min(B, len(h.queue))
            if not take:
                continue
            r = j if rows is None else rows[j]
            src_ops, src_payloads = h.queue.take(take)
            ops[r, :take] = src_ops
            payloads[r, :take] = src_payloads
            if slots:
                self._shard_ops[r // self.docs_per_shard] += take
            if not h.queue:
                self._busy.discard(d)
            written.append(r)
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

    def _select_k(self, busy: list[int], cohort: bool = False) -> int:
        """Megastep depth from queue depths: how many B-row slices fuse into
        the next dispatch, capped at ``megastep_k`` and quantized to a power
        of two.  Cohort-aware: a full-fleet megastep fuses only as many
        slices as the busy set stays above the cohort threshold (the
        (thresh+1)-th deepest queue), so a Zipf tail still collapses into
        gathered cohorts exactly when it would have."""
        if self.megastep_k <= 1:
            return 1
        B = self.ops_per_step
        depths = np.array([-(-len(self.hosts[d].queue) // B) for d in busy], np.int64)
        thresh = self.capacity // 4
        if cohort or not self.bucketing or len(depths) <= thresh:
            need = int(depths.max())
        else:
            # Slices until the busy set shrinks to cohort size: the
            # (thresh+1)-th deepest queue still has rows at slice k iff its
            # depth > k.
            need = int(np.partition(depths, -thresh - 1)[-thresh - 1])
        return min(self.megastep_k, self._pow2_floor(need))

    def _full_step(self, busy: list[int]) -> int:
        """One fleet-wide megastep of up to K slices, packed by placement
        (doc d's rows land in row ``slot(d)``); returns K."""
        K = self._select_k(busy)
        stage = self._staging()
        ops, payloads = stage.acquire(K, self.capacity)
        rows = [int(r) for r in self._slot[busy]]
        for k in range(K):
            stage.mark(k, self._drain_into(busy, ops[k], payloads[k], rows=rows, slots=True))
            if k + 1 < K:
                pairs = [(d, r) for d, r in zip(busy, rows) if d in self._busy]
                busy = [d for d, _ in pairs]
                rows = [r for _, r in pairs]
        # Host-side op kinds (branch selection) of this process's rows: on
        # a rank mesh its own shard's, so its obliterate gate reads only
        # its own rows.
        lo, hi = self._rows
        kinds = ops[:, lo:hi, :, 0].copy()
        dev_ops, dev_payloads = stage.upload(ops, payloads, rows=self._rows)
        syncs = mk.apply_megastep.ob_gate_syncs
        opens = mk.apply_megastep.ob_gate_opens
        with span("dispatch", kind="full", k=K, shards=self.n_shards):
            self.state = self._megastep(self.state, dev_ops, dev_payloads, kinds=kinds)
        self.counters.bump("ob_gate_syncs", mk.apply_megastep.ob_gate_syncs - syncs)
        self.ob_gate_opens += mk.apply_megastep.ob_gate_opens - opens
        self.full_steps += K
        self.counters.bump("megastep_dispatches")
        self.counters.bump("megastep_slices", K)
        return K

    def _cohort_step(self, busy: list[int]) -> int:
        """One bucketed megastep over just the busy docs: gather the
        cohort's state rows once (a power-of-two ladder; pad lanes repeat
        the last busy slot), apply up to K fused [Kc, B] slices, and
        scatter the rows back with the pad lanes dropped.  Returns K."""
        K = self._select_k(busy, cohort=True)
        Kc = max(1, 1 << (len(busy) - 1).bit_length())
        slots = self._slot[busy]
        idx = np.full((Kc,), slots[-1], np.int64)
        idx[: len(busy)] = slots
        valid = np.zeros((Kc,), bool)
        valid[: len(busy)] = True
        stage = self._staging()
        ops, payloads = stage.acquire(K, Kc)
        row_of = {d: j for j, d in enumerate(busy)}
        cur = busy
        for k in range(K):
            stage.mark(k, self._drain_into(cur, ops[k], payloads[k],
                                           rows=[row_of[d] for d in cur]))
            if k + 1 < K:
                cur = [d for d in cur if d in self._busy]
        kinds = ops[..., 0].copy()
        sub = gather_cohort(self.state, idx)
        dev_ops, dev_payloads = stage.upload(ops, payloads)
        syncs = mk.apply_megastep.ob_gate_syncs
        with span("dispatch", kind="cohort", k=K, lanes=Kc):
            sub = self._megastep(sub, dev_ops, dev_payloads, kinds=kinds)
        self.counters.bump("ob_gate_syncs", mk.apply_megastep.ob_gate_syncs - syncs)
        self.state = scatter_cohort(self.state, sub, idx, valid)
        self.cohort_steps += K
        self.cohort_lanes += K * Kc
        self.counters.bump("megastep_dispatches")
        self.counters.bump("megastep_slices", K)
        return K

    def step(self) -> int:
        """Run megasteps until all staged ops are applied (batch, cohort,
        overflow and segment lanes); returns the number of slices applied
        (a K-slice megastep counts K).  Then, unless recovery is off,
        recover every latched doc (``errors()`` is all zero on return), run
        the watchdog and readmissions when due, and write the cadence
        checkpoints (after ``ckpt_lock`` releases).  Collective on a rank
        mesh."""
        if self._ranked:
            return self._step_ranked()
        with self.ckpt_lock:
            had_work = self._had_work()
            steps = self._step_fleet()
            if had_work and self.recovery_tracker.active:
                self.recovery_tracker.complete()
        self.maybe_checkpoint()
        return steps

    def _had_work(self) -> bool:
        return bool(
            self._busy
            or any(ln.queue for ln in self.overflow.values())
            or any(ln.queue for ln in self.seg_lanes.values())
        )

    def _step_ranked(self) -> int:
        """``step`` on a rank mesh: the fleet megasteps and the overflow
        lanes (no collective) under ``ckpt_lock``; the segment lanes, the
        error count, the watchdog and the checkpoint sweep, which run
        collectives, with it released (each takes it for what it mutates)."""
        t0 = time.perf_counter() if self.sampled is not None else 0.0
        with self.ckpt_lock:
            had_work = self._had_work()
            steps = self._step_batch()
        self._step_seg_lanes()
        self._after_step(t0)
        with self.ckpt_lock:
            if had_work and self.recovery_tracker.active:
                self.recovery_tracker.complete()
        self.maybe_checkpoint()
        return steps

    def _step_fleet(self) -> int:
        t0 = time.perf_counter() if self.sampled is not None else 0.0
        steps = self._step_batch()
        self._step_seg_lanes()
        self._after_step(t0)
        return steps

    def _step_batch(self) -> int:
        """The batch's megasteps until no doc has staged rows, then the
        overflow lanes."""
        steps = 0
        while self._busy:
            busy = sorted(self._busy)
            if self.bucketing and len(busy) <= self.capacity // 4:
                steps += self._cohort_step(busy)
            else:
                steps += self._full_step(busy)
        self._step_lanes()
        return steps

    def _after_step(self, t0: float) -> None:
        """Recovery, the watchdog and readmissions when due, then the
        latency samples and the sampled step timing."""
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
                with self.ckpt_lock:
                    self._maybe_readmit()
        # Resolve the latency samples (after recover()'s readback waited for
        # the dispatches, unless recovery is off) and feed the sampled step
        # timing when a telemetry sink is attached.
        self._lat_flush()
        if self.sampled is not None:
            self.sampled.record(time.perf_counter() - t0, "step")

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

    # -------------------------------------------------------- segment lanes
    def _step_seg_lanes(self) -> None:
        """Drain every segment lane with [K, B] seg megasteps, re-blocking
        any lane past its rebalance budget."""
        for d, lane in list(self.seg_lanes.items()):
            self._drain_seg_lane(d, lane)
            if (
                self.seg_rebalance_every
                and lane.ops_since_rebalance >= self.seg_rebalance_every
            ):
                self.rebalance_segments(d)

    def _drain_seg_lane(self, d: int, lane: _SegmentLane) -> None:
        """Apply one lane's staged rows as [K, B] seg megasteps: the ring
        uploads whole (``upload_replicated``: every shard applies every op
        to its own segment block).  The [K, B] buffers are fresh per
        dispatch (tiny next to the dispatch itself)."""
        B = self.ops_per_step
        while lane.queue:
            need = -(-len(lane.queue) // B)
            K = min(self.megastep_k, self._pow2_floor(max(need, 1)))
            ops = np.zeros((K, B, mk.OP_FIELDS), np.int32)
            payloads = np.zeros((K, B, self.max_insert_len), np.int32)
            taken = 0
            for k in range(K):
                take = min(B, len(lane.queue))
                if not take:
                    break
                src_ops, src_payloads = lane.queue.take(take)
                ops[k, :take] = src_ops
                payloads[k, :take] = src_payloads
                taken += take
            kinds = ops[..., 0].copy()
            dev_ops, dev_payloads = self._pm.upload_replicated(ops, payloads, self.mesh)
            with span("dispatch", kind="seg", k=K, doc=self.doc_keys[d],
                      seg_shards=lane.n_shards):
                lane.state = self._seg_megastep(lane.state, dev_ops, dev_payloads,
                                                kinds=kinds)
            lane.version += 1
            lane.ops_since_rebalance += taken
            self.counters.bump("megastep_dispatches")
            self.counters.bump("megastep_slices", K)

    def segment_sharded(self) -> dict[str, int]:
        """doc key -> segment shard count for every promoted hot doc."""
        return {self.doc_keys[d]: lane.n_shards for d, lane in self.seg_lanes.items()}

    def enable_segment_sharding(self, d: int, s_local: int = 0,
                                text_capacity: int = 0) -> bool:
        """Promote a hot doc onto the segment-parallel path (under
        ``ckpt_lock``: the checkpoint sweep reads the lanes).  Collective
        on a rank mesh: the doc's row is broadcast from its rank first."""
        if self._ranked:
            with self.ckpt_lock:
                slot = int(self._slot[d]) if self._promotable(d) else None
            if slot is None:
                return False
            row = mk.to_numpy(self._row(slot))
            with self.ckpt_lock:
                return self._enable_segment_sharding_locked(d, s_local, text_capacity, row)
        with self.ckpt_lock:
            return self._enable_segment_sharding_locked(d, s_local, text_capacity)

    def _promotable(self, d: int) -> bool:
        """The host checks of a promotion (counts a spent lane budget)."""
        if self.seg_shards <= 1 or self._seg_megastep is None:
            return False
        if not (0 <= d < self.n_docs):
            raise ValueError(f"no doc {d}")
        if (
            d in self.seg_lanes or d in self.overflow
            or d in self.oracles or d in self.quarantine
        ):
            return False
        if len(self.seg_lanes) >= self.max_seg_lanes:
            self.counters.bump("seg_promotions_skipped")
            return False
        return True

    def _enable_segment_sharding_locked(self, d: int, s_local: int = 0,
                                        text_capacity: int = 0, row=None) -> bool:
        """The doc's row re-blocks into the seg-sharded layout
        (``mk.seg_shard_state``: live segments in contiguous runs over the
        segs axis, text, scalars and obliterate table replicated) and future
        ops apply segment-parallel.  The batch slot stays reserved (the
        pristine row), so placement is untouched and demotion lands back in
        place.  Staged rows move to the lane queue: promotion is legal
        mid-stream.  Returns False when seg serving is off, the doc is off
        the batch path, the lane budget is spent, or the state does not
        block.  ``row``: the doc's row when the caller read it (a rank
        mesh's broadcast, after the same checks)."""
        if row is None:
            if not self._promotable(d):
                return False
            row = mk.to_numpy(mk.doc_row(self.state, int(self._slot[d])))
        slot = int(self._slot[d])
        if int(row.error):
            return False  # recover first; never promote a latched row
        s_local = s_local or self.seg_lane_segments or self.geometry["max_segments"]
        tc = (
            text_capacity or self.seg_lane_text_capacity
            or self.geometry["text_capacity"]
        )
        try:
            blocked = mk.seg_shard_state(row, self.seg_shards, s_local, tc)
        except (ValueError, NotImplementedError):
            return False
        lane = _SegmentLane(
            self._pm.shard_seg_state(blocked, self.mesh), self.seg_shards, s_local,
            RowQueue(mk.OP_FIELDS, self.max_insert_len),
        )
        h = self.hosts[d]
        if h.queue:
            ops_p, payloads_p = h.queue.pending()
            lane.queue.extend_block(ops_p.copy(), payloads_p.copy())
            h.queue.clear()
        self._busy.discard(d)
        self.seg_lanes[d] = lane
        self._put_row(slot, self._proto)  # retire the row (slot reserved)
        self._verified_digest.pop(d, None)
        self.counters.bump("seg_promotions")
        instant("seg_promote", doc=self.doc_keys[d], shards=self.seg_shards,
                s_local=s_local)
        return True

    def disable_segment_sharding(self, d: int) -> bool:
        """Demote a segment-sharded doc back into its reserved batch row
        (gather, summary export, re-pack at batch geometry).  Staged lane
        rows apply first.  Returns False when the gathered state no longer
        fits the batch geometry (the doc stays on its lane).  Collective on
        a rank mesh: the lane drains and gathers with ``ckpt_lock``
        released."""
        if self._ranked:
            lane = self.seg_lanes.get(d)
            if lane is None:
                return False
            if lane.queue:
                self._drain_seg_lane(d, lane)
            host = mk.seg_unstack(self._lane_host(lane))
            with self.ckpt_lock:
                return self._disable_segment_sharding_locked(d, host)
        with self.ckpt_lock:
            return self._disable_segment_sharding_locked(d)

    def _disable_segment_sharding_locked(self, d: int, host=None) -> bool:
        lane = self.seg_lanes.get(d)
        if lane is None:
            return False
        if host is None:
            if lane.queue:
                self._drain_seg_lane(d, lane)
            host = mk.seg_unstack(mk.to_numpy(lane.state))
        if int(host.error):
            return False  # recover() handles latched lanes
        gathered = mk.seg_gather_state(host)
        h = self.hosts[d]
        self._sync_native_props(h)
        summary = kb.state_to_summary(gathered, {v: k for k, v in h.prop_slot.items()})
        try:
            row = kb.summary_to_state_host(
                summary, self.geometry,
                lambda p: self._prop_slot_for_geom(h, p, self.geometry),
            )
        except (ValueError, IndexError):
            return False
        self._put_row(int(self._slot[d]), row)
        del self.seg_lanes[d]
        self._verified_digest.pop(d, None)
        self.counters.bump("seg_demotions")
        instant("seg_demote", doc=self.doc_keys[d])
        return True

    def rebalance_segments(self, d: int) -> bool:
        """Re-block a segment lane so every shard holds an even share of
        the live segments again (inserts land shard-local, so runs skew
        toward one shard over time): gather and re-shard, byte- and
        order-preserving (``mk.seg_rebalance_state``).  Collective on a
        rank mesh: the lane gathers with ``ckpt_lock`` released."""
        if self._ranked:
            lane = self.seg_lanes.get(d)
            # error is replicated: every rank reads the same latch.
            if lane is None or int(lane.state.error[0]):
                return False
            host = self._lane_host(lane)
            with self.ckpt_lock:
                return self._rebalance_segments_locked(d, host)
        with self.ckpt_lock:
            return self._rebalance_segments_locked(d)

    def _rebalance_segments_locked(self, d: int, host=None) -> bool:
        lane = self.seg_lanes.get(d)
        if lane is None:
            return False
        if int(lane.state.error[0]):
            # One scalar read: a latched lane waits for recover().
            return False
        with span("seg_rebalance", doc=self.doc_keys[d], shards=lane.n_shards):
            if host is None:
                host = mk.to_numpy(lane.state)
            blocked = mk.seg_rebalance_state(host, s_local=lane.s_local)
            lane.state = self._pm.shard_seg_state(blocked, self.mesh)
        lane.version += 1
        lane.rebalances += 1
        lane.ops_since_rebalance = 0
        self.counters.bump("seg_rebalances")
        instant("seg_rebalance", doc=self.doc_keys[d])
        return True

    def _min_seqs(self) -> torch.Tensor:
        """Every slot's MSN floor (docs' at their slots, 0 elsewhere)."""
        mins = np.zeros((self.capacity,), np.int32)
        mins[self._slot] = [h.min_seq for h in self.hosts]
        return self._pm.shard_docs(torch.from_numpy(mins), self._fleet_mesh)

    def compact(self) -> None:
        """Advance MSNs and run zamboni eviction across the fleet, its
        segment and overflow lanes and its host oracles."""
        self.state = self._compact(self.state, self._min_seqs())
        for d, lane in self.seg_lanes.items():
            lane.state = self._seg_compact(lane.state, self.hosts[d].min_seq)
            lane.version += 1
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
        vector is read only when it is nonzero) and one read each of the
        overflow and segment lanes' error scalars.  Capacity bits grow-and-replay (or
        oracle-route); poison bits (ERR_POS_RANGE alone) quarantine.
        Collective on a rank mesh: the count is summed over the ranks and a
        nonzero one gathers the error column, with ``ckpt_lock`` released;
        the recoveries then run under it on every rank alike."""
        with span("readback", kind="error_count"):
            batch_dirty = self.error_count()
        err = None
        if batch_dirty:
            with span("readback", kind="error_vector"):
                err = self._slot_column(self.state.error)[self._slot]  # by doc
        with self.ckpt_lock:
            return self._recover_docs(err)

    def _recover_docs(self, err) -> list[int]:
        """``recover``'s recoveries, given the batch's by-doc error vector
        (None when no batch row latched)."""
        recovered: list[int] = []
        if err is not None:
            for d in np.flatnonzero(err).tolist():
                if d in self.overflow or d in self.oracles or d in self.quarantine:
                    continue
                bits = int(err[d])
                if mk.is_capacity_error(bits):
                    self._recover_doc(d, bits, growths=0)
                else:  # poison: ERR_POS_RANGE with no capacity bit
                    self._quarantine_doc(d, f"error bits {bits:#x}")
                # Retire the batch row's latch: future ops route to the lane.
                self._clear_latch(int(self._slot[d]))
                recovered.append(d)
        if self.overflow:
            # Overflow lanes are replicated on a rank mesh (every rank
            # replays them): every rank reads the same bits.
            lanes = list(self.overflow.items())
            lane_bits = torch.cat([ln.state.error for _, ln in lanes]).tolist()
            for (d, lane), bits in zip(lanes, lane_bits):
                if bits:
                    if mk.is_capacity_error(bits):
                        self._recover_doc(d, bits, growths=lane.growths)
                    else:
                        self._quarantine_doc(d, f"error bits {bits:#x}")
                    recovered.append(d)
        if self.seg_lanes:
            # error is a replicated leaf of a segment lane (psum'd latches).
            lanes = list(self.seg_lanes.items())
            lane_bits = torch.stack([ln.state.error[0] for _, ln in lanes]).tolist()
            for (d, _lane), bits in zip(lanes, lane_bits):
                if bits:
                    # A latched segment lane leaves the seg path: the
                    # retained log replays into an overflow lane (grow) or
                    # quarantine; staged lane rows ride the log.
                    self.seg_lanes.pop(d)
                    if mk.is_capacity_error(bits):
                        self._recover_doc(d, bits, growths=0)
                    else:
                        self._quarantine_doc(d, f"error bits {bits:#x} (seg lane)")
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
        self.seg_lanes.pop(d, None)
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
        self._clear_latch(int(self._slot[d]))
        self.counters.bump("quarantines")
        if self.counters.logger is not None:
            self.counters.logger.error("doc_quarantined", reason, doc=self.doc_keys[d])

    def _put_row(self, slot: int, row: mk.DocState) -> None:
        """Write a one-document state (tensors or numpy) into state row
        ``slot`` (on a rank mesh, only the rank that holds it writes)."""
        lo, hi = self._rows
        if not lo <= slot < hi:
            return
        for x, y in zip(mk.leaves(self.state), mk.leaves(row)):
            x[slot - lo] = torch.as_tensor(y).to(x.device)

    def _clear_latch(self, slot: int) -> None:
        """Zero one slot's error latch (where its row lives)."""
        lo, hi = self._rows
        if lo <= slot < hi:
            self.state.error[slot - lo] = 0

    def _row(self, slot: int) -> mk.DocState:
        """Slot ``slot``'s row as a one-document state on the engine's
        device: views of the state, or on a rank mesh (a collective) a copy
        broadcast from the rank that holds it."""
        if not self._ranked:
            return mk.doc_row(self.state, slot)
        lo, hi = self._rows
        shapes = [x.shape for x in mk.leaves(self._proto)]
        if lo <= slot < hi:
            flat = torch.cat([x[slot - lo].reshape(-1) for x in mk.leaves(self.state)])
        else:
            flat = torch.empty(sum(int(np.prod(sh)) for sh in shapes), dtype=torch.int32,
                               device=self.device)
        flat = self._fleet_mesh.broadcast(flat, slot // self.docs_per_shard)
        parts = iter(torch.split(flat, [int(np.prod(sh)) for sh in shapes]))
        return mk.tree_map(lambda p: next(parts).reshape(p.shape), self._proto)

    def _slot_column(self, col: torch.Tensor) -> np.ndarray:
        """A per-slot column of the fleet state (``[rows]``) as host numpy
        over every slot: on a rank mesh every rank's rows gathered (a
        collective)."""
        if self._ranked:
            col = self._fleet_mesh.gather_rows(col)
        return col.cpu().numpy()

    def _lane_host(self, lane: _SegmentLane) -> mk.DocState:
        """A segment lane's stacked state as host numpy: on a rank mesh the
        rank's ``segs`` row gathered, leaf by leaf (a collective)."""
        if not self._ranked:
            return mk.to_numpy(lane.state)
        g = self._seg_megastep.group
        return mk.to_numpy(mk.tree_map(lambda x: self.mesh.seg_gather(x, g), lane.state))

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
        self._put_row(int(self._slot[d]), row)
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
        """Move doc ``d``'s row to a free slot of shard ``dst_shard``
        (``_migrate_doc_locked``).  Collective on a rank mesh: the row is
        broadcast from the source rank, with ``ckpt_lock`` released, and
        the destination rank writes it."""
        if self._ranked:
            with self.ckpt_lock:
                reservation = self._migration_reserve(d, dst_shard)
            if reservation is None:
                return False
            row = mk.to_numpy(self._row(reservation[0]))
            with self.ckpt_lock:
                return self._migrate_doc_locked(d, dst_shard, reservation, row)
        # ckpt_lock: migration mutates the state and the slot map, which the
        # checkpoint sweep reads.
        with self.ckpt_lock:
            return self._migrate_doc_locked(d, dst_shard)

    def _migration_reserve(self, d: int, dst_shard: int):
        """A migration's checks and its destination slot: ``(src_slot,
        dst_slot)``, or None when the doc stays."""
        plane = self.placement_plane
        plane.validate(d, dst_shard)
        plane.require_migratable(
            d,
            "segment" if d in self.seg_lanes
            else "overflow" if d in self.overflow else None,
        )
        if d in self.oracles or d in self.quarantine:
            return None
        return plane.reserve(d, dst_shard)

    def _migrate_doc_locked(self, d: int, dst_shard: int, reservation=None,
                            row=None) -> bool:
        """Live doc migration between shards (hot-shard rebalancing).

        The handoff is the checkpoint codec: the doc's row exports through
        ``kb.state_to_summary``, re-packs at the batch geometry with
        ``kb.summary_to_state_host`` and lands in a free slot of the
        destination shard; the vacated slot retires to the pristine row.
        Text, annotations, obliterate table and summary are identical
        before and after.  Host queues, retained logs and checkpoint floors
        travel with the doc untouched, so a doc may migrate with staged ops
        pending; they apply at the new slot on the next step.  Raises
        ``placement.PlacementError`` for a doc on a segment or overflow
        lane; returns False (the doc stays) when it is oracle- or
        quarantine-routed, already on ``dst_shard``, latched, or the
        destination has no free slot.  ``reservation`` and ``row``: the
        slots and the source row when the caller took them (a rank mesh's
        broadcast)."""
        plane = self.placement_plane
        if reservation is None:
            reservation = self._migration_reserve(d, dst_shard)
            if reservation is None:
                return False
        src_slot, dst_slot = reservation
        src_shard = src_slot // self.docs_per_shard
        h = self.hosts[d]
        if row is None:
            row = mk.to_numpy(mk.doc_row(self.state, src_slot))
        if int(row.error):
            plane.release(dst_slot)
            return False  # recover first; never migrate a latched row
        self._sync_native_props(h)
        summary = kb.state_to_summary(row, {v: k for k, v in h.prop_slot.items()})
        try:
            new_row = kb.summary_to_state_host(
                summary, self.geometry,
                lambda p: self._prop_slot_for_geom(h, p, self.geometry),
            )
        except (ValueError, IndexError):
            plane.release(dst_slot)
            return False  # does not re-pack at batch geometry: stay put
        self._put_row(dst_slot, new_row)
        self._put_row(src_slot, self._proto)
        plane.commit(d, src_slot, dst_slot)
        # Fresh row content (the text pool re-packed): the watchdog must
        # re-verify before the pre-filter may skip this doc again.
        self._verified_digest.pop(d, None)
        self.counters.bump("doc_migrations")
        instant("migrate_doc", doc=self.doc_keys[d], src=src_shard, dst=dst_shard)
        return True

    def rebalance_hot_shards(self, factor: float = 2.0,
                             max_moves: int = 1) -> list[tuple[int, int, int]]:
        """Detect hot shards and live-migrate their deepest-queued docs to
        the coldest shards with free slots (``migrate_doc`` per move).
        Returns the ``(doc, src_shard, dst_shard)`` moves made.  A shard hot
        because of one doc whose own queue exceeds the fleet mean cannot be
        rebalanced by placement; with a segs axis that doc is promoted to a
        segment lane instead and appears with ``dst_shard == -1``."""
        return placement.rebalance_hot_shards(
            self, self.placement_plane, factor, max_moves,
            in_lane=self._in_lane,
            promote_hot_doc=(
                self.enable_segment_sharding if self.seg_shards > 1 else None
            ),
        )

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
        for lane in (self.overflow.get(doc_idx), self.seg_lanes.get(doc_idx)):
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
        if self.device.type == "cuda":
            # Load (on a cold _build/, build) the kernel library with no
            # lock held: an nvcc run under ckpt_lock would stall ingest.
            from ..ops import cuda_build

            cuda_build.load()
        with self.ckpt_lock, span("warmup", k_max=self.megastep_k):
            stage = self._staging()
            lo, hi = self._rows
            for k in warmup_depths(self.megastep_k):
                ops, payloads = stage.acquire(k, self.capacity)
                kinds = ops[:, lo:hi, :, 0].copy()
                dev_ops, dev_payloads = stage.upload(ops, payloads, rows=self._rows)
                self.state = self._megastep(self.state, dev_ops, dev_payloads, kinds=kinds)
                warmed += 1
            # The compact program's first launch runs on the live state and
            # its result is dropped: a warmup never compacts a serving fleet
            # (the reference's keeps it, which changes a fleet whose MSN
            # moved since its last compact).
            self._compact(self.state, self._min_seqs())
            warmed += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.counters.gauge("warmup_dispatches", warmed)
        return warmed

    # --------------------------------------------------------------- watchdog
    def watchdog(self, sample: int | None = None) -> list[int]:
        """Cross-check a rotating sample of batch docs against a host-oracle
        replay of checkpoint + tail; quarantine (the oracle wins) on
        mismatch.  Returns the doc indices that failed the check.
        Collective on a rank mesh: the digests are gathered and each
        checked row broadcast from its rank."""
        if self.recovery == "off":
            return []
        eligible = [
            d for d in range(self.n_docs)
            if not (
                d in self.overflow or d in self.oracles or d in self.quarantine
            )
            and not (d in self.seg_lanes and self.seg_lanes[d].queue)
            and self.hosts[d].mode == "obj"
            and not self.hosts[d].queue
        ]
        if not eligible:
            return []
        # Device-digest pre-filter: one digest of the fleet per sweep (one
        # device-to-host read).  A doc whose digest (of its slot) AND
        # ingested seq both match its last passed check is skipped
        # (counted).  A segment lane's slot holds the pristine reserved
        # row, so its host-side version stamp vouches instead.
        digests = self._slot_column(fleet_digest(self.state)).tolist()
        drifted = []
        for d in eligible:
            if self._verified_digest.get(d) == self._watch_mark(d, digests):
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
                with self.ckpt_lock:
                    self._quarantine_doc(d, "watchdog: oracle replay failed")
                failed.append(d)
                continue
            self.counters.bump("watchdog_checks")
            if mk.visible_text(self.doc_state(d)) != expected:
                self.counters.bump("watchdog_mismatches")
                with self.ckpt_lock:
                    self._quarantine_doc(d, "watchdog: device/oracle divergence")
                failed.append(d)
            else:
                # Passed: pin the mark until the row or stream moves.
                self._verified_digest[d] = self._watch_mark(d, digests)
        return failed

    def _watch_mark(self, d: int, digests: list[int]) -> tuple:
        """The watchdog's change mark of a doc: (slot digest, seq), or the
        segment lane's (``"seg"``, version, seq)."""
        if d in self.seg_lanes:
            return ("seg", self.seg_lanes[d].version, self.hosts[d].last_seq)
        return (digests[int(self._slot[d])], self.hosts[d].last_seq)

    # ------------------------------------------------------------- checkpoint
    def maybe_checkpoint(self, force: bool = False, docs=None) -> list[int]:
        """Write durable checkpoint records for docs whose op count since
        the last checkpoint reached ``checkpoint_every`` (every dirty doc
        when ``force``; ``docs`` restricts the sweep to an explicit list,
        checkpointed whenever dirty), then truncate their replay logs to
        the tail.  The records are built under ``ckpt_lock`` and written
        after it is released.  Returns the doc indices checkpointed.
        Collective on a rank mesh (``_checkpoint_ranked``)."""
        if self.checkpoint_store is None:
            return []
        if docs is None and not force and self.checkpoint_every <= 0:
            return []
        if self._ranked:
            return self._checkpoint_ranked(force, docs)
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
        that bound).  Returns the doc indices checkpointed.  Collective on a
        rank mesh: the due set is the union of every rank's (each rank's
        clock stamps its own ``dirty_since``)."""
        if self.checkpoint_store is None or not (
            max_ops_behind or max_seconds_behind
        ):
            return []
        now = time.monotonic()
        if self._ranked:
            with self.ckpt_lock:
                due = stale_due_docs(
                    self.hosts, self.n_docs, max_ops_behind, max_seconds_behind, now,
                )
            mask = np.zeros((self.n_docs,), np.int64)
            mask[due] = 1
            due = np.flatnonzero(self._fleet_mesh.max_all(mask)).tolist()
            out = self._checkpoint_ranked(False, due) if due else []
            if out:
                self.counters.bump("stale_checkpoints_written", len(out))
            return out
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
        due = self._sweep_due(force, docs)
        if not due:
            return [], []  # host-side check only: no device read paid
        out: list[int] = []
        pending: list[tuple[int, int, dict]] = []
        # ONE bulk device-to-host copy of the fleet state covers every due
        # batch doc; the per-doc summary walks then slice host arrays.
        host_state = (
            mk.to_numpy(self.state) if any(self._on_batch(d) for d in due) else None
        )
        for d in due:
            if self._staged(d):
                continue  # staged-but-unapplied ops: state is mid-step
            res = self._sweep_summary(d, host_state)
            if res is None:
                continue
            pending.append(self._sweep_commit(d, *res))
            out.append(d)
        return out, pending

    def _sweep_due(self, force: bool, docs) -> list[int]:
        candidates = range(self.n_docs) if docs is None else docs
        return [
            d for d in candidates
            if self.hosts[d].ops_since_ckpt > 0
            and (
                force or docs is not None
                or self.hosts[d].ops_since_ckpt >= self.checkpoint_every
            )
        ]

    def _on_batch(self, d: int) -> bool:
        """The doc is served from its batch row (no lane, no oracle)."""
        return not (
            d in self.quarantine or d in self.oracles
            or d in self.overflow or d in self.seg_lanes
        )

    def _staged(self, d: int) -> bool:
        h = self.hosts[d]
        return bool(
            h.queue
            or (d in self.overflow and self.overflow[d].queue)
            or (d in self.seg_lanes and self.seg_lanes[d].queue)
        )

    def _sweep_summary(self, d: int, host_state, seg_host=None):
        """A due doc's checkpoint summary: ``(lane, summary, geometry,
        growths)``, or None for a latched row.  ``host_state``: the host
        copy of the fleet state's rows (this process's); ``seg_host``: a
        segment lane's unstacked host state when the caller gathered it."""
        h = self.hosts[d]
        lane = "batch"
        geometry = growths = None
        prop_names = {v: k for k, v in h.prop_slot.items()}
        if d in self.seg_lanes:
            # A segment lane checkpoints through the same codec (its live
            # prefixes gathered first) and restores as a batch row (or a
            # fitted overflow lane); the supervisor re-promotes.
            if seg_host is None:
                seg_host = mk.seg_unstack(mk.to_numpy(self.seg_lanes[d].state))
            if int(seg_host.error):
                return None  # never checkpoint a latched lane
            self._sync_native_props(h)
            summary = kb.state_to_summary(
                mk.seg_gather_state(seg_host),
                {v: k for k, v in h.prop_slot.items()},
            )
        elif d in self.quarantine:
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
                return None
            geometry = ln.geometry
            growths = ln.growths
            summary = kb.state_to_summary(row, prop_names)
        else:
            local = int(self._slot[d]) - self._rows[0]
            row = mk.tree_map(lambda x, _s=local: x[_s], host_state)
            if int(row.error):
                return None  # never checkpoint a poisoned row
            self._sync_native_props(h)
            prop_names = {v: k for k, v in h.prop_slot.items()}
            summary = kb.state_to_summary(row, prop_names)
        return lane, summary, geometry, growths

    def _sweep_commit(self, d: int, lane: str, summary: dict, geometry, growths):
        """A summarized doc's record, and its new durable floor: the replay
        log truncated to the tail."""
        h = self.hosts[d]
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
        entry = (d, h.last_seq, record)
        h.base_seq = h.last_seq
        h.base_summary = summary
        h.log = [m for m in h.log if m.seq > h.base_seq]
        if h.raw_log:
            h.raw_log = self._truncate_raw_log(h.raw_log, h.base_seq)
        h.ops_since_ckpt = 0
        h.dirty_since = 0.0
        h.boot_counting = False  # a new durable floor ends the boot phase
        self.counters.bump("checkpoints_written")
        return entry

    def _checkpoint_ranked(self, force: bool, docs) -> list[int]:
        """A checkpoint sweep on a rank mesh.  Under ``ckpt_lock``: the due
        docs (the same on every rank) and the summaries of the batch docs
        whose rows this rank holds.  Released: the segment lanes' gathers
        and one exchange of the summaries, so every rank advances every
        doc's floor alike.  Under it again: the records; each rank writes
        those of the docs it owns (``shard_of``), byte-identical to a
        one-card engine's, and every rank marks every failed write."""
        mesh = self._fleet_mesh
        lo, hi = self._rows
        with self.ckpt_lock, span("checkpoint_sweep", docs=self.n_docs):
            todo = [d for d in self._sweep_due(force, docs) if not self._staged(d)]
            mine = [d for d in todo
                    if self._on_batch(d) and lo <= int(self._slot[d]) < hi]
            host_state = mk.to_numpy(self.state) if mine else None
            own = {d: self._sweep_summary(d, host_state) for d in mine}
        if not todo:
            return []
        seg = {
            d: self._sweep_summary(d, None, mk.seg_unstack(self._lane_host(self.seg_lanes[d])))
            for d in todo if d in self.seg_lanes
        }
        for part in mesh.gather_objects(own):
            own.update(part)
        out: list[int] = []
        pending: list[tuple[int, int, dict]] = []
        with self.ckpt_lock:
            for d in todo:
                if d in seg:
                    res = seg[d]
                elif d in own:
                    self._sync_native_props(self.hosts[d])
                    res = own[d]
                else:
                    res = self._sweep_summary(d, None)  # replicated lanes
                if res is None:
                    continue
                entry = self._sweep_commit(d, *res)
                out.append(d)
                if self.shard_of(d) == mesh.rank:
                    pending.append(entry)
        failed = write_checkpoint_records(self, pending)
        others = [d for part in mesh.gather_objects(failed) for d in part if d not in failed]
        mark_write_failures(self, others)
        return out

    def _queue_depth(self, d: int) -> int:
        """Staged-but-unapplied rows of doc ``d`` (batch queue + lane)."""
        lane = self.seg_lanes.get(d) or self.overflow.get(d)
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
        with no staged work, a record strictly newer than their floor.
        On a rank mesh every rank reads every record (the host state stays
        the same everywhere) and writes only the rows it holds; no
        collective runs, and any number of ranks restores a store any
        number wrote."""
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
                        slot = int(self._slot[d])
                        if parallel:
                            batch_rows.append((slot, row))
                        else:
                            self._put_row(slot, row)
                restored.append(d)
                self.counters.bump("docs_restored")
        lo, hi = self._rows
        batch_rows = [(slot - lo, row) for slot, row in batch_rows if lo <= slot < hi]
        if batch_rows:
            with span("restore_scatter", rows=len(batch_rows)):
                scatter_rows(
                    self.state, [slot for slot, _ in batch_rows],
                    mk.tree_map(lambda *xs: np.stack(xs), *[r for _, r in batch_rows]),
                )
        if restored and not refresh:
            # A real restore opens a recovery incident: the clock runs until
            # the first post-restore op applies.
            self.recovery_tracker.begin(t_start)
        return restored

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
        self.seg_lanes.pop(d, None)
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
        """Batch docs with a latched error bit (one scalar read; collective
        on a rank mesh: the sum of every rank's count)."""
        return self._pm.error_count(self.state.error, self._fleet_mesh)

    def health(self) -> dict:
        """Degraded-mode health counters: the engine's counters and gauges,
        the overload gate, the sampled op latency, the recovery clock, and
        the lane and checkpoint surfaces.  The reference's ``recompiles``
        and ``despecializations`` are left out: they count XLA executable
        growth, and the port compiles nothing at run time.  Collective on a
        rank mesh: the lanes' occupancy is gathered, and the two per-rank
        figures (``ob_gate_syncs``, ``staging_overlap_packs``) are summed
        over the ranks."""
        self.counters.gauge("megastep_k", self.megastep_k)
        overlap = self._stage.overlapped_packs if self._stage is not None else 0
        if self._ranked:
            overlap = self._fleet_mesh.sum_all(overlap)
        self.counters.gauge("staging_overlap_packs", overlap)
        self.counters.ratio(
            "steps_per_dispatch", "megastep_slices", "megastep_dispatches"
        )
        self.overload_gate.emit_gauges(
            self.counters, self.megastep_k * self.ops_per_step,
            max(
                (
                    self._queue_depth(d)
                    for d in self._busy | set(self.seg_lanes) | set(self.overflow)
                ),
                default=0,
            ),
        )
        # Placement surface: shard count, the 2-D docs x segs surface (segs
        # width, promoted docs, per-shard live segments across all lanes),
        # and per-shard load for hot-shard detection.
        self.counters.gauge("n_shards", self.n_shards)
        self.counters.gauge("segment_shards", self.seg_shards)
        self.counters.gauge("segment_sharded_docs", len(self.seg_lanes))
        if self.seg_lanes:
            occ = np.zeros((self.seg_shards,), np.int64)
            for lane in self.seg_lanes.values():
                nseg = lane.state.nseg
                if self._ranked:
                    nseg = self.mesh.seg_gather(nseg, self._seg_megastep.group)
                occ += mk.seg_occupancy(lane.state._replace(nseg=nseg))
            self.counters.gauge("seg_occupancy", [int(v) for v in occ])
            self.counters.gauge(
                "seg_lane_rebalances",
                sum(lane.rebalances for lane in self.seg_lanes.values()),
            )
        elif self.seg_shards > 1:
            # Zero the persisted gauges once the last lane demotes.
            self.counters.gauge("seg_occupancy", [0] * self.seg_shards)
            self.counters.gauge("seg_lane_rebalances", 0)
        if self.n_shards > 1:
            ops, depth = self.shard_load()
            self.counters.gauge("shard_ops", [int(v) for v in ops])
            self.counters.gauge("shard_queue_depth", [int(v) for v in depth])
            self.counters.gauge("hot_shards", self.hot_shards(load=ops + depth))
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
        if self.n_shards > 1:
            self.counters.gauge(
                "shard_latency_p99_ms",
                [
                    round(h.percentile(0.99) * 1e3, 3) if h.count else 0.0
                    for h in self._shard_latency
                ],
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
        if self._ranked:
            snap["ob_gate_syncs"] = self._fleet_mesh.sum_all(snap.get("ob_gate_syncs", 0))
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
        """A doc's one-document state: its segment lane's (gathered into the
        single-lane layout, numpy), its overflow lane's, else its slot's
        row (views).  Collective on a rank mesh: a lane is gathered, a
        slot's row broadcast from its rank (a copy)."""
        if doc_idx in self.seg_lanes:
            lane = self.seg_lanes[doc_idx]
            return mk.seg_gather_state(self._lane_host(lane) if self._ranked else lane.state)
        if doc_idx in self.overflow:
            return mk.doc_row(self.overflow[doc_idx].state, 0)
        return self._row(int(self._slot[doc_idx]))

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
        """Per-doc error vector (``capacity`` entries, the first ``n_docs``
        doc-indexed) across batch, overflow and segment lanes.  Oracle and
        quarantined docs read 0: they are isolated and serviceable — their
        degraded state surfaces through ``health()``.  Collective on a
        rank mesh (the error column is gathered)."""
        by_slot = self._slot_column(self.state.error)
        err = np.zeros((self.capacity,), by_slot.dtype)
        err[: self.n_docs] = by_slot[self._slot]
        for d, lane in self.overflow.items():
            err[d] = int(lane.state.error[0])
        for d, lane in self.seg_lanes.items():
            err[d] = int(lane.state.error[0])
        for d in self.oracles:
            err[d] = 0
        for d in self.quarantine:
            err[d] = 0
        return err
