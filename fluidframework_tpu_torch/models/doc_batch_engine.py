"""DocBatchEngine: batched sequenced-op application across many documents.

Counterpart of ``fluidframework_tpu/models/doc_batch_engine.py``, the
core of it: thousands of SharedString replicas, each with its own totally
ordered op stream, applied in lockstep device megasteps.

- host: per-doc ``RowQueue`` staging of sequenced messages, op encoding
  (stamp keys, positions, payload codepoints), quorum (clientId -> short
  id), prop-slot interning;
- device: ``step`` packs up to K [D, B] slices into a pinned staging ring,
  uploads them and applies them with ``apply_megastep`` through the
  dispatch plane; ``compact`` advances every doc's MSN and runs zamboni.

The state is byte-identical to the reference engine's for the same
message stream.  This slice supports ``recovery="off"`` only: error bits
latch on the per-doc ``error`` column and stay there (``errors()``).
Recovery lanes (grow/oracle/quarantine), checkpoints, the watchdog,
migration, cohort steps and engine-promoted segment lanes raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import mergetree_kernel as mk
from ..protocol.messages import (
    DeltaType,
    MessageType,
    SequencedMessage,
    decode_obliterate_places,
)
from .dispatch import dispatch_plane
from .staging import RowQueue, StagingRing


class _DocHost:
    """Host-side per-document bookkeeping."""

    __slots__ = ("queue", "quorum", "min_seq", "prop_slot")

    def __init__(self, max_insert_len: int) -> None:
        self.queue = RowQueue(mk.OP_FIELDS, max_insert_len)
        self.quorum: dict[str, int] = {}
        self.min_seq = 0
        self.prop_slot: dict[int, int] = {}  # property id -> kernel prop slot


def _fleet_compact_body(state: mk.DocState, min_seqs) -> mk.DocState:
    """Cadence compaction: every doc's MSN advance, then zamboni (the
    reference's ``_fleet_compact_body``)."""
    return mk.compact(mk.set_min_seq(state, min_seqs))


# Reference constructor options this slice does not port, with the values
# that leave them off (``seg_shards=1`` is a one-shard fleet: also off).
_OPTIONS_OFF = {
    "checkpoint_store": (None,), "checkpoint_every": (0,),
    "watchdog_every": (0,), "readmit_after_steps": (0,),
    "poison_budget": (0,), "spare_slots": (0,), "seg_shards": (0, 1),
    "seg_lane_segments": (0,), "seg_rebalance_every": (0,),
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
        recovery: str = "off",
        device=DEFAULT_DEVICE,
        **options,
    ) -> None:
        if recovery != "off":
            raise NotImplementedError(
                f"recovery={recovery!r}: this port supports recovery='off' only"
            )
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
        self.hosts = [_DocHost(max_insert_len) for _ in range(n_docs)]
        self.geometry = {
            "max_segments": max_segments,
            "remove_slots": remove_slots,
            "prop_slots": prop_slots,
            "text_capacity": text_capacity,
            "ob_slots": ob_slots,
        }
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
        self.counters: dict[str, int] = {
            "megastep_dispatches": 0, "megastep_slices": 0, "ops_staged": 0,
            "ob_gate_syncs": 0,  # device reads of the obliterate gate
        }

    # ------------------------------------------------------------------ ingest
    def ingest(self, doc_idx: int, msg: SequencedMessage) -> None:
        """Stage one sequenced message for a document (host-side decode);
        application is deferred to the next ``step``."""
        h = self.hosts[doc_idx]
        h.min_seq = max(h.min_seq, msg.min_seq)
        if msg.type == MessageType.JOIN:
            h.quorum[msg.contents["clientId"]] = msg.contents["short"]
            return
        if msg.type != MessageType.OP:
            return
        rows = self._encode(h, msg)
        h.queue.extend_rows(rows)
        self.counters["ops_staged"] += len(rows)
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

    def _prop_slot_for(self, h: _DocHost, prop: int) -> int:
        """Intern a property id to a kernel prop slot (range-checked)."""
        if prop not in h.prop_slot:
            slot = len(h.prop_slot)
            if slot >= self.geometry["prop_slots"]:
                raise ValueError(
                    f"document exhausted its {self.geometry['prop_slots']} prop "
                    f"slots; raise prop_slots to accommodate prop id {prop}"
                )
            h.prop_slot[prop] = slot
        return h.prop_slot[prop]

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
        self.state = self._megastep(self.state, dev_ops, dev_payloads, kinds=kinds)
        self.counters["ob_gate_syncs"] += mk.apply_megastep.ob_gate_syncs - syncs
        self.counters["megastep_dispatches"] += 1
        self.counters["megastep_slices"] += K
        return K

    def step(self) -> int:
        """Run megasteps until all staged ops are applied; returns the
        number of [D, B] slices applied.  Error bits latch on device
        (``errors()``); nothing is recovered (``recovery="off"``)."""
        steps = 0
        while self._busy:
            steps += self._full_step(sorted(self._busy))
        return steps

    def compact(self) -> None:
        """Advance MSNs and run zamboni eviction across the fleet."""
        mins = np.array([h.min_seq for h in self.hosts], np.int32)
        self.state = self._compact(
            self.state, self._pm.shard_docs(torch.from_numpy(mins), self.mesh)
        )

    def _not_ported(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpoints, recovery lanes, the watchdog, migration and "
            "engine-promoted segment lanes are not ported yet"
        )

    maybe_checkpoint = restore_from_checkpoints = watchdog = _not_ported
    readmit = migrate_doc = enable_segment_sharding = _not_ported

    # ------------------------------------------------------------------ views
    def error_count(self) -> int:
        """Docs with a latched error bit (one scalar read)."""
        return self._pm.error_count(self.state.error)

    def health(self) -> dict:
        out = dict(self.counters)
        out["megastep_k"] = self.megastep_k
        out["staging_overlap_packs"] = (
            self._stage.overlapped_packs if self._stage is not None else 0
        )
        return out

    def doc_state(self, doc_idx: int) -> mk.DocState:
        return mk.doc_row(self.state, doc_idx)

    def text(self, doc_idx: int) -> str:
        return mk.visible_text(self.doc_state(doc_idx))

    def annotations(self, doc_idx: int) -> list[dict[int, int]]:
        raw = mk.annotations(self.doc_state(doc_idx))
        inv = {v: k for k, v in self.hosts[doc_idx].prop_slot.items()}
        return [{inv[p]: v for p, v in d.items()} for d in raw]

    def errors(self) -> np.ndarray:
        """Per-doc error vector (doc-indexed)."""
        return self.state.error.cpu().numpy()
