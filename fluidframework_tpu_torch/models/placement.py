"""Placement plane: doc -> device-slot indirection shared by both engine
families, restore's scan guard and boot-snapshot adoption.

Counterpart of ``fluidframework_tpu/models/placement.py``.  Both batched
engines serve D documents out of one ``[capacity, ...]`` device state,
where ``capacity`` rounds the fleet up to a shard multiple plus
``spare_slots`` reserved free rows.

- ``PlacementPlane`` — the doc -> slot map with per-shard spare-slot free
  pools.  Docs distribute in contiguous blocks over all shards (identity
  when there are no spare slots), so each engine packs its staging buffer
  by placement; spare slots spread across shards as the free pool a live
  ``migrate_doc`` lands in.  The plane owns the reserve/commit/release
  protocol of a move; the engines own the handoff of the row itself
  (``state_to_summary -> summary_to_state`` for strings, trunk fold ->
  re-materialization for trees).  On the port a shard is a contiguous
  block of ``docs_per_shard`` rows of that one state (``parallel/mesh.py``).
- ``rebalance_hot_shards`` / ``hot_shards`` / ``shard_load`` — the
  engine-agnostic hot-shard detection and move selection.
- ``adopt_boot_snapshot`` — the client half of the fan-out plane's
  ``{"t":"resync","boot":true}`` contract, riding each engine's refresh
  re-seed path; returns an ``AdoptResult``.
- ``restore_candidates`` — the shared scan guard of
  ``restore_from_checkpoints(refresh=...)``.

Locking: ``PlacementPlane._lock`` is a leaf lock — it guards only the slot
map and free pools, is held for bookkeeping, and never wraps an engine
call, a device launch or I/O.  Engines serialize whole migrations under
their own ``ckpt_lock``.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import numpy as np

from ..observability.flight_recorder import instant

class PlacementError(RuntimeError):
    """A doc cannot migrate because it is pinned off the batch path.

    Raised LOUDLY (not a False return) for docs parked in a parallel lane
    (segment-sharded or overflow strings, fallback-routed trees): their
    serving state lives outside the doc's fleet slot, so a slot handoff
    would silently strand it.  Callers must drain/demote the doc back
    onto the batch path first."""


class AdoptResult(NamedTuple):
    """Outcome of ``adopt_boot_snapshot``.

    ``adopted``
        True when the record re-seeded the doc; the consumer re-subscribes
        from ``floor`` (the record's seq).  False when the record was at
        or below the doc's applied floor — the snapshot cannot help, and
        since the server already declared the consumer's range gone, a
        re-subscribe from the doc's own floor would just draw another
        boot marker: fall to the supervisor path instead.
    ``floor``
        The doc's applied seq floor after the call.
    """

    adopted: bool
    floor: int


class OneRecordStore:
    """A single-record checkpoint 'store': the adapter that lets one
    historian snapshot ride the engines' normal ``_restore`` machinery
    (lanes, quorum, prop/mark tables and the replay floor all reset
    through the one audited path)."""

    def __init__(self, key: str, record: dict) -> None:
        self._key = key
        self._record = record

    def load(self, doc_id: str):
        return self._record if doc_id == self._key else None


class PlacementPlane:
    """doc -> slot indirection with per-shard spare-slot free pools."""

    def __init__(self, n_docs: int, n_shards: int, spare_slots: int = 0) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if spare_slots < 0:
            raise ValueError(f"spare_slots must be >= 0, got {spare_slots}")
        self.n_docs = n_docs
        self.n_shards = n_shards
        self.spare_slots = spare_slots
        # Device capacity rounds up to a mesh multiple (padding slots are
        # inert: empty queues only ever apply noops); ``spare_slots``
        # reserves extra free rows beyond the fleet so live migration
        # always has landing slots on every shard.
        self.capacity = -(-(n_docs + spare_slots) // n_shards) * n_shards
        self.docs_per_shard = self.capacity // n_shards
        self._lock = threading.Lock()
        per = -(-n_docs // n_shards)  # docs per shard at construction
        self._slot = np.array(
            [
                (d // per) * self.docs_per_shard + (d % per)
                for d in range(n_docs)
            ],
            dtype=np.int64,
        )
        used = set(map(int, self._slot))
        self._free_slots: dict[int, list[int]] = {
            s: [] for s in range(n_shards)
        }
        for slot in range(self.capacity):
            if slot not in used:
                self._free_slots[slot // self.docs_per_shard].append(slot)

    # --------------------------------------------------------------- queries
    def slot(self, doc_idx: int) -> int:
        return int(self._slot[doc_idx])

    @property
    def slots(self) -> np.ndarray:
        """The live doc -> slot array (engines alias it for hot-path
        packing; treat as read-only outside the plane)."""
        return self._slot

    def shard_of(self, doc_idx: int) -> int:
        """The mesh shard currently hosting this doc's device row."""
        return int(self._slot[doc_idx]) // self.docs_per_shard

    def placement(self, doc_keys: list[str]) -> dict[str, int]:
        """doc key -> mesh shard: the summary-ownership alignment surface
        (the ``placement`` of ``fleet_main``'s ``migrations`` line)."""
        return {doc_keys[d]: self.shard_of(d) for d in range(self.n_docs)}

    def free_slots(self, shard: int) -> int:
        return len(self._free_slots[shard])

    # ----------------------------------------------------------------- moves
    def validate(self, doc_idx: int, dst_shard: int) -> None:
        if not (0 <= dst_shard < self.n_shards):
            raise ValueError(
                f"no shard {dst_shard} in a {self.n_shards}-shard mesh"
            )
        if not (0 <= doc_idx < self.n_docs):
            raise ValueError(f"no doc {doc_idx}")

    def require_migratable(self, doc_idx: int, lane: str | None) -> None:
        """The loud precondition of every migration: a doc pinned to a
        parallel lane must drain/demote before its slot may hand off."""
        if lane is not None:
            raise PlacementError(
                f"doc {doc_idx} is pinned to the {lane} lane; drain or "
                "demote it back onto the batch path before migrating"
            )

    def reserve(self, doc_idx: int, dst_shard: int) -> tuple[int, int] | None:
        """Claim a free destination slot for a move: -> (src_slot,
        dst_slot), or None when the doc already lives on ``dst_shard`` or
        the destination pool is empty.  The reservation must be resolved
        with ``commit`` (slot map flips, src slot retires to its pool) or
        ``release`` (handoff failed, dst slot returns to its pool)."""
        self.validate(doc_idx, dst_shard)
        with self._lock:
            src_slot = int(self._slot[doc_idx])
            if src_slot // self.docs_per_shard == dst_shard:
                return None
            pool = self._free_slots[dst_shard]
            if not pool:
                return None
            return src_slot, pool.pop()

    def commit(self, doc_idx: int, src_slot: int, dst_slot: int) -> None:
        with self._lock:
            self._slot[doc_idx] = dst_slot
            self._free_slots[src_slot // self.docs_per_shard].append(src_slot)

    def release(self, dst_slot: int) -> None:
        with self._lock:
            self._free_slots[dst_slot // self.docs_per_shard].append(dst_slot)


# --------------------------------------------------------------------------
# Engine-agnostic orchestration (both engines delegate here).
# --------------------------------------------------------------------------

def shard_load(engine) -> tuple[np.ndarray, np.ndarray]:
    """Per-shard (applied ops since the last ``hot_shards`` reset,
    currently queued ops) — host-side accounting only, no device
    readback."""
    depth = np.zeros((engine.n_shards,), np.int64)
    for d in range(engine.n_docs):
        q = len(engine.hosts[d].queue)
        if q:
            depth[engine.shard_of(d)] += q
    return engine._shard_ops.copy(), depth


def hot_shards(engine, factor: float = 2.0, reset: bool = False,
               load=None) -> list[int]:
    """Shards whose load (applied + queued ops) exceeds ``factor`` x the
    fleet mean — the live-migration trigger.  ``reset`` zeroes the
    applied-op counters so the next window measures fresh traffic;
    callers that already hold a ``shard_load()`` result pass its sum as
    ``load`` to skip the O(n_docs) rewalk."""
    if load is None:
        ops, depth = engine.shard_load()
        load = ops + depth
    if reset:
        engine._shard_ops[:] = 0
    if engine.n_shards <= 1 or not load.any():
        return []
    mean = float(load.mean())
    return [int(s) for s in np.flatnonzero(load > factor * mean)]


def rebalance_hot_shards(
    engine,
    plane: PlacementPlane,
    factor: float = 2.0,
    max_moves: int = 1,
    *,
    in_lane: Callable[[int], bool],
    promote_hot_doc: Callable[[int], bool] | None = None,
) -> list[tuple[int, int, int]]:
    """Detect hot shards and live-migrate their deepest-queued docs to
    the coldest shards with free slots (one checkpoint-codec handoff per
    move — the engine's ``migrate_doc``).  Returns the ``(doc, src_shard,
    dst_shard)`` moves made; callers re-align summary ownership afterwards
    (``fleet_main`` prints the new placement) so it follows the docs.

    Hysteresis: a doc whose OWN queue exceeds ``factor`` x the fleet mean
    IS the hotspot — migrating it just moves the hot shard (and would
    ping-pong it every interval, paying a full handoff each time).  Such
    docs are the hot-document-parallelism problem, not a placement
    problem; with ``promote_hot_doc`` provided (the string engine's
    segment-parallel promotion) the doc is promoted instead and appears
    in the result with ``dst_shard == -1`` (its placement slot stays
    reserved)."""
    ops, depth = engine.shard_load()
    load = ops + depth
    hot = engine.hot_shards(factor, reset=True, load=load)
    if not hot:
        return []
    mean = float(load.mean())
    moves: list[tuple[int, int, int]] = []
    for s in hot:
        if len(moves) >= max_moves:
            break
        candidates = [
            d for d in range(engine.n_docs)
            if engine.shard_of(d) == s and not in_lane(d)
            and len(engine.hosts[d].queue) <= factor * mean
        ]
        if not candidates:
            engine.counters.bump("hot_shard_moves_skipped")
            # The skipped case IS the hot-document problem: a doc whose
            # own queue exceeds the fleet mean cannot be placed away.
            if promote_hot_doc is not None:
                hot_docs = sorted(
                    (
                        d for d in range(engine.n_docs)
                        if engine.shard_of(d) == s and not in_lane(d)
                        and len(engine.hosts[d].queue) > factor * mean
                    ),
                    key=lambda dd: -len(engine.hosts[dd].queue),
                )
                for d in hot_docs:
                    if promote_hot_doc(d):
                        moves.append((d, s, -1))
                        break
            continue
        d = max(candidates, key=lambda dd: len(engine.hosts[dd].queue))
        for dst in map(int, np.argsort(depth)):
            if dst == s or not plane.free_slots(dst):
                continue
            if engine.migrate_doc(d, dst):
                depth[dst] += len(engine.hosts[d].queue)
                moves.append((d, s, dst))
                break
    if moves:
        engine.counters.bump("hot_shard_rebalances", len(moves))
        instant("rebalance", moves=len(moves), hot_shards=len(hot))
    return moves


def adopt_boot_snapshot(
    engine,
    doc_idx: int,
    record: dict,
    clear_staged: Callable[[int], None],
) -> AdoptResult:
    """Client half of the fan-out plane's ``{"t":"resync","boot":true}``
    contract: a consumer that fell off the retained log re-seeds the
    document from a historian snapshot record and re-consumes from the
    returned floor.  Staged pre-gap work is dropped up front
    (``clear_staged`` — the refresh guard refuses docs with pending ops,
    but a boot resync REPLACES the doc), and the adoption rides the
    engine's refresh re-seed path, so lanes, quorum/trunk windows and the
    replay floor all reset consistently.

    Returns ``AdoptResult(adopted=False, floor=...)`` for a record at or
    below the doc's applied floor (see AdoptResult for why the caller
    must NOT just re-subscribe), and raises ``ValueError`` for a record
    the engine cannot load at all (engine mismatch / schema drift) — the
    supervisor-restart path."""
    with engine.ckpt_lock:
        h = engine.hosts[doc_idx]
        seq = int(record["seq"])
        if seq <= h.last_seq:
            engine.counters.bump("boot_snapshots_stale")
            return AdoptResult(False, h.last_seq)
        clear_staged(doc_idx)
        key = engine.doc_keys[doc_idx]
        adopted = engine._restore(
            OneRecordStore(key, record), parallel=False, max_workers=None,
            refresh=True,
        )
        if doc_idx not in adopted:
            # The record was unusable: fail LOUDLY — returning a stale
            # floor would send the consumer back to a range the server
            # already declared gone, an infinite resync loop that looks
            # healthy.
            raise ValueError(
                f"boot snapshot for doc {key!r} not adoptable "
                f"(engine={record.get('engine')!r})"
            )
        engine.counters.bump("boot_snapshots_adopted")
        return AdoptResult(True, h.last_seq)


def restore_candidates(
    engine, store, refresh: bool, staged_depth: Callable[[int], int],
) -> tuple[list[int], dict[int, float]]:
    """The shared scan guard of ``restore_from_checkpoints``: which docs
    are candidates for (re-)adoption this pass, and the record mtimes to
    stamp after a successful load.

    - First boot (``refresh=False``): every doc not yet restored.
    - Trailing/refresh: already-restored docs stay candidates (the
      in-place re-seed path — the engine skips any whose record is not
      strictly newer), docs with staged work are skipped (trailing never
      races serving), and unchanged record files skip via one mtime stat
      per doc instead of a record re-read."""
    candidates: list[int] = []
    cand_mtime: dict[int, float] = {}
    for d in range(engine.n_docs):
        h = engine.hosts[d]
        if h.restored and not refresh:
            continue
        if refresh and staged_depth(d):
            continue
        if refresh:
            # Stamped as seen only after a successful load — a transient
            # read failure must not permanently exclude the doc.
            mt = getattr(store, "mtime", lambda _k: None)(
                engine.doc_keys[d]
            )
            if mt is not None and engine._trail_mtime.get(d) == mt:
                continue
            if mt is not None:
                cand_mtime[d] = mt
        candidates.append(d)
    return candidates, cand_mtime
