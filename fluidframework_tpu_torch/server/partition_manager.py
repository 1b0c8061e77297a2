"""Partition ownership: moving document partitions between workers.

A port of ``fluidframework_tpu/server/partition_manager.py`` (no JAX in it).
``ScribePool``'s members are the port's ``server/scribe.ScribeLambda``,
whose map and matrix replicas run their K10 batches on the pool's
``device`` (``ScribePool(..., device=...)``, the card by default).

Reference parity: lambdas-driver ``PartitionManager``/``DocumentPartition``
(server/routerlicious/packages/lambdas-driver/src/partitionManager.ts;
the reference's ordering-service design).  The topics are the durable layer (Kafka analog —
they outlive any worker); a WORKER hosts the lambda set (deli, scriptorium,
broadcaster, scribe) for each partition it owns.  Ownership is assigned
round-robin over the sorted worker set and re-balanced whenever a worker
joins, leaves gracefully, or dies:

- graceful release checkpoints the partition's lambdas and hands the state
  to the next owner — seamless resume;
- a KILLED worker's partitions resume from the manager's last periodic
  checkpoint (taken at every quiescent pump), replaying the topic suffix
  with the same at-least-once dedup the durable restart path uses
  (``apply_replay_dedup``): deli re-produces nothing already in the deltas
  log, scribe re-emits no response already ticketed, scriptorium rebuilds
  its store deterministically by replay — no op loss, no duplication.

Broadcaster subscriptions are manager-owned and re-attached to the new
owner on every move (stateless fronts re-register the same way in the
reference); subscribers may see a bounded re-delivery window after a kill
and dedup by sequence number, the normal at-least-once contract.
"""

from __future__ import annotations

from typing import Any, Callable

from ..device import DEFAULT_DEVICE, resolve_device
from ..protocol.messages import SequencedMessage, UnsequencedMessage
from .lambdas import (
    BroadcasterLambda,
    DeliLambda,
    ScribeLambda,
    ScriptoriumLambda,
    apply_replay_dedup,
)
from .ordered_log import Topic


class _PartitionLambdas:
    """The lambda set one worker runs for one owned partition."""

    def __init__(
        self,
        p: int,
        rawdeltas: Topic,
        deltas: Topic,
        uploads: dict,
        snapshot_store: dict,
        checkpoint: dict | None,
        use_native: bool,
    ) -> None:
        self.partition = p
        if checkpoint is not None:
            self.deli = DeliLambda.restore(
                checkpoint["deli"], rawdeltas, deltas, p
            )
        else:
            self.deli = DeliLambda(rawdeltas, deltas, p, use_native)
        self.scriptorium = ScriptoriumLambda(deltas, p)
        self.broadcaster = BroadcasterLambda(deltas, p)
        # Snapshots and upload staging are EXTERNAL durable storage (the
        # git/historian analog, manager-owned) — a worker crash never loses
        # them, so checkpoints carry only offsets + sequencer state.
        self.scribe = ScribeLambda(
            deltas, rawdeltas, p, uploads, snapshots=snapshot_store
        )
        if checkpoint is not None:
            self.scribe.offset = checkpoint["scribeOffset"]
            self.broadcaster.offset = checkpoint.get("broadcasterOffset", 0)
        # Resume-by-replay side-effect dedup — exactly the durable-restart
        # arming; a fresh partition (no checkpoint) replays from zero into
        # empty state, where the same arming is a no-op with empty topics.
        self.scribe.replay_skip = apply_replay_dedup(
            self.deli, self.scribe.offset, rawdeltas, deltas, uploads, p,
            arm_responses=False,  # replay_skip prevents re-emission instead
        )

    def pump(self) -> int:
        return (
            self.deli.pump()
            + self.scriptorium.pump()
            + self.broadcaster.pump()
            + self.scribe.pump()
        )

    def checkpoint(self) -> dict:
        return {
            "deli": self.deli.checkpoint(),
            "scribeOffset": self.scribe.offset,
            "broadcasterOffset": self.broadcaster.offset,
        }


class PartitionManager:
    """Assigns partitions to workers; front-end API mirrors PipelineService."""

    def __init__(self, n_partitions: int = 4, use_native: bool = False) -> None:
        self.n_partitions = n_partitions
        self._use_native = use_native
        self.rawdeltas = Topic("rawdeltas", n_partitions)
        self.deltas = Topic("deltas", n_partitions)
        self.uploads: dict[str, Any] = {}
        self.snapshot_store: dict[str, list[tuple[int, dict]]] = {}
        self._upload_counter = 0
        # partition -> last durable checkpoint (the offset-store analog).
        self.checkpoints: dict[int, dict] = {}
        # worker id -> {partition: lambda set}
        self.workers: dict[str, dict[int, _PartitionLambdas]] = {}
        # doc id -> subscriber callbacks (re-attached on every move).
        self._subs: dict[str, list[Callable[[SequencedMessage], None]]] = {}
        self.rebalances = 0

    # ------------------------------------------------------------ membership
    def add_worker(self, worker_id: str) -> None:
        if worker_id in self.workers:
            raise ValueError(f"worker {worker_id!r} already present")
        self.workers[worker_id] = {}
        self._rebalance()

    def remove_worker(self, worker_id: str) -> None:
        """Graceful departure: checkpoint every owned partition first, so
        successors resume seamlessly."""
        for p, lams in self.workers[worker_id].items():
            self.checkpoints[p] = lams.checkpoint()
        del self.workers[worker_id]
        self._rebalance()

    def kill_worker(self, worker_id: str) -> None:
        """Crash: owned partitions resume elsewhere from the last PERIODIC
        checkpoint (no chance to checkpoint at death)."""
        del self.workers[worker_id]
        self._rebalance()

    def owner_of(self, p: int) -> str | None:
        for wid, owned in self.workers.items():
            if p in owned:
                return wid
        return None

    def assignments(self) -> dict[str, list[int]]:
        return {
            wid: sorted(owned) for wid, owned in sorted(self.workers.items())
        }

    def _rebalance(self) -> None:
        """Deterministic round-robin of partitions over sorted workers;
        moved partitions release (with checkpoint when the old owner is
        alive) and rebuild on the new owner from the stored checkpoint."""
        self.rebalances += 1
        ordered = sorted(self.workers)
        desired: dict[int, str | None] = {
            p: ordered[p % len(ordered)] if ordered else None
            for p in range(self.n_partitions)
        }
        for p, new_wid in desired.items():
            old_wid = self.owner_of(p)
            if old_wid == new_wid:
                continue
            if old_wid is not None:
                # Live move: checkpoint handoff from the old owner.
                self.checkpoints[p] = self.workers[old_wid].pop(p).checkpoint()
            if new_wid is not None:
                lams = _PartitionLambdas(
                    p, self.rawdeltas, self.deltas, self.uploads,
                    self.snapshot_store, self.checkpoints.get(p),
                    self._use_native,
                )
                for doc_id, subs in self._subs.items():
                    if self.deltas.partition_for(doc_id) == p:
                        for fn in subs:
                            lams.broadcaster.subscribe(doc_id, fn)
                self.workers[new_wid][p] = lams

    # -------------------------------------------------------------- front-end
    def submit_op(self, doc_id: str, msg: UnsequencedMessage) -> None:
        self.rawdeltas.produce(doc_id, ("op", msg))

    def join(self, doc_id: str, client_id: str) -> None:
        self.rawdeltas.produce(doc_id, ("join", client_id))

    def leave(self, doc_id: str, client_id: str) -> None:
        self.rawdeltas.produce(doc_id, ("leave", client_id))

    def upload_summary(self, tree: dict) -> str:
        self._upload_counter += 1
        h = f"upload_{self._upload_counter}"
        self.uploads[h] = tree
        return h

    def subscribe(self, doc_id: str, fn: Callable[[SequencedMessage], None]) -> None:
        self._subs.setdefault(doc_id, []).append(fn)
        wid = self.owner_of(self.deltas.partition_for(doc_id))
        if wid is not None:
            p = self.deltas.partition_for(doc_id)
            self.workers[wid][p].broadcaster.subscribe(doc_id, fn)

    # ------------------------------------------------------------------ drive
    def pump(self, max_rounds: int = 64) -> int:
        """Drive every owned partition to quiescence, then take the
        periodic checkpoints a crash would resume from."""
        total = 0
        for _ in range(max_rounds):
            moved = 0
            for owned in self.workers.values():
                for lams in owned.values():
                    moved += lams.pump()
            total += moved
            if moved == 0:
                break
        else:
            raise RuntimeError("partitions failed to quiesce")
        for owned in self.workers.values():
            for p, lams in owned.items():
                self.checkpoints[p] = lams.checkpoint()
        return total

    # ------------------------------------------------------------ introspect
    def ops_of(self, doc_id: str) -> list[SequencedMessage]:
        p = self.deltas.partition_for(doc_id)
        wid = self.owner_of(p)
        if wid is None:
            return []
        return self.workers[wid][p].scriptorium.store.get(doc_id, [])

    def snapshots_of(self, doc_id: str) -> list[tuple[int, dict]]:
        return self.snapshot_store.get(doc_id, [])


# ---------------------------------------------------------------------------
# Scribe scale-out (the standalone summarizer service, server/scribe.py)
# ---------------------------------------------------------------------------


class ScribePool:
    """Membership manager for N standalone-scribe members over ONE op topic
    (scribe scale-out: election + handoff).

    All members share the durable substrate — one consumer group (so
    partitions deal round-robin over the live membership and committed
    offsets are group-global), one content-addressed object store, and one
    merged ``refs.json`` — while each member folds and summarizes only its
    assigned partitions.  On any membership change the group rebalances
    and a partition's new owner resumes it by **summary adoption**
    (``ScribeLambda._adopt_summary``): each doc's replica loads from the
    latest acked commit recorded in the shared refs, and only the tail
    above the group's committed floor re-folds.  Because the committed
    floor never passes a consumed-but-unsummarized record, a KILLED
    member's unsummarized fold work is re-read exactly; and because acks
    are idempotent by seq floor, the successor can never double-ack a
    summary the dead member already produced."""

    def __init__(
        self, topic: Topic, directory: str, config=None, families=None,
        device=DEFAULT_DEVICE,
    ) -> None:
        import os

        from .gitstore import GitStore as _GitStore
        from .ordered_log import ConsumerGroup

        self.topic = topic
        self.directory = directory
        self.config = config
        self.families = families
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        self.store = _GitStore(os.path.join(directory, "objects"))
        self.group = ConsumerGroup(topic, "scribe", directory)
        self.members: dict[str, Any] = {}
        self.kills = 0

    def add_member(self, member_id: str):
        """Join one scribe member (rebalances the group immediately)."""
        from .scribe import ScribeLambda as _ScribeService

        if member_id in self.members:
            raise ValueError(f"scribe member {member_id!r} already present")
        member = _ScribeService(
            self.topic, self.directory, config=self.config,
            families=self.families, member_id=member_id,
            store=self.store, group=self.group, device=self.device,
        )
        self.members[member_id] = member
        return member

    def remove_member(self, member_id: str) -> None:
        """Graceful departure: cut summaries for everything pending first,
        so successors adopt the freshest possible floors.  The member stays
        in the pool (and the group) until its flush succeeds — a failed
        flush must leave it pumpable/retriable, never stranded as a group
        member nobody pumps."""
        self.members[member_id].summarize_all()
        self.members.pop(member_id)
        self.group.leave(member_id)

    def kill_member(self, member_id: str) -> None:
        """Crash: no flush, no goodbye.  The group rebalances; new owners
        resume from the committed floors + shared refs/object store."""
        self.members.pop(member_id)
        self.group.leave(member_id)
        self.kills += 1

    def pump(self) -> int:
        return sum(m.pump() for m in list(self.members.values()))

    def align_to_placement(self, placement: dict[str, int]) -> dict[int, str]:
        """Align summary ownership to the serving fleet's doc placement
        (DocBatchEngine/TreeBatchEngine ``placement()``: doc key -> mesh
        shard).  Each doc pins to the topic partition of its shard
        (``shard % n_partitions``) and each such partition pins to one
        pool member — sorted member order maps to shard order — so the
        scribe member summarizing a doc is the one co-located with the
        chip serving it.

        Safe to re-run after a live migration: the doc's FUTURE records
        route to its new shard's partition, whose owner resumes the doc's
        summary chain by summary adoption from the shared refs/object
        store; records already in the old partition drain under the
        ordinary at-least-once contract (acks are idempotent by seq
        floor, so the handoff can never double-ack).  Pins to members
        that later die fall back to round-robin (ConsumerGroup.pin).

        Co-location is exact when ``n_partitions >= n_shards``.  With
        fewer partitions than shards, shards collide on
        ``shard % n_partitions``; each colliding partition pins ONCE, to
        the lowest colliding shard's member (deterministic — never a
        last-doc-wins flip-flop that churns the group generation), and
        the higher shard's docs are summarized by that member
        (consistent, merely not co-located).  Returns the
        partition -> member ownership map."""
        members = sorted(self.members)
        n_parts = self.topic.n_partitions
        part_shard: dict[int, int] = {}
        for _doc, shard in placement.items():
            p = shard % n_parts
            part_shard[p] = min(shard, part_shard.get(p, shard))
        ownership: dict[int, str] = {}
        for p, shard in sorted(part_shard.items()):
            if members:
                owner = members[shard % len(members)]
                self.group.pin(p, owner)
                ownership[p] = owner
        for doc, shard in sorted(placement.items()):
            self.topic.place(doc, shard % n_parts)
        return ownership

    def compact(self, extra_groups: tuple = ()) -> dict:
        """Pool-safe compaction: fold the SHARED refs union into one member
        before flooring, so a doc tracked only by a peer (or only on disk
        after a kill) still pins its partition's truncation floor — a
        member compacting from its private view alone could reclaim tail
        records a cold boot-from-summary of a peer's doc still needs."""
        import json as _json
        import os

        if not self.members:
            return {}  # nobody to compact through; reclaim nothing
        lead = next(iter(self.members.values()))
        refs_path = os.path.join(self.directory, "refs.json")
        if os.path.exists(refs_path):
            try:
                with open(refs_path) as f:
                    on_disk = _json.load(f)
            except (ValueError, OSError):
                on_disk = {}
            # Seed the lead's view directly from the one parse above
            # (_ref_for would re-open and re-parse refs.json per doc).
            for doc, ref in on_disk.items():
                if doc not in lead.refs and doc not in lead._dropped_refs:
                    lead.refs[doc] = dict(ref)
        return lead.compact(extra_groups=extra_groups)

    def health(self) -> dict:
        return {m: s.health() for m, s in sorted(self.members.items())}

    def close(self) -> None:
        self.store.close()
