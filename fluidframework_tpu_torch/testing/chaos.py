"""Chaos controller + soak harness over the full serving stack.

A port of ``fluidframework_tpu/testing/chaos.py`` (no JAX in it).  The
engines, their warm standbys, their checkpoint restores and the scribe
pool's K10 batches run on ``device`` (``ChaosStack``/``run_chaos``/
``run_soak`` take ``device=``, the card by default; ``device="cpu"`` runs
the plain PyTorch programs).  Two knobs the reference does not have:

- ``tree_shards`` (default 8): the tree engine's mesh is
  ``doc_mesh([device] * tree_shards)`` with ``2 * tree_shards`` spare
  slots, every shard on the one device.  The reference takes one shard a
  JAX device (8 on its CPU test platform, 1 on one chip), so the port's
  ``migrate`` fault makes real moves on one card too.
- ``native_sequencer`` (default False, the reference's behaviour): the
  service plane's per-document sequencers are the native deli
  (``native.NativeSequencer``, through ``server.lambdas._make_sequencer``,
  which falls back to the Python ``Sequencer`` when the library cannot be
  built).  Both make the same sequencing decisions.

The report carries two keys of the port's own: ``devices`` (the device of
each engine's state) and ``sequencer`` (the class that sequenced the
plane's documents).

The server-side counterpart of ``driver/fault_injection.py`` (which mirrors
test-service-load's client-side FaultInjectionDocumentServiceFactory): a
SEEDED, DETERMINISTIC fault schedule applied to the real composed stack —
netserver ``ServicePlane`` (admission-controlled TCP/HTTP fronts over real
sockets), a durable op topic + ``ScribePool``, and a MIXED device fleet:
a ``FleetConsumer`` feeding a checkpointed ``DocBatchEngine`` (string docs)
plus, when ``tree_doc_ids`` are given, a second consumer feeding a
``TreeBatchEngine`` (tree docs) — both families restored from the same
durable-checkpoint contract.  SharedString AND SharedTree writers drive
one Zipf document popularity ranking with connect/disconnect churn through
the driver-layer nack/backoff contract.

Fault kinds (``ChaosSchedule`` events; the schedule JSON round-trips so a
failing run's schedule can be committed as a regression):

- ``fleet_kill``      — crash the device-fleet tier (BOTH families when a
                        tree tier runs): consumers + engines are discarded,
                        successors restore from durable checkpoints — or a
                        warm standby promotes — and re-consume the firehose
                        (seq-floor dedupe makes the replay idempotent).
- ``torn_socket``     — hard-close one writer's TCP stream mid-session, no
                        leave handshake; a replacement client rejoins and
                        catches up from delta storage.
- ``nack_storm``      — the front sheds the next N submits for a document
                        (``AdmissionController.force_overload``); writers
                        back off per the jittered retry_after contract and
                        resubmit in place.
- ``scribe_kill``     — crash a ScribePool member (no flush, no goodbye).
- ``scribe_crash``    — crash a member MID-FOLD (``ScribeLambda.
                        chaos_abort_after_folds``): folded-but-uncommitted
                        state dies between the fold and its offset commit.
- ``fsync_delay`` /   — stall (then restore) every durable topic
  ``fsync_clear``       partition's appends, the slow-disk schedule.
- ``migrate``         — live mid-stream placement move: the target doc's
                        engine migrates it to another mesh shard while
                        writers keep submitting (skip-counted when the
                        engine runs unsharded or the doc sits in a
                        host-only lane the placement plane refuses).

Invariants checked (the run FAILS loudly, not statistically):

- **byte identity**: after quiescing, every document's device-fleet state ==
  a fault-free oracle replay of the server's sequenced log == every
  surviving writer's replica — ``RefMergeTree`` text for string docs, an
  EditManager + Forest replay (root-field node JSON) for tree docs.
- **no double-acks**: the scribe plane never externalizes two summaryAck
  records for the same (doc, seq).
- **bounded ingest**: no doc's staged queue ever exceeds the engine's high
  watermark plus one pump's slack (credit-based flow control holds under
  fault).

``run_chaos`` is the short seeded harness (tier-1 smoke); ``run_soak``
drives it at length with latency SLOs (p50/p99 under fault via the engine's
op-latency histograms), shed/pause/backoff counters, and an RSS bound —
the ``bench.py --config soak`` row.
"""

from __future__ import annotations

import contextlib
import json
import random
import time
from dataclasses import asdict, dataclass, field

from ..dds.mergetree_ref import RefMergeTree
from ..dds.shared_string import SharedString
from ..dds.tree.changeset import (
    apply_commit,
    commit_from_json,
    make_insert,
    make_move,
    make_remove,
    make_set_value,
)
from ..dds.tree.editmanager import EditManager
from ..dds.tree.forest import Forest
from ..dds.tree.schema import leaf
from ..dds.tree.shared_tree import SharedTreeChannel
from ..driver.definitions import DriverError
from ..driver.network_driver import HttpDeltaStorageService, NetworkDeltaConnection, _Http
from ..loader.connection_manager import BackoffPolicy
from ..protocol.channel import (
    ChannelDeltaConnection,
    ChannelMessage,
    MessageCollection,
    MessageEnvelope,
)
from ..protocol.messages import (
    DeltaType,
    MessageType,
    SequencedMessage,
    UnsequencedMessage,
)
from ..device import DEFAULT_DEVICE, resolve_device
from ..runtime.summary import parse_scribe_ack
from ..server.admission import AdmissionConfig, AdmissionController
from ..server.netserver import ServicePlane

# "migrate" is deliberately LAST: make_schedule draws per kind in tuple
# order, so appending keeps every pre-existing seeded schedule's events
# bit-identical (the committed-schedule regression contract).
EVENT_KINDS = (
    "fleet_kill", "torn_socket", "nack_storm",
    "scribe_kill", "scribe_crash", "fsync_delay", "migrate",
)


@dataclass
class ChaosEvent:
    tick: int
    kind: str
    target: str = ""   # doc id / member id ("" = schedule picks at runtime)
    param: float = 0.0  # kind-specific (storm length, fold count, delay s)


@dataclass
class ChaosSchedule:
    """A seeded fault schedule: same seed -> same events, committed as JSON
    (the schedule format documented in README "Overload & chaos")."""

    seed: int
    events: list = field(default_factory=list)

    def at(self, tick: int) -> list:
        return [e for e in self.events if e.tick == tick]

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "events": [asdict(e) for e in self.events]},
            indent=2,
        )

    @staticmethod
    def from_json(raw: str) -> "ChaosSchedule":
        d = json.loads(raw)
        return ChaosSchedule(
            seed=d["seed"], events=[ChaosEvent(**e) for e in d["events"]]
        )


def make_schedule(
    seed: int,
    ticks: int,
    doc_ids: list,
    kinds=EVENT_KINDS,
    events_per_kind: int = 1,
) -> ChaosSchedule:
    """Deterministic schedule from a seed: ``events_per_kind`` events of
    each kind, spread over the middle 80% of the run (faults at tick 0
    would race setup; faults at the very end test nothing — the quiesce
    phase would mask them).  ``fsync_delay`` events auto-pair with an
    ``fsync_clear`` a few ticks later."""
    rng = random.Random(seed)
    lo, hi = max(1, ticks // 10), max(2, ticks - ticks // 10)
    events: list = []
    for kind in kinds:
        for _ in range(events_per_kind):
            tick = rng.randrange(lo, hi)
            doc = rng.choice(doc_ids)
            if kind == "nack_storm":
                events.append(ChaosEvent(tick, kind, doc, rng.randrange(3, 9)))
            elif kind == "scribe_crash":
                events.append(ChaosEvent(tick, kind, "", rng.randrange(2, 6)))
            elif kind == "fsync_delay":
                events.append(ChaosEvent(tick, kind, "", 0.002))
                events.append(ChaosEvent(
                    min(tick + max(2, ticks // 10), ticks - 1), "fsync_clear"
                ))
            else:
                events.append(ChaosEvent(tick, kind, doc))
    events.sort(key=lambda e: (e.tick, e.kind, e.target))
    return ChaosSchedule(seed=seed, events=events)


class TornConnection(Exception):
    """The writer's connection died (torn socket / fatal nack): the harness
    replaces the writer with a fresh identity that catches up from storage."""


class _ChaosWireClient:
    """Shared raw-wire client machinery for both writer families.

    Implements the client half of the flow-control contract at the wire
    level (the loader's Container does the same through its layers): a
    retryable admission nack leaves the connection and clientSeq stream
    intact, so the writer waits the jittered, retry_after-floored delay and
    resubmits THE SAME op in place; a protocol nack or torn socket raises
    ``TornConnection`` and the harness re-enters with a fresh identity,
    catching up from delta storage.  Stop-and-wait submission (one op per
    server round-trip, ``sync`` as the settle barrier) keeps the clientSeq
    stream gap-free under interleaved shedding.

    Subclasses bind the replica family via ``_init_replica`` (build the
    replica before the connection exists — the live listener fires during
    connect), ``_apply`` (one sequenced message), and ``_assert_joined``.
    """

    MAX_RESUBMITS = 64

    def __init__(
        self,
        host: str,
        port: int,
        http_port: int,
        doc_id: str,
        base_id: str,
        rng: random.Random,
        sleep_cap_s: float = 0.05,
        backoff: BackoffPolicy | None = None,
    ) -> None:
        self.doc_id = doc_id
        self._host, self._port = host, port
        self._storage = HttpDeltaStorageService(
            _Http(host, http_port), doc_id
        )
        self.client_id = base_id
        self._rng = rng
        self._sleep_cap_s = sleep_cap_s
        self.backoff = backoff if backoff is not None else BackoffPolicy(
            rng=random.Random(rng.getrandbits(32)),
            initial_s=0.005, max_s=0.05, deadline_s=30.0,
        )
        self.nack_backoffs = 0
        self.ops_submitted = 0
        self.last_seq = 0
        self._nacked = None
        self._init_replica()
        self.conn = NetworkDeltaConnection(
            host, port, doc_id, base_id, "write",
            listener=self._on_msg, nack_listener=self._on_nack,
            signal_listener=None,
        )
        # Catch-up: the delivered prefix from delta storage (the driver's
        # snapshot->stream gap repair), then pump until our join lands.
        if self.conn.checkpoint_seq > 0:
            for m in self._storage.get_deltas(1, self.conn.checkpoint_seq):
                self._apply(m)
        self.conn.sync()
        self._assert_joined()

    # ------------------------------------------------------- family hooks
    def _init_replica(self) -> None:
        raise NotImplementedError

    def _apply(self, msg: SequencedMessage) -> None:
        raise NotImplementedError

    def _assert_joined(self) -> None:
        raise NotImplementedError

    # ---------------------------------------------------------------- inbound
    def _on_msg(self, msg: SequencedMessage) -> None:
        self._apply(msg)

    def _on_nack(self, nack) -> None:
        self._nacked = nack

    # --------------------------------------------------------------- outbound
    def _submit_one(self, m) -> None:
        for _attempt in range(self.MAX_RESUBMITS):
            if not self.conn.connected:
                raise TornConnection(self.client_id)
            self._nacked = None
            try:
                self.conn.submit(m)
                self.conn.sync()
            except (DriverError, OSError) as e:
                raise TornConnection(f"{self.client_id}: {e}") from e
            if self._nacked is None:
                self.ops_submitted += 1
                self.backoff.reset()
                return
            if not self.conn.connected:
                raise TornConnection(
                    f"{self.client_id}: fatal nack {self._nacked.reason}"
                )
            # Retryable admission shed: same op, same clientSeq, after the
            # jittered retry_after-floored delay (capped in harness time;
            # only the capped sleep actually taken counts as spent).
            self.nack_backoffs += 1
            delay = min(
                self.backoff.next_delay(self._nacked.retry_after),
                self._sleep_cap_s,
            )
            time.sleep(delay)
            self.backoff.consume(delay)
        raise TornConnection(
            f"{self.client_id}: op never admitted after "
            f"{self.MAX_RESUBMITS} resubmits"
        )

    def settle(self) -> None:
        """Dispatch everything the server already broadcast to us; raises
        ``TornConnection`` on a dead stream (a frozen replica must be
        REPLACED, never silently compared against live state)."""
        if not self.conn.connected:
            raise TornConnection(self.client_id)
        self.conn.sync()

    # ------------------------------------------------------------------ fault
    def tear(self) -> None:
        """Hard socket kill: no disconnect handshake (the torn-socket
        fault).  ``shutdown`` (not ``close``) actually severs the TCP
        stream — a plain close defers while the reader's makefile holds a
        reference.  The server discovers EOF and broadcasts our leave."""
        import socket as _socket

        with contextlib.suppress(OSError):
            self.conn._sock.shutdown(_socket.SHUT_RDWR)

    def close(self) -> None:
        if self.conn.connected:
            with contextlib.suppress(DriverError, OSError):
                self.conn.disconnect()


class ChaosWriter(_ChaosWireClient):
    """One raw-wire SharedString client over a real TCP delta connection
    (see ``_ChaosWireClient`` for the flow-control contract it rides)."""

    def _init_replica(self) -> None:
        self.replica = SharedString(client_id=self.client_id)

    def _assert_joined(self) -> None:
        assert self.replica.short_client >= 0, "join not delivered"

    def _apply(self, msg: SequencedMessage) -> None:
        if msg.seq <= self.last_seq:
            return  # catch-up / live-stream overlap
        self.last_seq = msg.seq
        self.replica.process(msg)

    def edit(self) -> None:
        """One rng-driven edit staged on the replica (not yet submitted)."""
        text = self.replica.text
        n = len(text)
        if self._rng.random() < 0.7 or n < 4:
            self.replica.insert_text(
                self._rng.randint(0, n),
                "".join(self._rng.choice("abcdefgh")
                        for _ in range(self._rng.randint(1, 6))),
            )
        else:
            p = self._rng.randint(0, n - 2)
            self.replica.remove_range(p, p + 1)

    def flush(self) -> int:
        """Submit the staged outbox stop-and-wait; returns ops sequenced.
        Honors retryable admission nacks with jittered backoff in place;
        raises TornConnection on teardown."""
        sent = 0
        for m in self.replica.take_outbox():
            self._submit_one(m)
            sent += 1
        return sent


class ChaosTreeWriter(_ChaosWireClient):
    """One raw-wire SharedTree client over a real TCP delta connection.

    The tree-family counterpart of ``ChaosWriter``: a full
    ``SharedTreeChannel`` replica (EditManager + forest with the
    optimistic local branch) attached through a ``ChannelDeltaConnection``
    shim whose submit path stages wire contents into an outbox; ``flush``
    mints the same stop-and-wait ``UnsequencedMessage`` stream the string
    writer uses, so admission nacks, torn sockets, and delta-storage
    catch-up ride the identical driver contract.  Inbound sequenced
    messages bridge back as single-message collections; our own ops come
    back flagged local (the channel's pending-FIFO ack)."""

    def _init_replica(self) -> None:
        self.tree = SharedTreeChannel("t")
        self._outbox: list = []
        self._client_seq = 0
        self._joined = False
        shim = ChannelDeltaConnection(
            submit_fn=lambda contents, md=None, internal=False: (
                self._outbox.append(contents)
            ),
            quorum_fn=lambda cid: 0,
            client_id_fn=lambda: self.client_id,
        )
        shim.connected = True
        self.tree.connect(shim)

    def _assert_joined(self) -> None:
        assert self._joined, "join not delivered"

    def _apply(self, msg: SequencedMessage) -> None:
        if msg.seq <= self.last_seq:
            return  # catch-up / live-stream overlap
        self.last_seq = msg.seq
        if msg.type == MessageType.JOIN:
            if msg.contents.get("clientId") == self.client_id:
                self._joined = True
            return
        if msg.type != MessageType.OP:
            return
        self.tree.process_messages(MessageCollection(
            envelope=MessageEnvelope(
                client_id=msg.client_id, seq=msg.seq,
                min_seq=msg.min_seq, ref_seq=msg.ref_seq,
            ),
            messages=[ChannelMessage(
                contents=msg.contents,
                local=(msg.client_id == self.client_id),
            )],
        ))

    def root_json(self) -> list:
        """The replica's root field as node JSON (the identity surface)."""
        return [n.to_json() for n in self.tree.forest.root_field]

    def edit(self) -> None:
        """One rng-driven tree edit staged on the channel outbox (same op
        mix as the differential engine tests, nested edits included)."""
        t, rng = self.tree, self._rng
        n = len(t.forest.root_field)
        kind = rng.choices(
            ["ins", "rm", "set", "move", "nested"], [5, 3, 3, 3, 1]
        )[0]
        if kind == "ins" or n == 0:
            t.submit_change(make_insert(
                [], "", rng.randint(0, n), [leaf(rng.randrange(1000))]
            ))
        elif kind == "rm":
            i = rng.randrange(n)
            t.submit_change(
                make_remove([], "", i, rng.randint(1, min(2, n - i)))
            )
        elif kind == "set":
            t.submit_change(
                make_set_value([("", rng.randrange(n))], rng.randrange(1000))
            )
        elif kind == "move":
            s = rng.randrange(n)
            c = rng.randint(1, min(2, n - s))
            t.submit_change(make_move([], "", s, c, rng.randint(0, n)))
        else:
            t.submit_change(
                make_insert([("", rng.randrange(n))], "sub", 0, [leaf(7)])
            )

    def flush(self) -> int:
        """Wire the staged channel outbox stop-and-wait (one
        ``UnsequencedMessage`` per edit, gap-free clientSeq stream)."""
        sent = 0
        out, self._outbox = self._outbox, []
        for contents in out:
            self._client_seq += 1
            self._submit_one(UnsequencedMessage(
                client_id=self.client_id, client_seq=self._client_seq,
                ref_seq=self.last_seq, type=MessageType.OP,
                contents=contents,
            ))
            sent += 1
        return sent


class ChaosStack:
    """The composed stack under test + the fault controller driving it."""

    def __init__(
        self,
        seed: int,
        doc_ids: list,
        workdir: str,
        writers_per_doc: int = 2,
        zipf_a: float = 1.1,
        churn_rate: float = 0.05,
        ops_per_tick: int = 6,
        step_every: int = 2,
        checkpoint_every: int = 32,
        megastep_k: int = 2,
        ops_per_step: int = 8,
        admission: AdmissionConfig | None = None,
        scribe_members: int = 2,
        standby: bool = False,
        ckpt_stale_seconds: float = 0.0,
        recovery_bound_s: float = 30.0,
        tree_doc_ids: list | None = None,
        device=DEFAULT_DEVICE,
        tree_shards: int = 8,
        native_sequencer: bool = False,
    ) -> None:
        # Resolved first: a stack asked for the card on a machine without
        # one raises before any socket or thread exists.
        self.device = resolve_device(device)
        self.tree_shards = tree_shards
        self.native_sequencer = native_sequencer
        self.rng = random.Random(seed)
        self.doc_ids = list(doc_ids)
        # Tree tier (mixed fleets): ``tree_doc_ids`` adds a second
        # engine family — its own FleetConsumer + TreeBatchEngine +
        # checkpoint store + warm standby — sharing the service plane, the
        # scribe pool, and one Zipf popularity ranking with the string
        # docs.  Empty keeps the string-only stack byte-for-byte unchanged.
        self.tree_doc_ids = list(tree_doc_ids or [])
        self.all_doc_ids = self.doc_ids + self.tree_doc_ids
        self._family = {d: "tree" for d in self.tree_doc_ids}
        self.workdir = workdir
        self.churn_rate = churn_rate
        self.ops_per_tick = ops_per_tick
        self.step_every = max(1, step_every)
        # Fast-recovery plane knobs: ``standby`` keeps a warm
        # pre-compiled, checkpoint-trailing engine ready so fleet_kill
        # promotes instead of cold-booting; ``ckpt_stale_seconds`` runs
        # the bounded-staleness background checkpoint writer so the
        # replay tail stays small; ``recovery_bound_s`` is the hard
        # per-incident invariant bound (kill -> first post-restore op).
        self.standby_enabled = standby
        self.ckpt_stale_seconds = ckpt_stale_seconds
        self.recovery_bound_s = recovery_bound_s
        self.standby = None
        self.tree_standby = None
        self._ckpt_writer = None
        self._tree_ckpt_writer = None
        self._recovery_ms: list = []  # per-incident, authoritative
        self._tree_recovery_ms: list = []
        self._engine_incidents_seen = 0
        self._tree_incidents_seen = 0
        # Kills that landed while the previous incident was still open
        # fold into it (earliest start wins), so N kills can resolve into
        # N - merged measured incidents; the invariant accounts for this.
        self._merged_kills = 0
        self._tree_merged_kills = 0
        self.counters = {
            "ticks": 0, "ops_sequenced": 0, "torn_sockets": 0,
            "fleet_restarts": 0, "scribe_kills": 0, "scribe_crashes": 0,
            "writer_replacements": 0, "churn_disconnects": 0,
            "churn_joins": 0, "nack_backoffs": 0, "standby_promotions": 0,
            "doc_migrations": 0, "migrations_skipped": 0,
        }
        self.max_queue_depth = 0
        self.max_tree_queue_depth = 0
        self._writer_serial = 0
        self._retired_nack_backoffs = 0  # counts from replaced/closed writers

        # Zipf popularity over BOTH families' docs as one ranking (rank 0
        # hottest; string docs first, so string-only stacks are unchanged).
        weights = [
            1.0 / (i + 1) ** zipf_a for i in range(len(self.all_doc_ids))
        ]
        self._weights = weights

        # ---- service plane (admission-controlled fronts over real sockets)
        self.admission = AdmissionController(
            admission if admission is not None else AdmissionConfig(
                max_pending=2048, max_consumer_backlog=256,
                base_retry_after_s=0.005, max_retry_after_s=0.05,
            )
        )
        self.plane = ServicePlane(admission=self.admission).start()
        if native_sequencer:
            # Every document exists, on the native deli, before a client
            # connects: its sequencer is the one that ever ticketed it.
            from ..server.lambdas import _make_sequencer

            with self.plane.nexus.lock:
                for d in self.all_doc_ids:
                    self.plane.service.document(d).sequencer = _make_sequencer(True)
        try:
            self._build(doc_ids, workdir, writers_per_doc, checkpoint_every,
                        megastep_k, ops_per_step, scribe_members)
        except BaseException:
            self.close()  # a failed setup must not leak the stack
            raise

    def _build(self, doc_ids, workdir, writers_per_doc, checkpoint_every,
               megastep_k, ops_per_step, scribe_members) -> None:
        import os

        from ..models.doc_batch_engine import DocBatchEngine
        from ..server.fleet_consumer import FleetConsumer
        from ..server.ordered_log import CheckpointStore, DurableTopic
        from ..server.partition_manager import ScribePool
        from ..server.scribe import ScribeConfig

        # ---- device fleet tier (checkpointed; tight watermarks)
        self._engine_cls = DocBatchEngine
        self._consumer_cls = FleetConsumer
        self.checkpoint_store = CheckpointStore(
            os.path.join(workdir, "checkpoints")
        )
        self._engine_kw = dict(
            max_segments=512, text_capacity=8192, max_insert_len=8,
            ops_per_step=ops_per_step, megastep_k=megastep_k, use_mesh=False,
            checkpoint_store=self.checkpoint_store,
            checkpoint_every=checkpoint_every, doc_keys=list(doc_ids),
            latency_sample_every=4, device=self.device,
        )
        self.engine = None
        self.consumer = None
        self._boot_fleet()
        if self.standby_enabled:
            self._make_standby()
        self._start_ckpt_writer()

        # ---- tree device fleet tier (second family, own durable store)
        self.tree_engine = None
        self.tree_consumer = None
        if self.tree_doc_ids:
            from ..parallel.mesh import doc_mesh

            self.tree_checkpoint_store = CheckpointStore(
                os.path.join(workdir, "tree-checkpoints")
            )
            # A mesh of ``tree_shards`` shards (all on ``device``) gives the
            # tree engine >1 shard, making the ``migrate`` fault a LIVE
            # mid-stream placement move; one shard degrades to
            # skip-counted migrations, everything else identical.
            mesh = (
                doc_mesh([self.device] * self.tree_shards)
                if self.tree_shards > 1
                else None
            )
            self._tree_engine_kw = dict(
                capacity=256, pool_capacity=1024, max_insert_len=4,
                ops_per_step=ops_per_step, megastep_k=megastep_k,
                mesh=mesh,
                spare_slots=2 * self.tree_shards if mesh else 1,
                checkpoint_store=self.tree_checkpoint_store,
                checkpoint_every=checkpoint_every,
                doc_keys=list(self.tree_doc_ids),
                device=self.device,
            )
            self._boot_tree_fleet()
            if self.standby_enabled:
                self._make_tree_standby()
            self._start_tree_ckpt_writer()

        # ---- scribe plane (durable topic mirror + member pool)
        self.topic = DurableTopic(
            "deltas", 2, os.path.join(workdir, "topic"),
            encode=lambda m: m.to_json(),
            decode=SequencedMessage.from_json,
        )
        self.pool = ScribePool(
            self.topic, os.path.join(workdir, "scribe"),
            config=ScribeConfig(max_ops=16), device=self.device,
        )
        self._scribe_serial = 0
        for _ in range(scribe_members):
            self._add_scribe_member()
        self._mirror_cursor = {d: 0 for d in self.all_doc_ids}

        # ---- writers (both families; _add_writer picks the class)
        self.writers: dict[str, list] = {d: [] for d in self.all_doc_ids}
        for d in self.all_doc_ids:
            for _ in range(writers_per_doc):
                self._add_writer(d)

    # ----------------------------------------------------------------- boot
    def _boot_fleet(self) -> None:
        """(Re)build the fleet tier: engine restored from durable
        checkpoints, consumer re-reading the firehose (seq-floor dedupe
        skips everything the checkpoints cover)."""
        eng = self._engine_cls(len(self.doc_ids), **self._engine_kw)
        eng.restore_from_checkpoints()
        self.engine = eng
        self._engine_incidents_seen = 0
        self.consumer = self._consumer_cls(
            "127.0.0.1", self.plane.nexus.port, eng, self.doc_ids
        )

    def _boot_tree_fleet(self) -> None:
        """(Re)build the tree tier the same way: engine restored from ITS
        durable checkpoints, consumer re-reading the firehose."""
        from ..models.tree_batch_engine import TreeBatchEngine

        eng = TreeBatchEngine(len(self.tree_doc_ids), **self._tree_engine_kw)
        eng.restore_from_checkpoints()
        self.tree_engine = eng
        self._tree_incidents_seen = 0
        self.tree_consumer = self._consumer_cls(
            "127.0.0.1", self.plane.nexus.port, eng, self.tree_doc_ids
        )

    # ------------------------------------------------------ recovery plane
    def _make_standby(self) -> None:
        """Spin up the NEXT warm standby: a fresh engine with its serving
        programs pre-compiled and the current checkpoints adopted, kept
        trailing by ``tick`` until a fleet_kill promotes it."""
        from ..server.failover import WarmStandby

        eng = self._engine_cls(len(self.doc_ids), **self._engine_kw)
        self.standby = WarmStandby(
            eng, self.checkpoint_store, lease=None
        ).prepare()

    def _make_tree_standby(self) -> None:
        """The tree family's warm standby: same WarmStandby machinery over
        a TreeBatchEngine (in-place pooled-column re-seed on trail)."""
        from ..models.tree_batch_engine import TreeBatchEngine
        from ..server.failover import WarmStandby

        eng = TreeBatchEngine(len(self.tree_doc_ids), **self._tree_engine_kw)
        self.tree_standby = WarmStandby(
            eng, self.tree_checkpoint_store, lease=None
        ).prepare()

    def _start_ckpt_writer(self) -> None:
        """(Re)arm the bounded-staleness background checkpoint writer on
        the CURRENT engine (a killed engine's writer is stopped with it)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.stop()
            self._ckpt_writer = None
        if self.ckpt_stale_seconds:
            from ..models.recovery import BackgroundCheckpointWriter

            self._ckpt_writer = BackgroundCheckpointWriter(
                self.engine,
                max_seconds_behind=self.ckpt_stale_seconds,
                interval_s=max(0.02, self.ckpt_stale_seconds / 2),
            ).start()

    def _start_tree_ckpt_writer(self) -> None:
        if self._tree_ckpt_writer is not None:
            self._tree_ckpt_writer.stop()
            self._tree_ckpt_writer = None
        if self.ckpt_stale_seconds:
            from ..models.recovery import BackgroundCheckpointWriter

            self._tree_ckpt_writer = BackgroundCheckpointWriter(
                self.tree_engine,
                max_seconds_behind=self.ckpt_stale_seconds,
                interval_s=max(0.02, self.ckpt_stale_seconds / 2),
            ).start()

    def _poll_recovery(self) -> None:
        """Harvest newly completed recovery incidents off the current
        engines into the per-FAMILY incident lists (incidents complete
        one at a time — a new one only begins at the next kill)."""
        tr = self.engine.recovery_tracker
        while self._engine_incidents_seen < tr.incidents:
            self._engine_incidents_seen += 1
            self._recovery_ms.append(tr.last_ms)
        if self.tree_engine is not None:
            tr = self.tree_engine.recovery_tracker
            while self._tree_incidents_seen < tr.incidents:
                self._tree_incidents_seen += 1
                self._tree_recovery_ms.append(tr.last_ms)

    @staticmethod
    def _pct(ms: list, q: float):
        if not ms:
            return None
        import math

        return ms[max(1, math.ceil(q * len(ms))) - 1]

    def recovery_report(self) -> dict:
        """The per-incident recovery surface (report + invariants):
        exact per-FAMILY percentiles over the measured kill ->
        first-applied-op intervals."""
        self._poll_recovery()
        ms = sorted(self._recovery_ms)
        rep = {
            "incidents": len(ms),
            "open": int(self.engine.recovery_tracker.active),
            "standby": self.standby_enabled,
            "recovery_p50_ms": self._pct(ms, 0.5),
            "recovery_p99_ms": self._pct(ms, 0.99),
            "recovery_max_ms": ms[-1] if ms else None,
            "intervals_ms": list(self._recovery_ms),
            "merged_kills": self._merged_kills,
        }
        if self.tree_engine is not None:
            tms = sorted(self._tree_recovery_ms)
            rep.update({
                "tree_incidents": len(tms),
                "tree_open": int(self.tree_engine.recovery_tracker.active),
                "tree_recovery_p50_ms": self._pct(tms, 0.5),
                "tree_recovery_p99_ms": self._pct(tms, 0.99),
                "tree_recovery_max_ms": tms[-1] if tms else None,
                "tree_intervals_ms": list(self._tree_recovery_ms),
                "tree_merged_kills": self._tree_merged_kills,
            })
        return rep

    def _add_writer(self, doc_id: str) -> _ChaosWireClient:
        self._writer_serial += 1
        cls = (
            ChaosTreeWriter if self._family.get(doc_id) == "tree"
            else ChaosWriter
        )
        w = cls(
            "127.0.0.1", self.plane.nexus.port, self.plane.http.port,
            doc_id, f"{doc_id}-w{self._writer_serial}",
            random.Random(self.rng.getrandbits(32)),
        )
        self.writers[doc_id].append(w)
        return w

    def _add_scribe_member(self):
        self._scribe_serial += 1
        return self.pool.add_member(f"scribe{self._scribe_serial}")

    # ----------------------------------------------------------------- tick
    def tick(self, t: int, schedule: ChaosSchedule) -> None:
        from ..server.scribe import ChaosCrash

        self.counters["ticks"] += 1
        for ev in schedule.at(t):
            self._fire(ev)

        # Connect/disconnect churn: a writer leaves gracefully, a fresh
        # identity joins elsewhere (both rng-driven, both Zipf-weighted).
        if self.rng.random() < self.churn_rate:
            doc = self._pick_doc()
            if len(self.writers[doc]) > 1:
                w = self.writers[doc].pop(self.rng.randrange(len(self.writers[doc])))
                self._retired_nack_backoffs += w.nack_backoffs
                w.close()
                self.counters["churn_disconnects"] += 1
        if self.rng.random() < self.churn_rate:
            self._add_writer(self._pick_doc())
            self.counters["churn_joins"] += 1

        # Zipf-popular traffic through the admission-controlled front.
        for _ in range(self.ops_per_tick):
            doc = self._pick_doc()
            if not self.writers[doc]:
                self._add_writer(doc)
            w = self.rng.choice(self.writers[doc])
            try:
                w.edit()
                self.counters["ops_sequenced"] += w.flush()
            except TornConnection:
                self._replace_writer(w)
        self.counters["nack_backoffs"] = self._retired_nack_backoffs + sum(
            x.nack_backoffs for ws in self.writers.values() for x in ws
        )

        # Every writer drains its broadcast backlog (replicas stay live; a
        # torn one is replaced so a frozen replica never masquerades).
        for ws in self.writers.values():
            for w in list(ws):
                try:
                    w.settle()
                except (TornConnection, DriverError, OSError):
                    self._replace_writer(w)

        # Fleet tiers: pump (flow-control-gated), step on cadence.
        self.consumer.pump(wait_s=0.005)
        if t % self.step_every == 0:
            self.consumer.step()
        if self.tree_consumer is not None:
            self.tree_consumer.pump(wait_s=0.005)
            if t % self.step_every == 0:
                self.tree_consumer.step()
        # Recovery plane: the warm standby trails the checkpoint dir so
        # promotion is O(dirty tail); completed incidents harvest into
        # the per-incident list the invariants assert over.  The NEXT
        # standby after a promotion builds here, and only once the open
        # incident closed — building it inside the kill handler while the
        # incident is still open (empty post-kill tail) would fold its
        # warmup compiles into the measured recovery interval.
        if self.standby is not None:
            self.standby.trail()
        elif (
            self.standby_enabled
            and not self.engine.recovery_tracker.active
        ):
            self._make_standby()
        if self.tree_engine is not None:
            if self.tree_standby is not None:
                self.tree_standby.trail()
            elif (
                self.standby_enabled
                and not self.tree_engine.recovery_tracker.active
            ):
                self._make_tree_standby()
        self._poll_recovery()

        # Scribe plane: mirror the new sequenced records into the durable
        # topic, pump the pool (a ChaosCrash kills the member mid-fold and
        # a successor joins — the at-least-once re-read path).
        self._mirror_log()
        try:
            self.pool.pump()
        except ChaosCrash:
            crashed = [
                mid for mid, m in self.pool.members.items()
                if m.chaos_abort_after_folds == 0 and getattr(
                    m, "_chaos_armed", False
                )
            ]
            for mid in crashed or list(self.pool.members)[:1]:
                self.pool.kill_member(mid)
                self.counters["scribe_crashes"] += 1
            self._add_scribe_member()

        # Bounded-ingest invariant: the watermark gate must hold the line
        # even while faults fire (checked EVERY tick, not at the end).
        depth = max(
            (len(h.queue) for h in self.engine.hosts), default=0
        )
        self.max_queue_depth = max(self.max_queue_depth, depth)
        bound = self._depth_bound()
        if depth > bound:
            raise AssertionError(
                f"tick {t}: staged queue depth {depth} exceeded bound "
                f"{bound} (high watermark {self.engine.overload_gate.high})"
            )
        if self.tree_engine is not None:
            depth = max(
                (len(h.queue) for h in self.tree_engine.hosts), default=0
            )
            self.max_tree_queue_depth = max(self.max_tree_queue_depth, depth)
            bound = self._tree_depth_bound()
            if depth > bound:
                raise AssertionError(
                    f"tick {t}: tree staged queue depth {depth} exceeded "
                    f"bound {bound} (high watermark "
                    f"{self.tree_engine.overload_gate.high})"
                )

    def _depth_bound(self) -> int:
        # One pump can stage at most the post-checkpoint catch-up tail on
        # top of the high watermark before the gate pauses the partition.
        return (
            self.engine.overload_gate.high
            + self._engine_kw["checkpoint_every"]
            + 4 * self.ops_per_tick
        )

    def _tree_depth_bound(self) -> int:
        # Same shape as _depth_bound with one twist: a tree wire op can
        # flatten into a couple of staged rows, so the catch-up tail and
        # per-tick slack carry a 2x row-expansion factor.
        return (
            self.tree_engine.overload_gate.high
            + 2 * self._tree_engine_kw["checkpoint_every"]
            + 8 * self.ops_per_tick
        )

    def _pick_doc(self) -> str:
        return self.rng.choices(
            self.all_doc_ids, weights=self._weights, k=1
        )[0]

    def _replace_writer(self, w: _ChaosWireClient) -> None:
        ws = self.writers[w.doc_id]
        if w in ws:
            ws.remove(w)
        self._retired_nack_backoffs += w.nack_backoffs
        w.close()
        self._add_writer(w.doc_id)
        self.counters["writer_replacements"] += 1

    # ---------------------------------------------------------------- faults
    def _fire(self, ev: ChaosEvent) -> None:
        if ev.kind == "fleet_kill":
            t0 = time.monotonic()
            self.consumer.close()
            if self._ckpt_writer is not None:
                self._ckpt_writer.stop()
                self._ckpt_writer = None
            self._poll_recovery()  # harvest the dying engine's incidents
            # A kill landing while the PREVIOUS incident is still open
            # (no op applied between two kills) must not drop it: the
            # unresolved window carries onto the successor — earliest
            # start wins, so the measured interval spans the first kill.
            open_t0 = self.engine.recovery_tracker.started_at
            if open_t0 is not None:
                t0 = min(t0, open_t0)
                self._merged_kills += 1
            if self.standby is not None:
                # Warm failover: the trailing standby promotes — final
                # checkpoint adoption only, programs already compiled.
                eng = self.standby.promote(incident_started_at=t0)
                self.standby = None
                self.engine = eng
                self._engine_incidents_seen = 0
                self.consumer = self._consumer_cls(
                    "127.0.0.1", self.plane.nexus.port, eng, self.doc_ids
                )
                self.counters["standby_promotions"] += 1
            else:
                self._boot_fleet()
                self.engine.note_incident(t0)
            self.counters["fleet_restarts"] += 1
            # Catch up NOW — a real failover pumps the moment it owns the
            # firehose; the incident closes at the first op actually
            # applied post-restore (kill -> first post-restore ack).
            self.consumer.pump(wait_s=0.005)
            self.consumer.step()
            self._start_ckpt_writer()
            if self.standby_enabled and not self.engine.recovery_tracker.active:
                # The NEXT standby spins up after the measured promote
                # (its boot cost is standby-build time, not recovery).
                # With the incident still open (empty post-kill tail) the
                # tick hook builds it once the incident closes instead —
                # warmup compiles must not inflate the measured window.
                self._make_standby()
            # The tree tier dies with the same fleet process: promote its
            # standby (in-place pooled-column re-seed already done by
            # trail) or cold-boot from its durable checkpoint store.
            if self.tree_engine is not None:
                t0t = time.monotonic()
                self.tree_consumer.close()
                if self._tree_ckpt_writer is not None:
                    self._tree_ckpt_writer.stop()
                    self._tree_ckpt_writer = None
                open_t0 = self.tree_engine.recovery_tracker.started_at
                if open_t0 is not None:
                    t0t = min(t0t, open_t0)
                    self._tree_merged_kills += 1
                if self.tree_standby is not None:
                    eng = self.tree_standby.promote(incident_started_at=t0t)
                    self.tree_standby = None
                    self.tree_engine = eng
                    self._tree_incidents_seen = 0
                    self.tree_consumer = self._consumer_cls(
                        "127.0.0.1", self.plane.nexus.port, eng,
                        self.tree_doc_ids,
                    )
                    self.counters["standby_promotions"] += 1
                else:
                    self._boot_tree_fleet()
                    self.tree_engine.note_incident(t0t)
                self.tree_consumer.pump(wait_s=0.005)
                self.tree_consumer.step()
                self._start_tree_ckpt_writer()
                if (
                    self.standby_enabled
                    and not self.tree_engine.recovery_tracker.active
                ):
                    self._make_tree_standby()
        elif ev.kind == "migrate":
            # Live mid-stream placement move: writers keep submitting while
            # the engine folds + re-materializes the doc on another shard.
            # Unsharded engines and host-lane docs (seg-lane/overflow/
            # fallback — the placement plane refuses those loudly) count as
            # skips, so the fault degrades gracefully off-mesh.
            from ..models.placement import PlacementError

            doc = ev.target or self._pick_doc()
            if self._family.get(doc) == "tree":
                eng, i = self.tree_engine, self.tree_doc_ids.index(doc)
            else:
                eng, i = self.engine, self.doc_ids.index(doc)
            moved = False
            if eng is not None and eng.n_shards > 1:
                for dst in range(eng.n_shards):
                    try:
                        moved = eng.migrate_doc(i, dst)
                    except PlacementError:
                        break
                    if moved:
                        break
            self.counters["doc_migrations" if moved else
                          "migrations_skipped"] += 1
        elif ev.kind == "torn_socket":
            doc = ev.target or self._pick_doc()
            if self.writers[doc]:
                w = self.rng.choice(self.writers[doc])
                w.tear()
                self.counters["torn_sockets"] += 1
        elif ev.kind == "nack_storm":
            doc = ev.target or self._pick_doc()
            self.admission.force_overload(doc, int(ev.param) or 4)
        elif ev.kind == "scribe_kill":
            if self.pool.members:
                mid = self.rng.choice(sorted(self.pool.members))
                self.pool.kill_member(mid)
                self.counters["scribe_kills"] += 1
                self._add_scribe_member()
        elif ev.kind == "scribe_crash":
            if self.pool.members:
                mid = self.rng.choice(sorted(self.pool.members))
                m = self.pool.members[mid]
                m.chaos_abort_after_folds = int(ev.param) or 2
                m._chaos_armed = True
        elif ev.kind == "fsync_delay":
            self.topic.set_fault_flush_delay(ev.param or 0.002)
        elif ev.kind == "fsync_clear":
            self.topic.set_fault_flush_delay(0.0)
        else:
            raise ValueError(f"unknown chaos event kind {ev.kind!r}")

    def _mirror_log(self) -> None:
        """Feed the scribe plane the same total order the firehose carries
        (the deltas-topic produce seam, in-process)."""
        with self.plane.nexus.lock:
            for d in self.all_doc_ids:
                doc = self.plane.service.document(d)
                log = doc.sequencer.log
                cur = self._mirror_cursor[d]
                for msg in log[cur:]:
                    self.topic.produce(d, msg)
                self._mirror_cursor[d] = len(log)

    # -------------------------------------------------------------- quiesce
    def quiesce(self, max_rounds: int = 400) -> None:
        """Drain everything: writers settle, the fleet consumes every
        sequenced op (engine seq floor reaches the log head per doc), the
        scribe pool folds the mirrored tail."""
        for ws in self.writers.values():
            for w in list(ws):
                try:
                    w.settle()
                except (TornConnection, DriverError, OSError):
                    self._retired_nack_backoffs += w.nack_backoffs
                    ws.remove(w)
                    w.close()
        with self.plane.nexus.lock:
            want = {
                d: max(
                    (m.seq for m in
                     self.plane.service.document(d).sequencer.log
                     if m.type == MessageType.OP),
                    default=0,
                )
                for d in self.all_doc_ids
            }
        for _ in range(max_rounds):
            self.consumer.pump(wait_s=0.01)
            self.consumer.step()
            if self.tree_consumer is not None:
                self.tree_consumer.pump(wait_s=0.01)
                self.tree_consumer.step()
            if all(
                self.engine.hosts[i].last_seq >= want[d]
                for i, d in enumerate(self.doc_ids)
            ) and (
                self.tree_engine is None
                or all(
                    self.tree_engine.hosts[i].last_seq >= want[d]
                    for i, d in enumerate(self.tree_doc_ids)
                )
            ):
                break
        else:
            raise TimeoutError(
                f"fleet never caught up: "
                f"{[(d, self.engine.hosts[i].last_seq, want[d]) for i, d in enumerate(self.doc_ids)]}"
                + (
                    f" tree: {[(d, self.tree_engine.hosts[i].last_seq, want[d]) for i, d in enumerate(self.tree_doc_ids)]}"
                    if self.tree_engine is not None else ""
                )
            )
        self._mirror_log()
        self.pool.pump()

    # ----------------------------------------------------------- invariants
    def oracle_text(self, doc_id: str) -> str:
        """Fault-free replay of the server's sequenced log through the host
        reference merge tree — the byte-identity oracle."""
        with self.plane.nexus.lock:
            log = list(self.plane.service.document(doc_id).sequencer.log)
        tree = RefMergeTree()
        quorum: dict[str, int] = {}
        for msg in log:
            if msg.type == MessageType.JOIN:
                quorum[msg.contents["clientId"]] = msg.contents["short"]
            elif msg.type == MessageType.OP:
                c = msg.contents
                kind = c["type"]
                client = quorum[msg.client_id]
                if kind == DeltaType.INSERT:
                    tree.apply_insert(
                        c["pos1"], c["seg"], msg.seq, client, msg.ref_seq
                    )
                elif kind == DeltaType.REMOVE:
                    tree.apply_remove(
                        c["pos1"], c["pos2"], msg.seq, client, msg.ref_seq
                    )
                elif kind == DeltaType.ANNOTATE:
                    for prop, value in c["props"].items():
                        tree.apply_annotate(
                            c["pos1"], c["pos2"], int(prop), value,
                            msg.seq, client, msg.ref_seq,
                        )
        return tree.visible_text()

    def oracle_tree_json(self, doc_id: str) -> list:
        """Fault-free replay of the server's sequenced log through a host
        EditManager + Forest (the scribe's tree replica idiom) — the tree
        family's byte-identity oracle (root-field node JSON)."""
        with self.plane.nexus.lock:
            log = list(self.plane.service.document(doc_id).sequencer.log)
        em, forest = EditManager(), Forest()
        for msg in log:
            if msg.type != MessageType.OP:
                continue
            c = msg.contents
            trunk = em.add_sequenced(
                client_id=msg.client_id,
                revision=(c["sid"], c["rev"]),
                change=commit_from_json(c["changes"]),
                ref_seq=msg.ref_seq,
                seq=msg.seq,
            )
            em.advance_min_seq(msg.min_seq)
            apply_commit(forest.root, trunk)
        return [n.to_json() for n in forest.root_field]

    def check_invariants(self) -> dict:
        """Byte identity + no double-acks; raises AssertionError on any
        violation, returns the report fragment on success."""
        texts = {}
        for i, d in enumerate(self.doc_ids):
            oracle = self.oracle_text(d)
            fleet = self.engine.text(i)
            assert fleet == oracle, (
                f"{d}: fleet diverged from fault-free oracle replay\n"
                f"  fleet : {fleet!r}\n  oracle: {oracle!r}"
            )
            for w in self.writers[d]:
                assert w.replica.text == oracle, (
                    f"{d}: writer {w.client_id} diverged\n"
                    f"  writer: {w.replica.text!r}\n  oracle: {oracle!r}"
                )
            texts[d] = oracle
        assert not self.engine.errors().any(), "engine error bits latched"

        # Tree family: same HARD identity, against the EditManager+Forest
        # oracle — the device fleet's root-field JSON and every surviving
        # tree writer's replica must match byte-for-byte (device-lane and
        # host-fallback docs alike, across kills/promotes/migrations).
        tree_nodes = 0
        for i, d in enumerate(self.tree_doc_ids):
            oracle = self.oracle_tree_json(d)
            fleet = self.tree_engine.tree_json(i)
            assert fleet == oracle, (
                f"{d}: tree fleet diverged from fault-free oracle replay\n"
                f"  fleet : {fleet!r}\n  oracle: {oracle!r}"
            )
            for w in self.writers[d]:
                got = w.root_json()
                assert got == oracle, (
                    f"{d}: tree writer {w.client_id} diverged\n"
                    f"  writer: {got!r}\n  oracle: {oracle!r}"
                )
            tree_nodes += len(oracle)
        if self.tree_engine is not None:
            assert not self.tree_engine.errors().any(), (
                "tree engine error bits latched"
            )

        # No double-acks: one summaryAck per (doc, seq) across the topic.
        seen: set = set()
        doubles = []
        for p in range(self.topic.n_partitions):
            part = self.topic.partition(p)
            for rec in part.read(part.base):
                ack = parse_scribe_ack(rec.payload)
                if ack is not None:
                    key = (ack[0], ack[1])
                    if key in seen:
                        doubles.append(key)
                    seen.add(key)
        assert not doubles, f"double-acked summaries: {doubles}"

        # No scribe replica may have failed folding: chaos generates only
        # well-formed traffic, so a failed doc means the pool machinery
        # (adoption, rebalance, crash re-read) gapped a replica — the
        # stale-replica class a soak once caught.
        failed = {
            (mid, doc): ad.failed
            for mid, m in self.pool.members.items()
            for doc, ad in m.docs.items()
            if ad.failed is not None
        }
        assert not failed, f"scribe replicas failed folding: {failed}"

        # Bounded recovery (first-class, not just bounded queues): every
        # fleet_kill resolved into a measured incident (none still open
        # after quiesce) — kills that folded into a still-open incident
        # (back-to-back kills with an empty tail between) merge into ONE
        # measured window, so the floor is kills minus merges — and every
        # interval sits under the bound.
        rec = self.recovery_report()
        assert rec["open"] == 0, "unresolved recovery incident after quiesce"
        expected = self.counters["fleet_restarts"] - self._merged_kills
        assert rec["incidents"] >= expected, (
            f"{self.counters['fleet_restarts']} fleet kills "
            f"({self._merged_kills} merged) but only "
            f"{rec['incidents']} measured recovery incidents"
        )
        bound_ms = self.recovery_bound_s * 1e3
        slow = [ms for ms in rec["intervals_ms"] if ms > bound_ms]
        assert not slow, (
            f"recovery intervals exceeded the {bound_ms:.0f} ms bound: {slow}"
        )
        if self.tree_engine is not None:
            # The tree tier dies with the same kills: its per-family
            # incidents must resolve under the same bound.
            assert rec["tree_open"] == 0, (
                "unresolved tree recovery incident after quiesce"
            )
            expected = (
                self.counters["fleet_restarts"] - self._tree_merged_kills
            )
            assert rec["tree_incidents"] >= expected, (
                f"{self.counters['fleet_restarts']} fleet kills "
                f"({self._tree_merged_kills} merged) but only "
                f"{rec['tree_incidents']} measured tree recovery incidents"
            )
            slow = [
                ms for ms in rec["tree_intervals_ms"] if ms > bound_ms
            ]
            assert not slow, (
                f"tree recovery intervals exceeded the {bound_ms:.0f} ms "
                f"bound: {slow}"
            )
        out = {
            "converged_docs": len(texts),
            "text_bytes": sum(len(t) for t in texts.values()),
            "summary_acks": len(seen),
            "double_acks": 0,
            "max_queue_depth": self.max_queue_depth,
            "queue_depth_bound": self._depth_bound(),
            "recovery_incidents": rec["incidents"],
            "recovery_max_ms": rec["recovery_max_ms"],
            "recovery_bound_ms": bound_ms,
        }
        if self.tree_engine is not None:
            out.update({
                "tree_converged_docs": len(self.tree_doc_ids),
                "tree_nodes": tree_nodes,
                "max_tree_queue_depth": self.max_tree_queue_depth,
                "tree_queue_depth_bound": self._tree_depth_bound(),
                "tree_recovery_incidents": rec["tree_incidents"],
                "tree_recovery_max_ms": rec["tree_recovery_max_ms"],
            })
        return out

    def close(self) -> None:
        # Defensive getattr walk: close() also runs when __init__ failed
        # partway (a writer join assert, a bind error), where later
        # attributes never came to exist — a failed setup must not leak
        # server threads/sockets into the caller's process.
        for ws in getattr(self, "writers", {}).values():
            for w in ws:
                w.close()
        if getattr(self, "_ckpt_writer", None) is not None:
            self._ckpt_writer.stop()
        if getattr(self, "_tree_ckpt_writer", None) is not None:
            self._tree_ckpt_writer.stop()
        if getattr(self, "consumer", None) is not None:
            self.consumer.close()
        if getattr(self, "tree_consumer", None) is not None:
            self.tree_consumer.close()
        if getattr(self, "pool", None) is not None:
            self.pool.close()
        if getattr(self, "topic", None) is not None:
            self.topic.close()
        if getattr(self, "plane", None) is not None:
            self.plane.stop()


# ---------------------------------------------------------------------------
# Entry points: chaos smoke + soak
# ---------------------------------------------------------------------------

def run_chaos(
    seed: int = 7,
    ticks: int = 40,
    n_docs: int = 3,
    n_tree_docs: int = 0,
    schedule: ChaosSchedule | None = None,
    workdir: str | None = None,
    device=DEFAULT_DEVICE,
    **stack_kw,
) -> dict:
    """One seeded chaos run over the full stack; returns the report dict
    (raises on any invariant violation).  ``n_tree_docs > 0`` runs the
    MIXED fleet: tree docs join the Zipf ranking, the fault schedule, and
    the byte-identity invariants alongside the string docs."""
    import tempfile

    doc_ids = [f"cd{i}" for i in range(n_docs)]
    tree_ids = [f"td{i}" for i in range(n_tree_docs)]
    if schedule is None:
        schedule = make_schedule(seed, ticks, doc_ids + tree_ids)
    owndir = None
    if workdir is None:
        owndir = tempfile.TemporaryDirectory(prefix="fftpu-chaos-")
        workdir = owndir.name
    stack = None
    t0 = time.perf_counter()
    try:
        # ChaosStack.__init__ self-cleans on failure; constructing inside
        # the try keeps the tempdir cleanup on that path too.
        stack = ChaosStack(
            seed, doc_ids, workdir, tree_doc_ids=tree_ids, device=device,
            **stack_kw
        )
        for t in range(ticks):
            stack.tick(t, schedule)
        stack.quiesce()
        invariants = stack.check_invariants()
        health = stack.engine.health()
        report = {
            "seed": seed,
            "ticks": ticks,
            "duration_s": round(time.perf_counter() - t0, 3),
            "schedule_events": len(schedule.events),
            "events_by_kind": {
                k: sum(1 for e in schedule.events if e.kind == k)
                for k in sorted({e.kind for e in schedule.events})
            },
            "invariants": invariants,
            "counters": dict(stack.counters),
            "recovery": stack.recovery_report(),
            "admission": stack.admission.stats(),
            "flow_control": {
                **stack.engine.ingest_watermarks(),
                "pump_pauses": stack.consumer.pump_pauses,
                "pump_resumes": stack.consumer.pump_resumes,
                "overload_events": health.get("overload_events", 0),
            },
            "scribe": stack.pool.health(),
            "devices": {
                "string": str(stack.engine.state.nseg.device),
                **({"tree": str(stack.tree_engine.state.nrow.device)}
                   if stack.tree_engine is not None else {}),
            },
            "sequencer": sorted({
                type(stack.plane.service.document(d).sequencer).__name__
                for d in stack.all_doc_ids
            }),
        }
        if health.get("latency_samples"):
            report["latency_p50_ms"] = health.get("latency_p50_ms")
            report["latency_p99_ms"] = health.get("latency_p99_ms")
        if stack.tree_engine is not None:
            report["tree"] = {
                "n_docs": len(stack.tree_doc_ids),
                "n_shards": stack.tree_engine.n_shards,
                "health": {
                    k: v for k, v in stack.tree_engine.health().items()
                    if isinstance(v, (int, float, str, bool))
                },
            }
        return report
    finally:
        if stack is not None:
            stack.close()
        if owndir is not None:
            owndir.cleanup()


def _rss_now_mb() -> float:
    """The process's resident set now (``/proc/self/status`` VmRSS), or
    its peak so far where that file is missing."""
    import resource

    with contextlib.suppress(OSError), open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def run_soak(
    seed: int = 10,
    ticks: int = 240,
    n_docs: int = 6,
    n_tree_docs: int = 0,
    events_per_kind: int = 2,
    rss_bound_mb: float = 4096.0,
    device=DEFAULT_DEVICE,
    **stack_kw,
) -> dict:
    """The soak runner (``bench.py --config soak``): Zipf traffic with
    churn through a longer chaos schedule, continuous invariant checks,
    and an SLO artifact row — p50/p99 op latency UNDER FAULT from the
    engine's e2e histograms, plus shed/pause/backoff counters and an RSS
    ceiling.

    The ceiling bounds what the soak adds to the process: its peak RSS
    above the RSS the process held when the soak began (the interpreter,
    ``torch`` and, where a caller initialised it, the CUDA runtime), where
    the reference bounds the whole process.  A bare ``import torch`` of a
    CUDA build can hold more than the 4,096 MB bound by itself (the card
    machine's accounting counts each mapped CUDA library whole).  The row
    carries both: ``max_rss_mb`` (the process's peak) and ``soak_rss_mb``
    (the part the bound holds), beside ``rss_baseline_mb``."""
    import resource

    baseline_mb = _rss_now_mb()
    doc_ids = [f"cd{i}" for i in range(n_docs)]
    doc_ids += [f"td{i}" for i in range(n_tree_docs)]
    schedule = make_schedule(
        seed, ticks, doc_ids, events_per_kind=events_per_kind
    )
    stack_kw.setdefault("churn_rate", 0.08)
    report = run_chaos(
        seed=seed, ticks=ticks, n_docs=n_docs, n_tree_docs=n_tree_docs,
        schedule=schedule, device=device, **stack_kw
    )
    max_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    soak_rss_mb = max_rss_mb - baseline_mb
    assert soak_rss_mb < rss_bound_mb, (
        f"soak RSS {soak_rss_mb:.0f} MB above the process's {baseline_mb:.0f} MB "
        f"at its start exceeded bound {rss_bound_mb:.0f} MB"
    )
    ops = report["counters"]["ops_sequenced"]
    recovery = report.get("recovery", {})
    return {
        "metric": "soak_p99_latency_ms_under_fault",
        "value": report.get("latency_p99_ms"),
        "unit": "ms",
        "p50_ms": report.get("latency_p50_ms"),
        "p99_ms": report.get("latency_p99_ms"),
        # The availability columns: per-incident recovery time
        # (fleet kill -> first post-restore op applied), and the
        # tree family's own columns (None when no tree tier ran).
        "recovery_p50_ms": recovery.get("recovery_p50_ms"),
        "recovery_p99_ms": recovery.get("recovery_p99_ms"),
        "tree_recovery_p50_ms": recovery.get("tree_recovery_p50_ms"),
        "tree_recovery_p99_ms": recovery.get("tree_recovery_p99_ms"),
        "standby": recovery.get("standby", False),
        "ops_sequenced": ops,
        "ops_per_sec": round(ops / report["duration_s"], 1)
        if report["duration_s"] else None,
        "max_rss_mb": round(max_rss_mb, 1),
        "rss_baseline_mb": round(baseline_mb, 1),
        "soak_rss_mb": round(soak_rss_mb, 1),
        "rss_bound_mb": rss_bound_mb,
        **{k: report[k] for k in (
            "seed", "ticks", "duration_s", "events_by_kind", "invariants",
            "counters", "recovery", "admission", "flow_control", "scribe",
            "devices", "sequencer",
        )},
    }
