"""Scribe service: batched summarization, summary acks, log compaction.

A port of ``fluidframework_tpu/server/scribe.py`` over the port's replicas:
the string adapter folds into ``dds/mergetree_ref.RefMergeTree``, the tree
adapter into the port's ``EditManager`` and ``Forest``, and the map and
matrix adapters apply their op batches through the port's K10 programs
(``ops/map_kernel.apply_batch``, ``ops/matrix_kernel.apply_ops``) on the
scribe's ``device`` (``ScribeLambda(..., device=...)``, ``"cuda"`` by
default).  Summary records, git objects, commit SHAs, ``refs.json`` and the
ack records are byte-identical to the reference scribe's for the same
topic, on either device (tests/test_torch_scribe.py).

Reference parity: routerlicious' scribe lambda (scribe/lambda.ts:65) — the
SERVER half of the summary loop `runtime/summary.py` implements the client
half of.  A per-partition ``ScribeLambda`` consumes the ordered op topic
alongside the fleet consumers (its own consumer group, its own committed
offsets), folds every document's sequenced ops into a server-side replica,
and applies Fluid-style per-document heuristics (op count / byte volume
since the last acked summary, mirroring ``RunningSummarizer``).  When a
document is due it:

1. snapshots the replica as a SUMMARY RECORD — the exact checkpoint-record
   schema the batched engines restart from (`kernel_backend.state_to_summary`
   shape for strings, forest + EditManager window for trees, and the
   map/matrix kernel codecs `ops/map_kernel.state_to_summary` /
   `ops/matrix_kernel.state_to_summary` for the remaining two families);
2. writes it as an incremental commit in `gitstore.GitSnapshotStore` —
   record sections whose content did not change since the previous summary
   reuse their previous sha without re-walking (the client's summary-handle
   incrementality, server-side);
3. produces a ``summaryAck {doc, seq, commit}`` record back into the
   ordered log (`runtime.summary.make_scribe_ack`), so every consumer sees
   — in the total order — that state up to ``seq`` is recoverable from
   ``commit``.

On top of the ack stream:

- **boot-from-summary**: `SummaryRecordStore` exposes the acked commits
  through the `CheckpointStore` interface, so a cold consumer seeds its
  engines via ``restore_from_checkpoints`` and replays only the post-ack
  tail (`fleet_consumer` / `fleet_main --scribe-dir`);
- **log compaction**: ``ScribeLambda.compact`` truncates each partition
  below the minimum of (every consumer group's committed offset, every
  tracked document's acked-summary offset) — `DurablePartition.
  truncate_below` reclaims the segment bytes; nothing a consumer or a
  recovery replay could still need is ever dropped.

Crash/restart: offsets, refs, and objects are all durable (consumer-group
offset file, ``refs.json``, the git object log).  A restarted scribe
reloads its replicas FROM ITS OWN LAST SUMMARIES, replays the tail from
the committed offset (records below each doc's summary seq skip by seq
floor), and — because its own acks ride the same log and are consumed
before any new summary is cut — never double-acks a summary it already
produced.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..dds.mergetree_ref import RefMergeTree
from ..dds.tree.changeset import apply_commit, commit_from_json
from ..dds.tree.editmanager import EditManager
from ..dds.tree.forest import Forest
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.tree_batch_engine import TreeBatchEngine
from ..observability.flight_recorder import span
from ..ops import map_kernel as mpk
from ..ops import matrix_kernel as mxk
from ..protocol.messages import (
    DeltaType,
    MessageType,
    SequencedMessage,
    decode_obliterate_places,
)
from ..runtime.summary import make_scribe_ack, parse_scribe_ack
from ..utils.telemetry import HealthCounters, Logger
from .gitstore import GitSnapshotStore, GitStore
from .ordered_log import ConsumerGroup, Topic, atomic_json_dump

FAMILIES = ("doc_batch", "tree_batch", "map_batch", "matrix_batch")


class ChaosCrash(RuntimeError):
    """Deliberate mid-fold crash (testing/chaos.py scribe fault): raised
    from inside ``pump`` BEFORE any offset commit, so everything the
    incarnation folded past the committed floor dies with it — the exact
    crash point the at-least-once discipline exists for."""


class ScribeConfig:
    """RunningSummarizer-style heuristics, per document (ref
    ISummaryConfiguration): summarize once ``max_ops`` ops OR ``max_bytes``
    wire bytes accumulate since the last acked summary (byte trigger gated
    on ``min_ops``)."""

    def __init__(
        self,
        max_ops: int = 50,
        max_bytes: int = 64 << 10,
        min_ops: int = 1,
        map_max_keys: int = 256,
        matrix_shape: tuple[int, int] = (64, 64),
        matrix_segments: int = 64,
    ) -> None:
        self.max_ops = max_ops
        self.max_bytes = max_bytes
        self.min_ops = min_ops
        self.map_max_keys = map_max_keys
        self.matrix_shape = matrix_shape
        self.matrix_segments = matrix_segments


def detect_family(contents: Any) -> str:
    """Infer the engine family from one OP's wire contents (overridable
    per doc via ``ScribeLambda(families=...)``)."""
    if isinstance(contents, dict):
        t = contents.get("type")
        if t in ("edit", "groupedBatch") or (
            "address" in contents and "contents" in contents
        ):
            return "tree_batch"
        if t in ("insertRows", "insertCols", "removeRows", "removeCols"):
            return "matrix_batch"
        if t == "set" and "row" in contents:
            return "matrix_batch"
        if t in ("set", "delete", "clear"):
            return "map_batch"
    return "doc_batch"


# ---------------------------------------------------------------------------
# Per-document replicas (one per engine family)
# ---------------------------------------------------------------------------


class _DocScribe:
    """Base per-document scribe replica: seq floors, due heuristics, and
    the record contract (``record()`` returns the engine-restorable dict +
    the set of top-level keys dirtied since the last summary)."""

    family = "doc_batch"
    # Record keys an applied op may dirty (sha reuse is allowed only for
    # keys NOT marked changed since the last summary — a stale sha for a
    # volatile key would silently corrupt the next commit).
    DYNAMIC_KEYS: tuple[str, ...] = ("summary",)

    def __init__(self) -> None:
        self.last_seq = 0
        self.base_seq = 0  # covered by the loaded/acked summary (skip floor)
        self.min_seq = 0
        self.ops_since = 0
        self.bytes_since = 0
        self.changed: set[str] = set(self.DYNAMIC_KEYS)
        self.failed: str | None = None  # poison reason; stop summarizing
        # Canonical-JSON value interning shared by the kernel-backed
        # replicas (map/matrix): wire values -> 1-based int32 ids, the
        # reverse table rides in the record as ``values``.
        self.value_id: dict[str, int] = {}

    # ------------------------------------------------------------------ apply
    def apply(self, msg: SequencedMessage) -> None:
        if msg.type == MessageType.JOIN:
            self._apply_join(msg)
            self.changed.add("quorum")
            return
        prev_min = self.min_seq
        self.min_seq = max(self.min_seq, msg.min_seq)
        if self.min_seq != prev_min:
            self.changed.add("min_seq")
        if msg.type != MessageType.OP:
            return
        if self.base_seq and msg.seq <= self.base_seq:
            return  # already folded into the summary this replica loaded
        self.last_seq = max(self.last_seq, msg.seq)
        self.ops_since += 1
        self.bytes_since += len(msg.wire_line())
        self.changed.update(self.DYNAMIC_KEYS)
        self._apply_op(msg)

    def _apply_join(self, msg: SequencedMessage) -> None:
        pass

    def _apply_op(self, msg: SequencedMessage) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Drain any device-side op buffer before reading state."""

    def due(self, cfg: ScribeConfig) -> bool:
        if self.failed is not None:
            return False
        if self.ops_since >= cfg.max_ops:
            return True
        return self.ops_since >= cfg.min_ops and self.bytes_since >= cfg.max_bytes

    def mark_summarized(self) -> None:
        self.ops_since = 0
        self.bytes_since = 0
        self.changed = set()

    # ------------------------------------------------- value interning
    def _intern_value(self, value: Any) -> int:
        canon = json.dumps(value, sort_keys=True, separators=(",", ":"))
        vid = self.value_id.get(canon)
        if vid is None:
            vid = self.value_id[canon] = len(self.value_id) + 1
        return vid

    def _values_list(self) -> list[str]:
        return sorted(self.value_id, key=self.value_id.get)

    def _load_values(self, values: list[str]) -> None:
        self.value_id = {v: i + 1 for i, v in enumerate(values)}

    def _id_value_table(self) -> dict[int, Any]:
        return {v: json.loads(k) for k, v in self.value_id.items()}

    # ----------------------------------------------------------------- record
    def record(self) -> dict:
        raise NotImplementedError

    def load(self, seq: int, record: dict) -> None:
        raise NotImplementedError


class _StringDocScribe(_DocScribe):
    """SharedString replica: host merge-tree oracle, summarized in the
    exact ``doc_batch`` checkpoint-record schema (kernel_backend summary
    shape + quorum), so `DocBatchEngine.restore_from_checkpoints` boots
    from it unchanged."""

    family = "doc_batch"
    DYNAMIC_KEYS = ("summary", "min_seq")

    def __init__(self) -> None:
        super().__init__()
        self.quorum: dict[str, int] = {}
        self.tree = RefMergeTree()

    def _apply_join(self, msg: SequencedMessage) -> None:
        self.quorum[msg.contents["clientId"]] = msg.contents["short"]
        self.min_seq = max(self.min_seq, msg.min_seq)

    def _apply_op(self, msg: SequencedMessage) -> None:
        c = msg.contents
        kind = c["type"]
        client = self.quorum[msg.client_id]
        if kind == DeltaType.INSERT:
            self.tree.apply_insert(c["pos1"], c["seg"], msg.seq, client, msg.ref_seq)
        elif kind == DeltaType.REMOVE:
            self.tree.apply_remove(c["pos1"], c["pos2"], msg.seq, client, msg.ref_seq)
        elif kind == DeltaType.ANNOTATE:
            for prop, value in c["props"].items():
                self.tree.apply_annotate(
                    c["pos1"], c["pos2"], int(prop), value,
                    msg.seq, client, msg.ref_seq,
                )
        elif kind in (DeltaType.OBLITERATE, DeltaType.OBLITERATE_SIDED):
            p1, s1, p2, s2 = decode_obliterate_places(c)
            self.tree.apply_obliterate(p1, s1, p2, s2, msg.seq, client, msg.ref_seq)
        else:
            raise ValueError(f"unsupported op type {kind}")
        self.tree.update_min_seq(self.min_seq)

    def record(self) -> dict:
        return {
            "engine": "doc_batch",
            "lane": "batch",
            "summary": self.tree.export_summary(),
            "quorum": dict(self.quorum),
            "prop_slot": {},
            "min_seq": self.min_seq,
            "mode": "obj",
        }

    def load(self, seq: int, record: dict) -> None:
        self.tree.import_summary(record["summary"])
        self.quorum = dict(record.get("quorum", {}))
        self.min_seq = int(record.get("min_seq", 0))
        self.tree.update_min_seq(self.min_seq)
        self.base_seq = self.last_seq = int(seq)


class _TreeDocScribe(_DocScribe):
    """SharedTree replica: EditManager + trunk-folded forest, summarized as
    the ``tree_batch`` checkpoint record (forest + EditManager window)."""

    family = "tree_batch"
    DYNAMIC_KEYS = ("forest", "em", "commits")

    def __init__(self) -> None:
        super().__init__()
        self.em = EditManager()
        self.forest = Forest()
        self.commits = 0

    def _apply_op(self, msg: SequencedMessage) -> None:
        for c in TreeBatchEngine._unwrap(msg.contents):
            commit = commit_from_json(c["changes"])
            trunk = self.em.add_sequenced(
                client_id=msg.client_id,
                revision=(c["sid"], c["rev"]),
                change=commit,
                ref_seq=msg.ref_seq,
                seq=msg.seq,
            )
            self.em.advance_min_seq(msg.min_seq)
            apply_commit(self.forest.root, trunk)
            self.commits += 1

    def record(self) -> dict:
        return {
            "engine": "tree_batch",
            "lane": "device",
            "forest": self.forest.to_json(),
            "em": self.em.summarize(),
            "commits": self.commits,
        }

    def load(self, seq: int, record: dict) -> None:
        self.forest.load_json(record["forest"])
        self.em.load(record["em"])
        self.commits = int(record.get("commits", 0))
        self.base_seq = self.last_seq = int(seq)


class _MapDocScribe(_DocScribe):
    """SharedMap replica ON the batched kernel (K10): wire keys/values
    intern to int32 ids (tables ride in the record), ops buffer per pump and
    apply in NOOP-padded batches of 16 through `map_kernel.apply_batch` on
    ``device``; the summary is the `map_kernel.state_to_summary` codec."""

    family = "map_batch"
    DYNAMIC_KEYS = ("summary", "keys", "values")
    _B = 16  # fixed device batch (padded with NOOP, as the reference's)

    def __init__(self, max_keys: int = 256, device=DEFAULT_DEVICE) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.key_slot: dict[str, int] = {}
        self.state = mpk.init_state(max_keys, device=self.device)
        self._pending: list[tuple[int, int, int, int]] = []  # kind,key,val,seq

    def _intern_key(self, key: str) -> int:
        slot = self.key_slot.get(key)
        if slot is None:
            K = int(self.state.values.shape[0])
            if len(self.key_slot) >= K:
                self._grow(2 * K)
            slot = self.key_slot[key] = len(self.key_slot)
        return slot

    def _grow(self, new_k: int) -> None:
        """Double the key capacity through the exact codec roundtrip."""
        self.flush()
        self.state = mpk.summary_to_state(
            mpk.state_to_summary(self.state), max_keys=new_k,
            device=self.device,
        )

    def _apply_op(self, msg: SequencedMessage) -> None:
        c = msg.contents
        kind = c["type"]
        if kind == "set":
            self._pending.append(
                (mpk.MapOpKind.SET, self._intern_key(c["key"]),
                 self._intern_value(c["value"]), msg.seq)
            )
        elif kind == "delete":
            self._pending.append(
                (mpk.MapOpKind.DELETE, self._intern_key(c["key"]), 0, msg.seq)
            )
        elif kind == "clear":
            self._pending.append((mpk.MapOpKind.CLEAR, -1, 0, msg.seq))
        else:
            raise ValueError(f"unsupported map op {kind}")

    def flush(self) -> None:
        B = self._B
        for i in range(0, len(self._pending), B):
            chunk = self._pending[i : i + B]
            rows = np.zeros((B, 4), np.int32)
            rows[: len(chunk)] = chunk
            self.state = mpk.apply_batch(
                self.state, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
            )
        self._pending.clear()

    def items(self) -> dict[str, Any]:
        """{key: value} host view through the intern tables."""
        self.flush()
        slot_key = {v: k for k, v in self.key_slot.items()}
        id_value = self._id_value_table()
        return {
            slot_key[k]: id_value[v]
            for k, v in mpk.host_items(self.state).items()
        }

    def record(self) -> dict:
        self.flush()
        return {
            "engine": "map_batch",
            "summary": mpk.state_to_summary(self.state),
            "keys": dict(self.key_slot),
            "values": self._values_list(),
        }

    def load(self, seq: int, record: dict) -> None:
        self.key_slot = {k: int(v) for k, v in record["keys"].items()}
        self._load_values(record["values"])
        self.state = mpk.summary_to_state(record["summary"], device=self.device)
        self.base_seq = self.last_seq = int(seq)


class _MatrixDocScribe(_DocScribe):
    """SharedMatrix replica ON the batched kernel (K10): quorum shorts +
    value interning on the host, op rows buffered and applied in batches of
    16 through `matrix_kernel.apply_ops` on ``device``; the summary is the
    `matrix_kernel.state_to_summary` codec."""

    family = "matrix_batch"
    DYNAMIC_KEYS = ("summary", "values")
    _B = 16

    def __init__(self, shape: tuple[int, int] = (64, 64), segments: int = 64,
                 device=DEFAULT_DEVICE) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.quorum: dict[str, int] = {}
        self.state = mxk.init_state(
            max_rows=shape[0], max_cols=shape[1], max_segments=segments,
            device=self.device,
        )
        self._pending: list[list[int]] = []

    def _apply_join(self, msg: SequencedMessage) -> None:
        self.quorum[msg.contents["clientId"]] = msg.contents["short"]
        self.min_seq = max(self.min_seq, msg.min_seq)

    def _apply_op(self, msg: SequencedMessage) -> None:
        c = msg.contents
        kind = c["type"]
        client = self.quorum[msg.client_id]
        if kind == "set":
            row = [mxk.MatrixOpKind.SET_CELL, msg.seq, client, msg.ref_seq,
                   c["row"], c["col"], self._intern_value(c["value"]),
                   1 if c.get("fwwMode") else 0]
        elif kind in ("insertRows", "insertCols", "removeRows", "removeCols"):
            op_kind = {
                "insertRows": mxk.MatrixOpKind.INSERT_ROWS,
                "insertCols": mxk.MatrixOpKind.INSERT_COLS,
                "removeRows": mxk.MatrixOpKind.REMOVE_ROWS,
                "removeCols": mxk.MatrixOpKind.REMOVE_COLS,
            }[kind]
            row = [op_kind, msg.seq, client, msg.ref_seq,
                   c["pos"], c["count"], 0, 0]
        else:
            raise ValueError(f"unsupported matrix op {kind}")
        self._pending.append(row)

    def flush(self) -> None:
        B = self._B
        for i in range(0, len(self._pending), B):
            chunk = self._pending[i : i + B]
            rows = np.zeros((B, mxk.MATRIX_OP_FIELDS), np.int32)
            rows[: len(chunk)] = chunk
            self.state = mxk.apply_ops(self.state, rows)
        self._pending.clear()
        bits = int(self.state.error)
        if bits and self.failed is None:
            # A poisoned replica must never be summarized: acking a wrong
            # summary would propagate the corruption to every booting
            # consumer (worse than no summary at all).
            self.failed = f"matrix kernel error bits {bits:#x}"

    def grid(self) -> list[list]:
        self.flush()
        id_value = self._id_value_table()
        return [
            [None if v is None else id_value[v] for v in row]
            for row in mxk.to_grid(self.state)
        ]

    def record(self) -> dict:
        self.flush()
        return {
            "engine": "matrix_batch",
            "summary": mxk.state_to_summary(self.state),
            "quorum": dict(self.quorum),
            "values": self._values_list(),
        }

    def load(self, seq: int, record: dict) -> None:
        self.quorum = dict(record.get("quorum", {}))
        self._load_values(record["values"])
        self.state = mxk.summary_to_state(record["summary"], device=self.device)
        self.base_seq = self.last_seq = int(seq)


def _make_doc(family: str, cfg: ScribeConfig, device=DEFAULT_DEVICE) -> _DocScribe:
    """A fresh replica of ``family``; map and matrix replicas hold their
    state on ``device``."""
    if family == "doc_batch":
        return _StringDocScribe()
    if family == "tree_batch":
        return _TreeDocScribe()
    if family == "map_batch":
        return _MapDocScribe(cfg.map_max_keys, device)
    if family == "matrix_batch":
        return _MatrixDocScribe(cfg.matrix_shape, cfg.matrix_segments, device)
    raise ValueError(f"unknown engine family {family!r}")


# ---------------------------------------------------------------------------
# The scribe lambda
# ---------------------------------------------------------------------------


class ScribeLambda:
    """Per-partition summarizer over the ordered op topic (see module
    docstring).  ``directory`` holds everything durable: consumer-group
    offsets, ``refs.json`` (doc -> latest acked {seq, commit, offset,
    family}), and the git object log.  Map and matrix replicas run their
    K10 batches on ``device``."""

    def __init__(
        self,
        topic: Topic,
        directory: str,
        config: ScribeConfig | None = None,
        families: dict[str, str] | None = None,
        member_id: str = "scribe",
        store: GitStore | None = None,
        group: ConsumerGroup | None = None,
        telemetry: Logger | None = None,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        self.topic = topic
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self.config = config or ScribeConfig()
        self.families = dict(families or {})
        self.counters = HealthCounters(telemetry)
        self.store = store if store is not None else GitStore(
            os.path.join(directory, "objects")
        )
        self.group = group or ConsumerGroup(topic, "scribe", directory)
        self.member_id = member_id
        self.group.join(member_id)
        self.docs: dict[str, _DocScribe] = {}
        self.chains: dict[str, GitSnapshotStore] = {}
        self._channel_sha: dict[str, dict[str, str]] = {}
        self.refs: dict[str, dict] = {}
        self._refs_path = os.path.join(directory, "refs.json")
        # Quorum joins seen before a doc's family is known (family detection
        # needs the first OP).
        self._pending_joins: dict[str, list[SequencedMessage]] = {}
        # In-memory read positions (high-water mark per partition) vs the
        # DURABLE committed offsets: a record folded into a replica but not
        # yet covered by an acked summary must be re-read after a crash, so
        # the group offset only ever commits up to the covered floor while
        # live consumption continues from ``_positions``.
        self._positions: dict[int, int] = {}
        # doc -> earliest consumed-but-not-yet-summarized record offset
        # (pins the durable commit floor for its partition).
        self._uncovered: dict[str, int] = {}
        # Docs whose persisted ref this incarnation DELIBERATELY dropped
        # (missing/unloadable commit): _ref_for must not resurrect them
        # from disk — the drop forces a full replay on purpose.
        self._dropped_refs: set[str] = set()
        # Chaos fault hook: when > 0, pump raises ChaosCrash after folding
        # this many more records — mid-fold, before any offset commit.
        self.chaos_abort_after_folds = 0
        # Partitions this member folded last pump: a GAIN (rebalance /
        # first pump) triggers stale-replica validation — see pump().
        self._owned: set[int] = set()
        self._restore()

    # ---------------------------------------------------------------- restore
    def _restore(self) -> None:
        if not os.path.exists(self._refs_path):
            return
        try:
            with open(self._refs_path) as f:
                refs = json.load(f)
        except (json.JSONDecodeError, OSError):
            return  # refs lost: full replay rebuilds everything
        for doc, ref in refs.items():
            commit = ref["commit"]
            if commit not in self.store:
                # Object log lost/partial: drop the ref, replay from zero.
                self.counters.bump("refs_dropped_missing_commit")
                self._dropped_refs.add(doc)
                continue
            seq, record = self._read_commit(commit)
            # The record's own engine tag is authoritative for the replica
            # family — a ref stamped by a peer-ack adoption may carry a
            # guessed family, and loading the record into the wrong
            # adapter must not brick startup.
            ad = _make_doc(record.get("engine", ref.get("family", "doc_batch")),
                           self.config, self.device)
            try:
                ad.load(seq, record)
            except Exception:  # noqa: BLE001 — degrade to full replay, never brick
                self.counters.bump("refs_dropped_unloadable")
                self._dropped_refs.add(doc)
                continue
            ad.mark_summarized()
            self.docs[doc] = ad
            chain = GitSnapshotStore(self.store)
            chain.adopt_version(seq, commit)
            self.chains[doc] = chain
            self.refs[doc] = dict(ref)
            # Seed the handle-reuse cache from the commit's own tree so the
            # first post-restart summary still reuses unchanged channels.
            _k, tree_payload = self.store.get(
                self.store.get(commit)[1]["tree"]
            )
            self._channel_sha[doc] = dict(tree_payload)
            self.counters.bump("docs_restored")

    def _read_commit(self, commit_sha: str) -> tuple[int, dict]:
        kind, payload = self.store.get(commit_sha)
        if kind != "commit":
            raise KeyError(f"{commit_sha[:12]} is a {kind}, not a commit")
        return payload["seq"], self.store.read_snapshot(payload["tree"])

    # --------------------------------------------------- scale-out handoff
    def _write_ref(self, doc_id: str) -> None:
        """Persist one doc's ref by MERGING into refs.json (read-modify-
        write under the atomic dump): scale-out members sharing one scribe
        directory (partition_manager.ScribePool) own disjoint partitions,
        so a whole-dict dump from one member would clobber the entries its
        peers persisted for theirs."""
        on_disk: dict = {}
        if os.path.exists(self._refs_path):
            try:
                with open(self._refs_path) as f:
                    on_disk = json.load(f)
            except (json.JSONDecodeError, OSError):
                on_disk = {}
        on_disk[doc_id] = self.refs[doc_id]
        atomic_json_dump(on_disk, self._refs_path)

    def _ref_for(self, doc_id: str) -> dict | None:
        """This member's view of a doc's latest acked summary, falling back
        to refs.json: after a rebalance the partition's new owner learns
        its docs' floors from the ref a pool peer (or a previous
        incarnation) persisted — necessary because the producing ack can
        sit BELOW the group's committed offset, where no replay will ever
        surface it again.  Never resurrects a ref this incarnation
        deliberately dropped (missing/unloadable commit)."""
        ref = self.refs.get(doc_id)
        if (
            ref is None
            and doc_id not in self._dropped_refs
            and os.path.exists(self._refs_path)
        ):
            try:
                with open(self._refs_path) as f:
                    ref = json.load(f).get(doc_id)
            except (json.JSONDecodeError, OSError):
                ref = None
            if ref is not None:
                self.refs[doc_id] = dict(ref)
        return ref

    def _disk_ref(self, doc_id: str) -> dict | None:
        """The doc's ref as PERSISTED (shared refs.json), bypassing this
        member's in-memory view — the in-memory ref can itself be stale
        for docs whose partitions a peer owned (we never consume their
        ack records), which is exactly when the truth matters."""
        if not os.path.exists(self._refs_path):
            return None
        try:
            with open(self._refs_path) as f:
                return json.load(f).get(doc_id)
        except (json.JSONDecodeError, OSError):
            return None

    def _validate_replicas_on_gain(self, gained: set) -> None:
        """Rebalance hygiene: taking over a partition, drop any in-memory
        replica whose PERSISTED acked floor ran ahead of what this member
        folded.  Such a replica went stale while a peer owned the
        partition (we restored it at an old summary and never folded — we
        do not consume ack records for partitions we don't own), and the
        committed floor has already advanced past the ops it is missing:
        folding the tail onto it would silently gap the state (quorum
        KeyErrors / position errors at best, a corrupt next summary at
        worst).  Dropping it makes the next op re-adopt the CURRENT acked
        summary — the partition-handoff resume, now crash-shape-proof."""
        for doc_id in list(self.docs):
            if self.topic.partition_for(doc_id) not in gained:
                continue
            ad = self.docs[doc_id]
            ref = self._disk_ref(doc_id)
            if ref is None or int(ref["seq"]) <= ad.last_seq:
                # Current (or ahead: crash re-read resumes over it) — and
                # with no fresher ref there is nothing safer to adopt.
                continue
            del self.docs[doc_id]
            self.chains.pop(doc_id, None)
            self._channel_sha.pop(doc_id, None)
            self._uncovered.pop(doc_id, None)
            self.refs[doc_id] = dict(ref)  # adopt the fresh floor
            self.counters.bump("stale_replicas_dropped")

    def _adopt_summary(self, doc_id: str, family: str):
        """A doc's starting replica for this member: loaded from its latest
        acked summary when one is reachable (shared refs + object store) —
        the partition-handoff resume.  A member taking over a partition
        mid-stream folds only the tail above the acked floor onto the
        adopted state; re-folding from the committed offset onto an EMPTY
        replica would silently cut a corrupt next summary.  Falls back to
        an empty replica (full replay) when nothing is adoptable."""
        ref = self._ref_for(doc_id)
        if ref is not None and ref.get("commit") in self.store:
            try:
                seq, record = self._read_commit(ref["commit"])
                ad = _make_doc(record.get("engine", family), self.config, self.device)
                ad.load(seq, record)
                ad.mark_summarized()
                chain = GitSnapshotStore(self.store)
                chain.adopt_version(seq, ref["commit"])
                self.chains[doc_id] = chain
                # Seed handle reuse from the adopted commit's own tree.
                _k, tree_payload = self.store.get(
                    self.store.get(ref["commit"])[1]["tree"]
                )
                self._channel_sha[doc_id] = dict(tree_payload)
                self.counters.bump("summaries_adopted")
                return ad
            except Exception:  # noqa: BLE001 — degrade to full replay
                self.counters.bump("refs_dropped_unloadable")
                self._dropped_refs.add(doc_id)
        return _make_doc(family, self.config, self.device)

    # ------------------------------------------------------------------- pump
    def pump(self) -> int:
        """Consume everything assigned, fold ops, cut due summaries, commit
        offsets.  Acks (own or a peer's) are consumed BEFORE the due check,
        which is what makes a crash-replay idempotent: a summary the
        previous incarnation already acked resets the counters before this
        incarnation could cut it again.

        At-least-once discipline: the durable group offset advances only to
        the COVERED floor (nothing below it is outside an acked summary),
        while in-process reads continue from the high-water mark — so a
        crash between fold and summarize re-reads exactly the ops whose
        state died with the process, and compaction (which keys off the
        committed offsets) can never reclaim them first."""
        n = 0
        next_offsets: dict[int, int] = {}
        touched: set[str] = set()
        assigned = set(self.group.assignments(self.member_id))
        gained = assigned - self._owned
        if gained:
            # Newly-owned partitions (rebalance, or the first pump): any
            # in-memory replica that went stale while a peer owned its
            # partition must re-adopt the peer's acked summary, not have
            # the tail folded onto missing state.
            self._validate_replicas_on_gain(gained)
        self._owned = assigned
        for p in sorted(assigned):
            part = self.topic.partition(p)
            start = self._positions.get(p, self.group.committed(p))
            if start < part.base:
                self.group.truncated_records_skipped += part.base - start
                start = part.base
            # One fold span per partition batch (NOT per record: fold is
            # the scribe's per-message hot path).
            with span("scribe.fold", partition=p):
                for rec in part.read(start):
                    msg = rec.payload
                    ack = parse_scribe_ack(msg)
                    if ack is not None:
                        self._on_ack(*ack, offset=None)
                    elif isinstance(msg, SequencedMessage):
                        self._fold(rec.doc_id, msg, rec.offset)
                        touched.add(rec.doc_id)
                    if self.chaos_abort_after_folds > 0:
                        self.chaos_abort_after_folds -= 1
                        if self.chaos_abort_after_folds == 0:
                            # Crash mid-fold, AFTER folding this record
                            # and BEFORE any position/offset commit: the
                            # folded-but-unsummarized state dies with the
                            # member and must be re-read exactly.
                            raise ChaosCrash(
                                f"injected crash mid-fold (partition {p},"
                                f" offset {rec.offset})"
                            )
                    start = rec.offset + 1
                    n += 1
            self._positions[p] = next_offsets[p] = start
        for doc in sorted(touched):
            ad = self.docs.get(doc)
            if ad is not None and ad.due(self.config):
                p = self.topic.partition_for(doc)
                self.summarize(doc, at_offset=next_offsets[p])
        for p, off in next_offsets.items():
            floor = min([off] + [
                u for doc, u in self._uncovered.items()
                if self.topic.partition_for(doc) == p
            ])
            if floor > self.group.committed(p):
                self.group.commit(p, floor)
        return n

    def _fold(self, doc_id: str, msg: SequencedMessage, offset: int) -> None:
        ad = self.docs.get(doc_id)
        if ad is None:
            if msg.type == MessageType.JOIN:
                self._pending_joins.setdefault(doc_id, []).append(msg)
                self._uncovered.setdefault(doc_id, offset)
                return
            if msg.type != MessageType.OP:
                return
            family = self.families.get(doc_id) or detect_family(msg.contents)
            ad = self.docs[doc_id] = self._adopt_summary(doc_id, family)
            for join in self._pending_joins.pop(doc_id, []):
                try:
                    ad.apply(join)
                except Exception as e:  # noqa: BLE001 — same poison gate as below
                    ad.failed = f"{type(e).__name__}: {e}"
                    self.counters.bump("docs_failed")
                    break
        if ad.failed is not None:
            # A failed doc will never be summarized: its records stop
            # pinning the commit floor (they are lost to the replica either
            # way; the failure itself is already counted and logged).
            self._uncovered.pop(doc_id, None)
            return
        if msg.type == MessageType.JOIN or (
            msg.type == MessageType.OP
            and not (ad.base_seq and msg.seq <= ad.base_seq)
        ):
            # Pin the durable commit floor — EXCEPT for ops the doc's own
            # summary already covers (a restart replay of the shared
            # partition must not re-pin the floor for docs that are fully
            # caught up; their siblings' uncovered records pin it).
            self._uncovered.setdefault(doc_id, offset)
        try:
            ad.apply(msg)
        except Exception as e:  # noqa: BLE001 — one bad doc must not stall the partition
            ad.failed = f"{type(e).__name__}: {e}"
            self._uncovered.pop(doc_id, None)
            self.counters.bump("docs_failed")
            if self.counters.logger is not None:
                self.counters.logger.error("scribe_doc_failed", e, doc=doc_id)

    # -------------------------------------------------------------- summarize
    def summarize(self, doc_id: str, at_offset: int | None = None) -> str | None:
        """Cut one summary now (heuristics bypassed): commit + ack.
        Returns the commit sha, or None when the doc is unknown/failed or
        has nothing new."""
        ad = self.docs.get(doc_id)
        if ad is None or ad.failed is not None or ad.ops_since == 0:
            return None
        if at_offset is None:
            # The read position IS the fold point; the partition head would
            # overcount records produced since that this replica never
            # folded.
            p = self.topic.partition_for(doc_id)
            at_offset = self._positions.get(p, self.group.committed(p))
        with span("scribe.summarize", doc=doc_id):
            ad.flush()
            if ad.failed is not None:  # flush may detect a poisoned state
                return None
            record = ad.record()
            cache = self._channel_sha.setdefault(doc_id, {})
            entries: dict[str, str] = {}
            for key, val in record.items():
                sha = cache.get(key)
                if sha is None or key in ad.changed or sha not in self.store:
                    sha = self.store.write_snapshot(val)
                else:
                    # Unchanged channel: reuse the previous commit's subtree
                    # sha without re-serializing (the client-side
                    # summary-handle incrementality, server-side).
                    self.counters.bump("summary_handles_reused")
                entries[key] = sha
                cache[key] = sha
            root = self.store.put_tree(entries)
            chain = self.chains.setdefault(
                doc_id, GitSnapshotStore(self.store)
            )
            commit = chain.save_root(ad.last_seq, root)
            # The objects must be ON DISK before the commit sha is
            # externalized (the ack tells the world the log below is
            # reclaimable; a power cut must not leave the ack durable and
            # the objects in the page cache).
            self.store.sync()
        with span("scribe.ack", doc=doc_id):
            self.topic.produce(
                doc_id, make_scribe_ack(doc_id, ad.last_seq, commit)
            )
            self._on_ack(doc_id, ad.last_seq, commit, offset=at_offset)
        # Everything folded for this doc is now covered by the acked
        # summary: stop pinning the durable commit floor.
        self._uncovered.pop(doc_id, None)
        self.counters.bump("summaries_written")
        return commit

    def summarize_all(self) -> list[str]:
        """Force-cut every tracked doc with pending ops (drain/shutdown)."""
        return [d for d in sorted(self.docs) if self.summarize(d) is not None]

    def _on_ack(
        self, doc_id: str, seq: int, commit: str, offset: int | None
    ) -> None:
        """Adopt one summaryAck (own, a peer's, or a replayed one) —
        idempotent: an ack at or below the known floor is a no-op.

        ``offset`` is the partition offset the summary provably covers;
        only the scribe that CUT the summary knows it.  Adopting a peer's
        ack passes None and inherits the previous floor (conservative:
        compaction may lag, it can never outrun coverage — ops sequenced
        between the peer's summary point and its ack record sit below the
        ack's offset without being covered)."""
        ref = self._ref_for(doc_id)
        if ref is not None and ref["seq"] >= seq:
            return
        if offset is None:
            offset = (ref or {}).get("offset", 0)
        if doc_id in self.docs:
            family = self.docs[doc_id].family
        elif commit in self.store:
            # Peer ack for a doc this scribe never folded: the commit's
            # own engine tag beats guessing (restart loads by it).
            try:
                family = self._read_commit(commit)[1].get(
                    "engine", "doc_batch"
                )
            except KeyError:
                family = (ref or {}).get("family", "doc_batch")
        else:
            family = (ref or {}).get("family", "doc_batch")
        self.refs[doc_id] = {
            "seq": int(seq), "commit": commit, "offset": int(offset),
            "family": family,
        }
        self._write_ref(doc_id)
        self._dropped_refs.discard(doc_id)
        ad = self.docs.get(doc_id)
        if ad is not None and ad.last_seq <= seq:
            ad.mark_summarized()
        self.counters.bump("acks_adopted")

    # -------------------------------------------------------------- compaction
    def compact(self, extra_groups: tuple[ConsumerGroup, ...] = ()) -> dict:
        """Reclaim log segments below the minimum of every consumer group's
        committed offset AND every tracked doc's acked-summary offset.
        Docs with traffic but no acked summary pin their partition at 0
        (nothing reclaimable) — truncation can never outrun a replica that
        would still need the records.  (A doc that only ever JOINed and
        then went idle forever pins its partition the same way — its
        buffered quorum state has no summary to live in; the
        ``compaction_pinned_docs`` gauge surfaces such docs.)  Returns this
        pass's reclaim ({"records", "bytes"}); the ``log_*_reclaimed``
        counters accumulate across passes."""
        records = 0
        bytes_before = sum(
            getattr(self.topic.partition(p), "bytes_reclaimed", 0)
            for p in range(self.topic.n_partitions)
        )
        for p in range(self.topic.n_partitions):
            part = self.topic.partition(p)
            floors = [self.group.committed(p)]
            floors += [g.committed(p) for g in extra_groups]
            # Sorted: the floor fold itself is a min (order-free), but a
            # byte-identity path must not iterate in hash order on
            # principle — a future side effect in this loop would diverge
            # per replica.
            for doc in sorted(set(self.docs) | set(self.refs)):
                if self.topic.partition_for(doc) != p:
                    continue
                ref = self.refs.get(doc)
                floors.append(int(ref["offset"]) if ref is not None else 0)
            records += part.truncate_below(min(floors))
        bytes_reclaimed = sum(
            getattr(self.topic.partition(p), "bytes_reclaimed", 0)
            for p in range(self.topic.n_partitions)
        ) - bytes_before
        self.counters.bump("log_records_reclaimed", records)
        self.counters.bump("log_bytes_reclaimed", bytes_reclaimed)
        self.counters.gauge(
            "compaction_pinned_docs",
            len(self._uncovered) + len(self._pending_joins),
        )
        return {"records": records, "bytes": bytes_reclaimed}

    # ----------------------------------------------------------------- health
    def health(self) -> dict:
        snap = self.counters.snapshot()
        ages = [
            ad.last_seq - self.refs.get(doc, {}).get("seq", 0)
            for doc, ad in self.docs.items()
            if ad.last_seq
        ]
        # Ordered-log depth per assigned partition: records sequenced past
        # this scribe's read position (the fold backlog) — the metrics
        # plane's ordered-log surface for the summarization tier.
        depth = [
            max(0, self.topic.partition(p).head
                - self._positions.get(p, self.group.committed(p)))
            for p in self.group.assignments(self.member_id)
        ]
        snap.update(
            tracked_docs=len(self.docs),
            acked_docs=len(self.refs),
            summary_age_seqs=max(ages, default=0),
            failed_docs=sum(1 for ad in self.docs.values() if ad.failed),
            truncated_records_skipped=self.group.truncated_records_skipped,
            log_depth=depth,
            log_lag=sum(depth),
            git_sharing_ratio=round(
                1.0 - self.store.stored / self.store.writes, 4
            ) if self.store.writes else 0.0,
        )
        return snap

    def close(self) -> None:
        self.store.close()


# ---------------------------------------------------------------------------
# Boot-from-summary (the consumer half of the ack protocol)
# ---------------------------------------------------------------------------


class SummaryRecordStore:
    """`CheckpointStore`-compatible read view over the scribe's acked
    commits: ``load(doc)`` returns the engine-restorable record stamped
    with the acked seq, so `restore_from_checkpoints(store=...)` boots a
    cold engine from the latest acked summary and the seq-floor dedupe
    skips the covered prefix of the replayed stream."""

    def __init__(self, store: GitStore, refs: dict[str, dict]) -> None:
        self.store = store
        self.refs = dict(refs)

    @classmethod
    def open(cls, directory: str) -> "SummaryRecordStore":
        """Open a scribe directory READ-ONLY (fleet boot / inspect path):
        no directories created, no append handle held against a possibly
        live scribe's object log."""
        refs: dict[str, dict] = {}
        path = os.path.join(directory, "refs.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    refs = json.load(f)
            except (json.JSONDecodeError, OSError):
                refs = {}
        store = GitStore(os.path.join(directory, "objects"), readonly=True)
        return cls(store, refs)

    @classmethod
    def from_scribe(cls, scribe: ScribeLambda) -> "SummaryRecordStore":
        return cls(scribe.store, scribe.refs)

    def load(self, doc_id: str) -> dict | None:
        ref = self.refs.get(str(doc_id))
        if ref is None or ref["commit"] not in self.store:
            return None
        kind, payload = self.store.get(ref["commit"])
        if kind != "commit":
            return None
        record = self.store.read_snapshot(payload["tree"])
        return {"doc": str(doc_id), "seq": int(payload["seq"]), **record}

    def docs(self) -> list[str]:
        return sorted(self.refs)

    def family(self, doc_id: str) -> str | None:
        ref = self.refs.get(str(doc_id))
        return None if ref is None else ref.get("family")
