"""Ordered log and durable per-document checkpoint records.

A copy of ``fluidframework_tpu/server/ordered_log.py`` (it imports no JAX):

- ``Topic``/``Partition`` — the in-memory ordered log (records routed to
  partitions by doc id, absolute offsets, truncation below a floor);
- ``DurableTopic``/``DurablePartition`` — the same as append-only JSONL
  segments per partition, reloaded on open (a torn trailing line drops);
- ``ConsumerGroup`` — partition assignment over a membership, committed
  offsets (durable with ``directory``), resume-below-floor accounting;
- ``atomic_json_dump`` and ``CheckpointStore`` — one JSON record file per
  document, written temp-file, fsync, rename.

File names, line formats and record layouts are the reference's, so a log,
an offsets file or a checkpoint store either package wrote opens in the
other (tests/test_torch_checkpoint.py, tests/test_torch_scribe.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable


def atomic_json_dump(obj, path: str) -> None:
    """Write-temp-fsync-then-rename: a crash mid-write never destroys the
    previous good file (these files ARE the recovery state — a torn write
    would be worse than no file), and the fsync before the rename means the
    rename can never promote an empty/partial tmp file after a power cut."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class LogRecord:
    offset: int
    doc_id: str
    payload: Any


class Partition:
    def __init__(self) -> None:
        self.records: list[LogRecord] = []
        # Truncation floor: offsets below ``base`` have been compacted away
        # (their content lives in acked summaries).  Offsets stay absolute —
        # record N keeps offset N forever — only storage is reclaimed.
        self.base = 0
        self.records_reclaimed = 0

    def append(self, doc_id: str, payload: Any) -> int:
        off = self.base + len(self.records)
        self.records.append(LogRecord(offset=off, doc_id=doc_id, payload=payload))
        return off

    def read(self, from_offset: int, max_records: int = 1 << 30) -> list[LogRecord]:
        # Clamp to the floor: records below it are gone (compacted); a
        # consumer resuming from an old offset starts at the floor instead
        # of slicing garbage (see ConsumerGroup.consume for the telemetry).
        i = max(from_offset - self.base, 0)
        return self.records[i : i + max_records]

    def truncate_below(self, offset: int) -> int:
        """Reclaim every record with offset < ``offset`` (clamped to the
        head); returns the number of records reclaimed.  Offsets of the
        surviving records are unchanged."""
        cut = min(max(offset, self.base), self.head) - self.base
        if cut <= 0:
            return 0
        del self.records[:cut]
        self.base += cut
        self.records_reclaimed += cut
        return cut

    @property
    def head(self) -> int:
        return self.base + len(self.records)


@dataclass
class Topic:
    """A named topic with a fixed partition count; records route by document
    id hash (kafka partition-by-key, lambdas-driver routing).  ``place``
    pins individual docs to explicit partitions — the mesh-alignment seam:
    when a serving fleet places docs on device shards, pinning each doc's
    partition to its shard makes summary ownership follow doc placement
    (partition_manager.ScribePool.align_to_placement).  Unpinned docs keep
    the hash route; re-pinning moves only a doc's FUTURE records (already
    produced records stay where they landed — consumers drain them under
    the ordinary at-least-once contract)."""

    name: str
    n_partitions: int = 4
    partitions: dict[int, Partition] = field(default_factory=dict)
    placement: dict[str, int] = field(default_factory=dict)

    def place(self, doc_id: str, partition: int) -> None:
        if not (0 <= partition < self.n_partitions):
            raise ValueError(
                f"partition {partition} outside 0..{self.n_partitions - 1}"
            )
        self.placement[doc_id] = partition

    def partition_for(self, doc_id: str) -> int:
        placed = self.placement.get(doc_id)
        if placed is not None:
            return placed
        return sum(doc_id.encode()) % self.n_partitions

    def partition(self, idx: int) -> Partition:
        if idx not in self.partitions:
            self.partitions[idx] = Partition()
        return self.partitions[idx]

    def produce(self, doc_id: str, payload: Any) -> tuple[int, int]:
        p = self.partition_for(doc_id)
        return p, self.partition(p).append(doc_id, payload)

    def lag(self, offsets: dict[int, int]) -> int:
        """Unconsumed records across partitions given consumer offsets."""
        return sum(
            self.partition(i).head - offsets.get(i, 0)
            for i in range(self.n_partitions)
        )


# ---------------------------------------------------------------------------
# Durable backend
# ---------------------------------------------------------------------------

class DurablePartition(Partition):
    """Append-only JSONL file per partition: every append encodes and
    flushes one line; opening replays the file into memory (the broker's
    log segment). ``encode``/``decode`` map payloads <-> JSON values."""

    def __init__(
        self,
        path: str,
        encode: Callable[[Any], Any] = lambda p: p,
        decode: Callable[[Any], Any] = lambda p: p,
    ) -> None:
        super().__init__()
        self._path = path
        self._encode = encode
        self._decode = decode
        self.bytes_reclaimed = 0
        if os.path.exists(path):
            good_bytes = 0
            with open(path, "rb") as f:
                raw_lines = f.read().split(b"\n")
            for i, raw in enumerate(raw_lines):
                if not raw.strip():
                    good_bytes += len(raw) + 1
                    continue
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    if i == len(raw_lines) - 1:
                        # Torn trailing write (crash/disk-full mid-append):
                        # drop the partial record, keep the good prefix —
                        # recovery must not be blocked by the very crash it
                        # exists for.
                        break
                    raise
                if "base" in rec and "doc" not in rec:
                    # Compaction header (always the first line after a
                    # truncate_below rewrite): offsets resume above the
                    # reclaimed prefix.
                    self.base = int(rec["base"])
                else:
                    super().append(rec["doc"], decode(rec["payload"]))
                good_bytes += len(raw) + 1
            with open(path, "r+b") as f:
                f.truncate(min(good_bytes, os.path.getsize(path)))
        self._file = open(path, "a")

    # Chaos fault hook (testing/chaos.py "delayed partition fsync"): when
    # > 0, every durable append stalls this long AFTER the flush —
    # simulating slow durable media.  Correctness must not depend on append
    # latency (acks externalize only after their own fsync elsewhere), so
    # the soak asserts the stack merely slows down, never diverges.
    fault_flush_delay_s: float = 0.0

    def append(self, doc_id: str, payload: Any) -> int:
        off = super().append(doc_id, payload)
        self._file.write(
            json.dumps({"doc": doc_id, "payload": self._encode(payload)}) + "\n"
        )
        self._file.flush()
        if self.fault_flush_delay_s > 0.0:
            time.sleep(self.fault_flush_delay_s)
        return off

    def truncate_below(self, offset: int) -> int:
        """Reclaim records below ``offset`` AND rewrite the segment file
        without them (write-fsync-rename, like every other recovery file):
        a crash mid-compaction leaves the previous full segment intact.
        The surviving file leads with a ``{"base": N}`` header so a reopen
        resumes at the right offsets."""
        before = os.path.getsize(self._path) if os.path.exists(self._path) else 0
        cut = super().truncate_below(offset)
        if cut == 0:
            return 0
        self._file.close()
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"base": self.base}) + "\n")
            for rec in self.records:
                f.write(
                    json.dumps(
                        {"doc": rec.doc_id, "payload": self._encode(rec.payload)}
                    )
                    + "\n"
                )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
        self._file = open(self._path, "a")
        self.bytes_reclaimed += max(before - os.path.getsize(self._path), 0)
        return cut

    def close(self) -> None:
        self._file.close()


class DurableTopic(Topic):
    """A Topic whose partitions persist under ``directory/<name>/p<idx>``."""

    def __init__(
        self,
        name: str,
        n_partitions: int,
        directory: str,
        encode: Callable[[Any], Any] = lambda p: p,
        decode: Callable[[Any], Any] = lambda p: p,
    ) -> None:
        super().__init__(name=name, n_partitions=n_partitions)
        self._dir = os.path.join(directory, name)
        os.makedirs(self._dir, exist_ok=True)
        self._encode = encode
        self._decode = decode

    def partition(self, idx: int) -> Partition:
        if idx not in self.partitions:
            self.partitions[idx] = DurablePartition(
                os.path.join(self._dir, f"p{idx}.jsonl"),
                self._encode,
                self._decode,
            )
        return self.partitions[idx]

    def open_all(self) -> None:
        """Eagerly open every partition (reload all segments on recovery)."""
        for i in range(self.n_partitions):
            self.partition(i)

    def set_fault_flush_delay(self, delay_s: float) -> None:
        """Chaos fault hook: stall every partition's durable appends by
        ``delay_s`` (0 clears) — the 'slow disk' schedule event."""
        self.open_all()
        for p in self.partitions.values():
            if isinstance(p, DurablePartition):
                p.fault_flush_delay_s = delay_s

    def close(self) -> None:
        for p in self.partitions.values():
            if isinstance(p, DurablePartition):
                p.close()


# ---------------------------------------------------------------------------
# Consumer groups (lambdas-driver partition manager)
# ---------------------------------------------------------------------------

class ConsumerGroup:
    """Partition assignment + committed offsets for one consumer group.

    Membership changes rebalance immediately: partitions are dealt
    round-robin over the sorted membership (deterministic, like the
    reference's rebalance callback tearing down/recreating per-partition
    lambdas). Committed offsets are group-global, so any member resuming a
    partition continues from the group's checkpoint; with ``directory``
    they persist across restarts."""

    def __init__(self, topic: Topic, group_id: str, directory: str | None = None) -> None:
        self.topic = topic
        self.group_id = group_id
        self.members: list[str] = []
        self.generation = 0  # bumps on every rebalance
        # Explicit partition pins (mesh alignment): a pinned partition is
        # owned by exactly its pinned member while that member is alive;
        # a pin to a dead/absent member falls back to round-robin, so a
        # kill never strands a partition.
        self.pins: dict[int, str] = {}
        self._offsets: dict[int, int] = {}
        # Records a resuming consumer could not read because compaction
        # already reclaimed them (committed offset below the truncated
        # floor): counted, never raised — the content lives in an acked
        # summary, so resuming at the floor is the correct recovery.
        self.truncated_records_skipped = 0
        self._path = (
            os.path.join(directory, f"offsets-{group_id}.json")
            if directory is not None
            else None
        )
        if self._path is not None and os.path.exists(self._path):
            with open(self._path) as f:
                self._offsets = {int(k): v for k, v in json.load(f).items()}

    # ------------------------------------------------------------ membership
    def join(self, member_id: str) -> None:
        if member_id not in self.members:
            self.members.append(member_id)
            self.generation += 1

    def leave(self, member_id: str) -> None:
        if member_id in self.members:
            self.members.remove(member_id)
            self.generation += 1

    def pin(self, partition: int, member_id: str) -> None:
        """Pin a partition to one member (placement alignment); overrides
        round-robin while the member is alive, falls back when it is not."""
        if self.pins.get(partition) != member_id:
            self.pins[partition] = member_id
            self.generation += 1

    def unpin(self, partition: int) -> None:
        if self.pins.pop(partition, None) is not None:
            self.generation += 1

    def assignments(self, member_id: str) -> list[int]:
        ordered = sorted(self.members)
        if member_id not in ordered:
            return []
        rank = ordered.index(member_id)
        out = []
        for p in range(self.topic.n_partitions):
            owner = self.pins.get(p)
            if owner is not None and owner in self.members:
                if owner == member_id:
                    out.append(p)
            elif p % len(ordered) == rank:
                out.append(p)
        return out

    # --------------------------------------------------------------- offsets
    def committed(self, partition: int) -> int:
        """The group's resume offset: never below the partition's truncated
        floor — an offset pointing into a reclaimed prefix resumes at the
        floor (the skipped records are already folded into acked summaries;
        ``consume`` counts them)."""
        stored = self._offsets.get(partition, 0)
        return max(stored, self.topic.partition(partition).base)

    def commit(self, partition: int, offset: int) -> None:
        self._offsets[partition] = offset
        if self._path is not None:
            atomic_json_dump(self._offsets, self._path)

    def consume(
        self, member_id: str, max_records: int = 1 << 30
    ) -> list[tuple[int, LogRecord]]:
        """(partition, record) for every assigned partition from its
        committed offset (the caller commits after processing —
        at-least-once)."""
        out: list[tuple[int, LogRecord]] = []
        for p in self.assignments(member_id):
            part = self.topic.partition(p)
            stored = self._offsets.get(p, 0)
            if stored < part.base:
                # Resume-below-floor: count the gap once and adopt the
                # floor as the committed position (the records are gone;
                # re-reporting the same gap every pump would lie).
                self.truncated_records_skipped += part.base - stored
                self.commit(p, part.base)
            for rec in part.read(self.committed(p), max_records):
                out.append((p, rec))
        return out

    def lag(self) -> int:
        return self.topic.lag(self._offsets)



class CheckpointStore:
    """Durable per-document checkpoint records for the batched engines.

    One JSON file per document under ``directory/<topic>/``, written with
    the same atomic write-fsync-rename discipline as consumer offsets
    (``atomic_json_dump``): a crash mid-checkpoint leaves the previous good
    checkpoint intact, never a torn file.  Records are opaque dicts; the
    store stamps each with the doc id and the caller's sequence floor so
    restart can resume replay after the checkpoint:

        {"doc": <id>, "seq": <last seq folded in>, ...engine payload...}

    This is the DDS-level checkpoint the overflow-recovery replay was
    waiting on (doc_batch_engine: "bounding it needs DDS-level checkpoints
    to replay from"): the engine truncates its retained wire log to ops
    after ``seq`` once the record is durable.
    """

    def __init__(self, directory: str, topic: str = "checkpoints") -> None:
        self._dir = os.path.join(directory, topic)
        os.makedirs(self._dir, exist_ok=True)

    @staticmethod
    def _encode_id(doc_id: str) -> str:
        # Doc ids are caller-controlled; encode anything path-hostile.
        # Escapes are per UTF-8 BYTE (always exactly two hex digits — a
        # codepoint escape like %20ac would be ambiguous: %20 + literal
        # "ac" parses identically), and ``%`` itself always encodes (it
        # is not alnum/-_.), so every literal ``%`` in a filename is an
        # escape and distinct ids get distinct names — decoding is exact.
        return "".join(
            c if c.isalnum() or c in "-_."
            else "".join(f"%{b:02x}" for b in c.encode("utf-8"))
            for c in str(doc_id)
        )

    @staticmethod
    def _decode_name(name: str) -> str | None:
        """Filename stem -> doc id, or None when the name is not something
        ``_encode_id`` could have produced (legacy/operator-copied files:
        the caller falls back to reading the record's ``doc`` field)."""
        out = bytearray()
        i, n = 0, len(name)
        while i < n:
            c = name[i]
            if c == "%":
                if i + 3 > n:
                    return None
                try:
                    out.append(int(name[i + 1 : i + 3], 16))
                except ValueError:
                    return None
                i += 3
            else:
                out.extend(c.encode("utf-8"))
                i += 1
        try:
            decoded = out.decode("utf-8")
        except UnicodeDecodeError:
            # Escapes that are not a UTF-8 sequence — e.g. a legacy name
            # written by the old per-CODEPOINT encoder for a non-ASCII id
            # ("%e9" for "é"): ambiguous, read the file instead.
            return None
        # Round-trip check: a name our encoder could not have written
        # (" ", uppercase hex escapes, an unescaped char that should have
        # been escaped) is ambiguous — let the caller read the file.
        return decoded if CheckpointStore._encode_id(decoded) == name else None

    def _path(self, doc_id: str) -> str:
        return os.path.join(self._dir, f"{self._encode_id(doc_id)}.json")

    def _legacy_path(self, doc_id: str) -> str | None:
        """The pre-UTF-8-byte-escape filename (one ``%xx`` per CODEPOINT)
        for ids where it differs from ``_path`` — records written before
        the encoder change live there until the next ``save`` migrates
        them.  None when the encodings agree (ASCII-only escapes)."""
        legacy = "".join(
            c if c.isalnum() or c in "-_." else f"%{ord(c):02x}"
            for c in str(doc_id)
        )
        if legacy == self._encode_id(doc_id):
            return None
        return os.path.join(self._dir, f"{legacy}.json")

    def _read_path(self, doc_id: str) -> str:
        """The existing file for a doc: the current encoding, or the
        legacy one when only it exists (old checkpoint dirs must not be
        orphaned by the encoder change — their replay floors are real)."""
        path = self._path(doc_id)
        if not os.path.exists(path):
            legacy = self._legacy_path(doc_id)
            if legacy is not None and os.path.exists(legacy):
                return legacy
        return path

    def save(self, doc_id: str, seq: int, record: dict) -> None:
        atomic_json_dump({"doc": str(doc_id), "seq": int(seq), **record},
                         self._path(doc_id))
        # A save supersedes any legacy-named record: drop it so docs()
        # cannot list the doc twice / load a stale floor after this one.
        # Discard-is-the-intent: the legacy file usually does not exist.
        legacy = self._legacy_path(doc_id)
        if legacy is not None:
            with contextlib.suppress(OSError):
                os.unlink(legacy)

    def load(self, doc_id: str) -> dict | None:
        path = self._read_path(doc_id)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            # A corrupt record must not block restart (the atomic writer
            # makes this near-impossible; belt and braces for operator-
            # copied files): recover by full replay instead.
            return None

    def docs(self) -> list[str]:
        """Doc ids with a checkpoint record.  The id is decoded from the
        FILENAME (``_encode_id`` round-trips exactly), so the restore scan
        is one directory listing — not a read + JSON parse of every record
        (O(entries), not O(total checkpoint bytes)).  Only a name the
        encoder could not have produced (legacy/operator-copied files)
        falls back to reading the record's ``doc`` field."""
        out = []
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".json"):
                continue
            doc = self._decode_name(name[: -len(".json")])
            if doc is not None:
                out.append(doc)
                continue
            try:
                with open(os.path.join(self._dir, name)) as f:
                    out.append(json.load(f)["doc"])
            except (json.JSONDecodeError, OSError, KeyError):
                continue
        return out

    def mtime(self, doc_id: str) -> float | None:
        """The record file's mtime (None: no record) — a change detector
        for trailing readers.  The atomic save replaces the file, so an
        unchanged mtime means unchanged bytes; a trailing standby polls
        this instead of re-reading and re-parsing every record."""
        try:
            return os.stat(self._read_path(doc_id)).st_mtime_ns / 1e9
        except OSError:
            return None

    def load_many(
        self, doc_ids: list[str], max_workers: int | None = None
    ) -> dict[str, dict | None]:
        """Load many docs' records concurrently (thread pool over per-doc
        ``load`` — pure independent file reads): the batched-restore load
        phase pays max(read latency), not the sum.  Returns
        {doc_id -> record or None}, same per-doc semantics as ``load``."""
        from concurrent.futures import ThreadPoolExecutor

        ids = list(doc_ids)
        if len(ids) <= 1:
            return {d: self.load(d) for d in ids}
        workers = max_workers or min(8, len(ids))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return dict(zip(ids, ex.map(self.load, ids)))
