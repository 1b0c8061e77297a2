"""Durable per-document checkpoint records.

``atomic_json_dump`` and ``CheckpointStore`` of
``fluidframework_tpu/server/ordered_log.py``, unchanged: one JSON file per
document, written temp-file, fsync, rename.  The file names and the
record layout are the reference's, so a store either package wrote
restores in the other (tests/test_torch_checkpoint.py).  The topics,
partitions and consumer groups of that module are not ported.
"""

from __future__ import annotations

import contextlib
import json
import os


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
