"""Restore's scan guard and boot-snapshot adoption.

``restore_candidates``, ``AdoptResult``, ``OneRecordStore`` and
``adopt_boot_snapshot`` of ``fluidframework_tpu/models/placement.py``.  The
placement plane, slot indirection and migration of that module are not
ported (the port's fleet rows are doc-indexed).
"""

from __future__ import annotations

from typing import Callable, NamedTuple


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
