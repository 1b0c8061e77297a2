"""Restore's scan guard: ``restore_candidates`` of
``fluidframework_tpu/models/placement.py``.  The placement plane, slot
indirection and migration of that module are not ported (the port's fleet
rows are doc-indexed)."""

from __future__ import annotations

from typing import Callable


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
