"""The engine-agnostic half of checkpoint and restore.

``load_checkpoint_records``, ``stale_due_docs``, ``write_checkpoint_records``,
``RecoveryTracker`` and ``BackgroundCheckpointWriter`` of
``fluidframework_tpu/models/recovery.py``, with its flight-recorder spans
(``restore_load``, ``checkpoint``) and the ``recovery_complete`` instant.

Thread-safety contract: a checkpoint record is BUILT under the engine's
re-entrant ``ckpt_lock`` (taken by ``step``/``ingest``/``maybe_checkpoint``/
``restore_from_checkpoints``, so a sweep only ever sees an op boundary) and
WRITTEN after it is released, one record at a time under ``_ckpt_io_lock``
with per-doc seq fencing: the durable fsyncs never stall the serving
thread, and two sweeps never write an older record over a newer one.  The
background writer's thread enters the engine only through
``engine.checkpoint_stale``, so every record it builds (the tree engine's
trunk fold and ``em.summarize()``, which touch the engine's MarkPool; the
string engine's device reads of a row) is built under ``ckpt_lock``, never
beside the serving thread's ingest or step.  On the card both threads issue
on the process's default stream, so a record's ``.cpu()`` reads wait for
every step the serving thread launched before it.
"""

from __future__ import annotations

import threading
import time

from ..observability.flight_recorder import instant, span
from ..utils.telemetry import Histogram


def load_checkpoint_records(
    store, doc_keys: list[str], parallel: bool = True,
    max_workers: int | None = None,
) -> dict[int, dict]:
    """Load every listed doc's checkpoint record; returns {index in
    ``doc_keys`` -> record} for the docs that have one.

    The parallel path uses the store's ``load_many`` when it provides one
    (``CheckpointStore`` does: a thread pool over per-doc JSON reads —
    restore wall time becomes max(read), not sum(read)).  Stores without
    ``load_many`` (e.g. the scribe's read-only ``SummaryRecordStore``,
    whose object-store thread safety is not guaranteed) and the
    ``parallel=False`` oracle path load sequentially.  Either way the
    result is keyed by position, so the caller's doc-order build loop is
    identical — load concurrency can never reorder restores.
    """
    load_many = getattr(store, "load_many", None) if parallel else None
    with span(
        "restore_load", docs=len(doc_keys), parallel=int(load_many is not None),
    ):
        if load_many is not None:
            by_key = load_many(doc_keys, max_workers=max_workers)
        else:
            by_key = {k: store.load(k) for k in doc_keys}
    return {
        i: rec
        for i, k in enumerate(doc_keys)
        if (rec := by_key.get(k)) is not None
    }


def stale_due_docs(
    hosts, n_docs: int, max_ops_behind: int, max_seconds_behind: float,
    now: float,
) -> list[int]:
    """The bounded-staleness due list shared by both engines: dirty docs
    whose durable record trails by more than the configured op/second
    bounds (0 disables a bound)."""
    return [
        d for d in range(n_docs)
        if hosts[d].ops_since_ckpt > 0 and (
            (max_ops_behind and hosts[d].ops_since_ckpt >= max_ops_behind)
            or (
                max_seconds_behind
                and hosts[d].dirty_since
                and now - hosts[d].dirty_since >= max_seconds_behind
            )
        )
    ]


def write_checkpoint_records(
    engine, pending: list[tuple[int, int, dict]]
) -> None:
    """Durable half of a checkpoint sweep, shared by both engines and run
    AFTER ``ckpt_lock`` releases (crash-safe: the in-memory floor
    advancing first only means a crash before the write replays a little
    more from the upstream log).  ``_ckpt_io_lock`` + per-doc seq fencing
    keep concurrent sweeps (background writer vs the serving thread's
    cadence) from racing an older record over a newer one.  A FAILED save
    re-marks its doc dirty for retry — taken outside ``_ckpt_io_lock``,
    in the same ckpt-before-io order as the serving thread, so there is
    no deadlock — because the floor already advanced in memory and
    without the re-mark a quiet doc's stale record would hide behind
    healthy-looking gauges."""
    if not pending:
        return
    failed: list[int] = []
    for d, seq, record in pending:
        # io_lock held PER RECORD, not across the batch: a cadence
        # checkpoint from step() (which holds the re-entrant ckpt_lock)
        # that lands here mid-background-sweep waits behind at most one
        # fsync, not the writer's whole batch — a batch-wide hold would
        # convoy every ingest/step on ckpt_lock for the full sweep.
        with engine._ckpt_io_lock:
            if seq < engine._ckpt_saved_seq.get(d, -1):
                continue  # a concurrent sweep already wrote newer
            try:
                with span("checkpoint", doc=engine.doc_keys[d],
                          lane=record.get("lane")):
                    engine.checkpoint_store.save(engine.doc_keys[d], seq, record)
            except OSError:
                failed.append(d)
                continue
            engine._ckpt_saved_seq[d] = seq
    if failed:
        with engine.ckpt_lock:
            for d in failed:
                h = engine.hosts[d]
                h.ops_since_ckpt = max(1, h.ops_since_ckpt)
                if not h.dirty_since:
                    h.dirty_since = time.monotonic()
        engine.counters.bump("checkpoint_write_failures", len(failed))


class RecoveryTracker:
    """Per-incident recovery clock: kill (or restore start) -> first
    post-restore op applied on device.

    ``begin`` is idempotent-earliest: a caller that knows the actual kill
    time stamps it first and a later restore-start begin cannot shrink the
    measured window.  ``complete`` (called from the engine's step once
    real ops applied) closes the incident into the histogram and emits a
    ``recovery_complete`` flight-recorder instant."""

    def __init__(self) -> None:
        self.histogram = Histogram()
        self.incidents = 0
        self.last_ms: float | None = None
        self._t0: float | None = None

    def begin(self, started_at: float | None = None) -> None:
        """Open (or back-date) the current incident.  ``started_at`` is in
        ``time.monotonic`` domain; None = now."""
        t0 = time.monotonic() if started_at is None else float(started_at)
        if self._t0 is None or t0 < self._t0:
            self._t0 = t0

    @property
    def active(self) -> bool:
        return self._t0 is not None

    @property
    def started_at(self) -> float | None:
        """The open incident's start (``time.monotonic`` domain), or None.
        A supervisor replacing the engine mid-incident carries this onto
        the successor (``note_incident``) so the unresolved window is
        measured, not dropped."""
        return self._t0

    def cancel(self) -> None:
        """Abandon the open incident without recording it (a standby's
        boot-time restore is preparation, not recovery — only a real
        promotion/restart should measure)."""
        self._t0 = None

    def complete(self) -> float | None:
        """Close the open incident; returns the recovery seconds (None if
        no incident was open)."""
        if self._t0 is None:
            return None
        dt = max(0.0, time.monotonic() - self._t0)
        self._t0 = None
        self.incidents += 1
        self.last_ms = round(dt * 1e3, 3)
        self.histogram.record(dt)
        instant("recovery_complete", ms=self.last_ms)
        return dt

    def emit_gauges(self, counters) -> None:
        """The engines' shared health() surface for recovery time."""
        counters.gauge("recovery_incidents", self.incidents)
        counters.gauge("recovery_pending", int(self.active))
        if self.histogram.count:
            counters.gauge(
                "recovery_p50_ms",
                round(self.histogram.percentile(0.5) * 1e3, 3),
            )
            counters.gauge(
                "recovery_p99_ms",
                round(self.histogram.percentile(0.99) * 1e3, 3),
            )
            counters.gauge("last_recovery_ms", self.last_ms)


class BackgroundCheckpointWriter:
    """Bounded-staleness delta-checkpoint writer (daemon thread).

    Every ``interval_s`` the thread asks the engine to checkpoint any
    dirty doc whose durable record has fallen ``max_ops_behind`` applied
    ops or ``max_seconds_behind`` seconds behind (``engine.
    checkpoint_stale`` — which takes the engine's checkpoint lock, so the
    sweep serializes against the serving thread's step/ingest).  The
    engine's own ``checkpoint_every`` cadence keeps hot docs bounded by
    op count; this writer bounds the COLD tail — a doc that went quiet
    one op after its last checkpoint stays one op (not one busy-period)
    of replay away from restored.
    """

    def __init__(
        self,
        engine,
        max_ops_behind: int = 0,
        max_seconds_behind: float = 1.0,
        interval_s: float = 0.25,
    ) -> None:
        self._engine = engine
        self.max_ops_behind = int(max_ops_behind)
        self.max_seconds_behind = float(max_seconds_behind)
        self.interval_s = max(0.01, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Guards the sweep counters: the thread body writes them, stats()
        # reads them from the supervising thread.
        self._lock = threading.Lock()
        self._sweeps = 0
        self._written = 0
        self._errors = 0

    def start(self) -> "BackgroundCheckpointWriter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="ckpt-writer", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            # A sweep failure must not kill the writer: the engine already
            # re-marks docs whose durable write failed, so the next tick
            # retries; the error count is the health signal.
            try:
                wrote = self._engine.checkpoint_stale(
                    max_ops_behind=self.max_ops_behind,
                    max_seconds_behind=self.max_seconds_behind,
                )
            except Exception:  # noqa: BLE001 — surfaced via stats()
                with self._lock:
                    self._sweeps += 1
                    self._errors += 1
                continue
            with self._lock:
                self._sweeps += 1
                self._written += len(wrote)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "ckpt_writer_sweeps": self._sweeps,
                "ckpt_writer_records": self._written,
                "ckpt_writer_errors": self._errors,
                "max_ops_behind": self.max_ops_behind,
                "max_seconds_behind": self.max_seconds_behind,
            }
