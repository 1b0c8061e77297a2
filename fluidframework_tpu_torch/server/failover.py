"""Warm-standby failover plane: lease files, heartbeats, and standby fleets.

A copy of ``fluidframework_tpu/server/failover.py`` over the port's engines.
A warm standby boots a second fleet engine ahead of need, warms every
serving program (``engine.warmup``: on the card, the kernel library's load
and each program's first launch), continuously trails the primary's durable
checkpoints (``restore_from_checkpoints(refresh=True)``) and promotes the
moment the primary's lease lapses — recovery cost becomes the dirty tail
since the last checkpoint, not a boot.

Pieces:

- ``LeaseFile`` — an epoch-fenced lease on a shared file, written with the
  ordered_log atomic write-fsync-rename discipline.  Wall-clock expiry
  (``time.time``: leases cross processes), epoch fencing so a paused
  ex-holder that wakes up cannot silently reclaim a lease someone else
  took over (its renew fails on the epoch mismatch).
- ``LeaseHeartbeat`` — a daemon thread renewing the holder's lease every
  ttl/3; losing the lease flips ``lost`` (and fires ``on_lost``), the
  primary's cue to stand down.  Counters are lock-guarded: the thread
  writes them, the supervisor reads them.
- ``WarmStandby`` — the standby side: owns a pre-warmed engine, trails the
  checkpoint store on ``poll_s``, and ``promote()``s when the primary
  lease lapses (one final trail + lease takeover; the caller then attaches
  the firehose consumer, whose seq-floor dedupe replays only the
  post-checkpoint tail).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from ..observability.flight_recorder import instant, span
from .ordered_log import atomic_json_dump


class LeaseFile:
    """An epoch-fenced, wall-clock-expiring lease on a shared file.

    At most one holder at a time considers itself the owner; ownership
    transfers only through expiry (or explicit release).  Every acquire
    bumps the epoch, and ``renew`` refuses to touch a file whose epoch (or
    holder) moved on — the fencing that keeps a de-scheduled ex-primary
    from resurrecting a lease its successor already took.
    """

    def __init__(self, path: str, holder: str, ttl_s: float = 2.0) -> None:
        self.path = path
        self.holder = str(holder)
        self.ttl_s = float(ttl_s)
        self.epoch = -1  # the epoch WE hold (-1 = not holding)

    # ------------------------------------------------------------------ file
    def read(self) -> dict | None:
        """The lease record on disk (None: no file / unreadable torn copy
        an operator made — the atomic writer itself never tears)."""
        import json

        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self, epoch: int) -> None:
        atomic_json_dump(
            {
                "holder": self.holder,
                "epoch": epoch,
                "expires": time.time() + self.ttl_s,
                "ttl_s": self.ttl_s,
            },
            self.path,
        )

    # ------------------------------------------------------------- ownership
    @staticmethod
    def _expired(rec: dict | None) -> bool:
        return rec is None or float(rec.get("expires", 0)) <= time.time()

    def holder_alive(self) -> bool:
        """True while SOMEONE (possibly us) holds an unexpired lease."""
        return not self._expired(self.read())

    def held_by_other(self) -> bool:
        rec = self.read()
        return not self._expired(rec) and rec.get("holder") != self.holder

    def _mutex(self, timeout_s: float = 0.5) -> bool:
        """Cross-process mutex for the lease read-modify-write (an
        ``O_EXCL`` sidecar file): without it two contenders that both
        observe an expired lease both write epoch N+1 and both believe
        they own it — a split-brain window the epoch fencing alone only
        detects at the NEXT renew.  Holders keep it for microseconds; a
        sidecar older than 5 s is a crashed holder's leftover and gets
        broken.  Returns False on timeout (caller treats the attempt as
        lost/skipped, never as ownership)."""
        deadline = time.monotonic() + timeout_s
        lockp = self.path + ".lock"
        while True:
            try:
                fd = os.open(lockp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return True
            except FileExistsError:
                try:
                    if time.time() - os.stat(lockp).st_mtime > 5.0:
                        # Break via rename-to-unique: exactly ONE breaker
                        # wins the rename (a plain unlink-and-retry lets
                        # two breakers both remove a lock — the second
                        # removes the first breaker's FRESH lock and both
                        # enter the critical section).
                        broken = f"{lockp}.break-{os.getpid()}"
                        os.rename(lockp, broken)
                        with contextlib.suppress(OSError):
                            os.unlink(broken)
                        continue
                except OSError:
                    continue  # holder released / another breaker won
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.005)
            except OSError:
                return False  # unwritable dir: fall back to fencing only

    def _unmutex(self) -> None:
        with contextlib.suppress(OSError):
            os.unlink(self.path + ".lock")

    def acquire(self, force: bool = False) -> bool:
        """Take the lease when it is free/expired (or ``force``); returns
        True on ownership.  Re-acquiring a lease we already hold renews
        it in place without an epoch bump."""
        if not self._mutex():
            return False  # someone else is mid-take: we did not get it
        try:
            rec = self.read()
            if not self._expired(rec) and not force:
                if (
                    rec.get("holder") == self.holder
                    and rec.get("epoch") == self.epoch
                ):
                    self._write(self.epoch)
                    return True
                return False
            epoch = (int(rec.get("epoch", -1)) if rec is not None else -1) + 1
            self._write(epoch)
            self.epoch = epoch
        finally:
            self._unmutex()
        instant("lease_acquired", holder=self.holder, epoch=epoch)
        return True

    def renew(self) -> bool:
        """Extend the lease iff we still hold it at our epoch; False means
        the lease moved on (expired + re-acquired elsewhere) and the
        caller must stand down."""
        if self.epoch < 0:
            return False
        if not self._mutex():
            # Mid-take contention at renew time: skip THIS extension
            # rather than stand down — the record is untouched, the next
            # tick re-checks, and expiry still fences a real takeover.
            return True
        try:
            rec = self.read()
            if (
                rec is None
                or rec.get("holder") != self.holder
                or int(rec.get("epoch", -1)) != self.epoch
            ):
                self.epoch = -1
                return False
            self._write(self.epoch)
            return True
        finally:
            self._unmutex()

    def release(self) -> None:
        """Expire our lease immediately (clean shutdown: the standby
        promotes without waiting out the ttl)."""
        if self.epoch < 0:
            return
        if not self._mutex():
            self.epoch = -1  # contended: let the ttl lapse it instead
            return
        try:
            rec = self.read()
            if (
                rec is not None
                and rec.get("holder") == self.holder
                and int(rec.get("epoch", -1)) == self.epoch
            ):
                atomic_json_dump(
                    {
                        "holder": self.holder,
                        "epoch": self.epoch,
                        "expires": 0.0,
                        "ttl_s": self.ttl_s,
                    },
                    self.path,
                )
        finally:
            self._unmutex()
        self.epoch = -1


class LeaseHeartbeat:
    """Daemon thread renewing a held lease every ``ttl/3``.

    ``lost`` flips (latched) the first time a renew fails — the primary's
    stand-down signal; ``on_lost`` fires once from the heartbeat thread.
    The counters are guarded by ``_lock`` because the supervising thread
    reads them through ``stats()`` while the heartbeat writes them."""

    def __init__(self, lease: LeaseFile, on_lost=None) -> None:
        self.lease = lease
        self.on_lost = on_lost
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._renewals = 0
        self._errors = 0
        self._lost = False

    def start(self) -> "LeaseHeartbeat":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="lease-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        interval = max(0.05, self.lease.ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                renewed = self.lease.renew()
            except OSError:
                # Transient write failure (disk full, EIO) is a SKIPPED
                # renew, not a death sentence for the thread: the record
                # is untouched, the next tick retries, and if the lease
                # really lapses meanwhile a successor's takeover makes
                # the next renew() return False -> lost -> stand-down.
                # A dead heartbeat thread with lost=False would let the
                # ex-primary serve on unfenced — the very split-brain
                # this thread exists to prevent.
                with self._lock:
                    self._errors += 1
                continue
            if renewed:
                with self._lock:
                    self._renewals += 1
            else:
                with self._lock:
                    already = self._lost
                    self._lost = True
                if not already:
                    instant("lease_lost", holder=self.lease.holder)
                    if self.on_lost is not None:
                        self.on_lost()
                return  # fenced out: renewing harder would split-brain

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def lost(self) -> bool:
        with self._lock:
            return self._lost

    def stats(self) -> dict:
        with self._lock:
            return {
                "lease_renewals": self._renewals,
                "lease_renew_errors": self._errors,
                "lease_lost": self._lost,
            }


class WarmStandby:
    """The standby half of fleet failover.

    Owns a fleet engine built ahead of need: ``prepare()`` warms
    the serving programs (``engine.warmup``) and performs the first
    checkpoint restore; ``trail()`` re-adopts any doc whose durable record
    advanced (``restore_from_checkpoints(refresh=True)``) so the state on
    device never trails the store by more than one poll; ``promote()``
    runs one final trail, takes the lease, and hands the engine back —
    the caller attaches the firehose consumer and serves.  ``watch()``
    wraps the poll loop for process-level standbys (fleet_main
    --standby).

    Requires an engine whose ``restore_from_checkpoints`` supports
    ``refresh=`` trailing re-adoption — both fleet families do
    (``DocBatchEngine`` scatters the fresh summary over the doc's row;
    ``TreeBatchEngine`` resets the doc's pooled columns to the proto row
    and re-materializes the newer checkpoint forest on top), so a mixed
    string+tree deployment runs one standby per family."""

    def __init__(
        self,
        engine,
        store,
        lease: LeaseFile | None = None,
        poll_s: float = 0.25,
    ) -> None:
        self.engine = engine
        self.store = store
        self.lease = lease
        self.poll_s = float(poll_s)
        self.prepared = False
        self.trails = 0
        self.adoptions = 0
        self.promoted = False

    def prepare(self) -> "WarmStandby":
        """Boot the standby: warm every serving program and adopt the
        current checkpoints.  Idempotent."""
        if not self.prepared:
            with span("standby_prepare"):
                warm = getattr(self.engine, "warmup", None)
                if warm is not None:
                    warm()
                # refresh=True: adopt the current records WITHOUT opening
                # a recovery incident — standby boot is preparation; the
                # recovery clock belongs to the promotion (a plain
                # restore here would backdate the measured window to
                # standby-build time).
                self.engine.restore_from_checkpoints(
                    store=self.store, refresh=True
                )
            self.prepared = True
        return self

    def trail(self) -> int:
        """One trailing pass: re-adopt every doc whose stored record is
        newer than the engine's current floor; returns docs adopted."""
        adopted = self.engine.restore_from_checkpoints(
            store=self.store, refresh=True
        )
        self.trails += 1
        self.adoptions += len(adopted)
        return len(adopted)

    def should_promote(self) -> bool:
        """True once the primary's lease has LAPSED: a lease record
        exists and is expired (crash: the ttl ran out; clean shutdown:
        release() zeroes expiry).  No lease file plays it safe and says
        False — a primary only acquires after its engine build, so a
        standby started alongside it must not steal the lease during
        that window; a standby with no lease plumbing is promoted
        explicitly by its supervisor."""
        if self.lease is None:
            return False
        rec = self.lease.read()
        return rec is not None and LeaseFile._expired(rec)

    def promote(self, incident_started_at: float | None = None):
        """Final trail + lease takeover; returns the ready engine.  The
        caller stamps the incident start when it knows the real kill time
        (``incident_started_at``, time.monotonic domain) so the recovery
        histogram measures kill -> first applied op."""
        with span("standby_promote"):
            self.prepare()
            self.trail()
            if self.lease is not None:
                # The takeover must actually land: acquire can return
                # False while a contender (or a crashed holder's <5 s
                # sidecar) blocks the mutex.  Serving WITHOUT the lease
                # would skip the heartbeat downstream (`lease.epoch >= 0`
                # gate) and let a later standby promote on top of us.
                # The stale-break bounds the wait; past it, fail loudly
                # so the supervisor retries a clean promotion.
                deadline = time.monotonic() + 10.0
                while not self.lease.acquire(force=True):
                    if time.monotonic() >= deadline:
                        raise RuntimeError(
                            "standby promotion could not take the lease "
                            f"at {self.lease.path}"
                        )
                    time.sleep(0.05)
            # The promotion IS the incident: clear any stray boot-time
            # clock so the measured window starts at the kill, not at
            # standby build.
            self.engine.recovery_tracker.cancel()
            if incident_started_at is not None:
                self.engine.note_incident(incident_started_at)
            else:
                self.engine.recovery_tracker.begin()
        self.promoted = True
        self.engine.counters.bump("standby_promotions")
        instant("standby_promoted", trails=self.trails)
        return self.engine

    def watch(self, should_stop=lambda: False) -> bool:
        """Standby duty loop: trail on a cadence until the primary lease
        lapses (-> True: promote now) or ``should_stop`` (-> False)."""
        self.prepare()
        while not should_stop():
            if self.should_promote():
                return True
            self.trail()
            time.sleep(self.poll_s)
        return False


def write_heartbeat(path: str, payload: dict) -> None:
    """Supervisor liveness beacon (launcher): an atomic JSON stamp a
    standby controller (or operator) watches — same crash-safe discipline
    as every other recovery file."""
    atomic_json_dump({"ts": time.time(), **payload}, path)


def read_heartbeat(path: str, stale_after_s: float) -> tuple[dict | None, bool]:
    """-> (heartbeat record or None, is_fresh)."""
    import json

    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None, False
    return rec, time.time() - float(rec.get("ts", 0)) < stale_after_s
