"""Deployment launcher: spawn and supervise service-plane shards.

A port of ``fluidframework_tpu/server/launcher.py`` (no JAX in it).

Reference parity: the routerlicious deployment layer
(server/routerlicious/docker-compose.yml + server/charts helm): one config
declares the service processes; an operator command brings them up, waits
for readiness, and restarts crashed members. Here each "shard" is one
netserver ServicePlane process owning a disjoint document set (the
document-sharded scale-out axis); ``shard_for`` is the
client-side router (the Kafka partition-by-key analog at deployment
granularity).

Usage:
    python -m fluidframework_tpu_torch.server.launcher --config service-plane.json
or programmatically:
    dep = launch({"shards": [{"name": "s0"}, {"name": "s1"}]})
    host, port, http_port = dep.endpoint_for("some-doc-id")
    ...
    dep.stop()
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Shard:
    name: str
    port: int = 0  # 0 = ephemeral
    http_port: int = 0
    proc: subprocess.Popen | None = None
    restarts: int = 0
    # Crash-loop bookkeeping (supervisor-owned, read under the deployment
    # lock): recent crash timestamps inside the detection window, whether
    # the current death has been counted (``proc`` stays set while the
    # respawn backoff runs — readers keep a stable handle), the earliest
    # monotonic time the next respawn may run, whether the budget is
    # exhausted (respawns stop), and the last spawn failure.
    crash_times: list = field(default_factory=list)
    crash_acked: bool = False
    next_restart_at: float = 0.0
    backoff_s: float = 0.0
    crash_looped: bool = False
    last_error: str = ""


@dataclass
class Deployment:
    shards: list[Shard]
    supervise: bool = False
    # Restart budget (crash-loop detection): more than ``restart_budget``
    # crashes inside ``crash_window_s`` marks the shard crash-looped and
    # the supervisor STOPS respawning it — an endlessly dying member must
    # surface in the manifest, not burn ports/CPU relaunching forever.
    # Respawns inside the window back off exponentially
    # (``restart_backoff_s`` doubling up to ``max_restart_backoff_s``);
    # a shard that stays up past the window resets both.
    restart_budget: int = 5
    crash_window_s: float = 60.0
    restart_backoff_s: float = 0.5
    max_restart_backoff_s: float = 8.0
    # Liveness beacon: with a path configured the supervisor stamps an
    # atomic heartbeat JSON (ts + manifest) every ``heartbeat_every_s`` —
    # the file a standby controller (server/failover.read_heartbeat) or
    # operator watches to decide the whole deployment died, complementing
    # the per-fleet lease files.
    heartbeat_path: str | None = None
    heartbeat_every_s: float = 1.0
    _stopping: bool = field(default=False, repr=False)
    _thread: threading.Thread | None = field(default=None, repr=False)
    _hb_thread: threading.Thread | None = field(default=None, repr=False)
    # Guards shard records (proc/port/http_port/restarts) against the
    # supervisor thread's respawn writes: without it a router could read a
    # torn port mid-restart (fftpu-check thread-unlocked-write).  The
    # supervisor holds it across a whole respawn, so routing calls block
    # until the fresh port is real rather than returning the dead one.
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    # ------------------------------------------------------------- routing
    def endpoint_for(self, doc_id: str) -> tuple[str, int, int]:
        with self._lock:
            s = self.shards[shard_index(doc_id, len(self.shards))]
            return ("127.0.0.1", s.port, s.http_port)

    def manifest(self) -> dict:
        # A live pid only (see manifest_locked): a crash-looped / dying
        # shard's stale pid must not read as a running member.
        with self._lock:
            return self.manifest_locked()

    # ----------------------------------------------------------- lifecycle
    def stop(self) -> None:
        # Quiesce the supervisor FIRST: otherwise it can respawn a shard
        # concurrently with (or after) the termination sweep, leaking a
        # live child bound to the shard's ports.  The flag is set OUTSIDE
        # _lock deliberately — the supervisor may be holding the lock
        # across a 30s readiness wait, and it checks the flag to abort;
        # a plain monotonic bool store is the one cross-thread write here
        # that needs no lock (join() below is the ordering barrier).
        self._stopping = True
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
        if self._thread is not None:
            # _spawn aborts within one attempt cycle once _stopping is set
            # (readiness polls 1s slices with abort checks; worst case one
            # communicate() timeout of ~10s still applies).
            self._thread.join(timeout=60)
        with self._lock:
            for s in self.shards:
                if s.proc is not None and s.proc.poll() is None:
                    s.proc.terminate()
            for s in self.shards:
                if s.proc is not None:
                    try:
                        s.proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        s.proc.kill()

    def _record_crash(self, s: Shard, now: float) -> bool:
        """Account one crash (process death OR failed spawn) against the
        shard's sliding-window budget; returns False when the budget
        tripped (shard marked crash-looped, no further respawns).  On
        True, ``next_restart_at``/``backoff_s`` hold the escalated
        respawn schedule (first crash after a quiet window restarts
        immediately)."""
        s.crash_times = [
            t for t in s.crash_times if now - t < self.crash_window_s
        ] + [now]
        if len(s.crash_times) > self.restart_budget:
            s.crash_looped = True
            return False
        if len(s.crash_times) == 1:
            s.backoff_s = self.restart_backoff_s
            s.next_restart_at = now
        else:
            s.next_restart_at = now + s.backoff_s
            s.backoff_s = min(2 * s.backoff_s, self.max_restart_backoff_s)
        return True

    def _supervise_loop(self) -> None:
        while not self._stopping:
            for s in self.shards:
                if self._stopping:
                    break
                with self._lock:
                    if self._stopping:
                        break
                    if s.crash_looped:
                        continue
                    now = time.monotonic()
                    if (
                        not s.crash_acked
                        and s.proc is not None
                        and s.proc.poll() is not None
                    ):
                        # Crash acknowledged (once per death): budget
                        # check over the sliding window — a shard that
                        # keeps dying is crash-looping, so STOP respawning
                        # it and surface that in the manifest instead of
                        # hammering the same ports forever.  Repeat
                        # crashes inside the window respawn only after an
                        # exponentially backed-off delay; the first crash
                        # after a quiet period restarts immediately.
                        s.crash_acked = True
                        self._record_crash(s, now)
                        continue
                    if s.crash_acked and now >= s.next_restart_at:
                        # Respawn on the SAME ports so clients reconnect
                        # without re-routing (compose restart policy).
                        # Held lock spans the respawn: routing sees the
                        # old record or the fresh one, never a
                        # half-written port pair.
                        s.restarts += 1
                        try:
                            _spawn(s, abort=lambda: self._stopping)
                            s.last_error = ""
                            s.crash_acked = False
                        except Exception as e:
                            # A failed spawn IS a crash for budget
                            # purposes: a shard dying before its
                            # readiness line must trip crash_looped the
                            # same as one dying after it — otherwise it
                            # respawns forever at the backoff cap.  The
                            # due tick retries (supervisor never dies);
                            # the failure is visible in the manifest.
                            s.last_error = repr(e)[-200:]
                            self._record_crash(s, time.monotonic())
            time.sleep(0.2)

    def _heartbeat_loop(self) -> None:
        """Liveness beacon thread: stamps ``heartbeat_path`` every
        ``heartbeat_every_s`` REGARDLESS of what the supervisor thread is
        doing — a respawn's readiness wait can hold ``_lock`` for tens of
        seconds, and a beacon stamped from that thread would go stale and
        false-positive "deployment died" at a watcher mid-respawn.  The
        beacon signals process liveness (the daemon thread dies with the
        process); the manifest garnish is best-effort: when ``_lock`` is
        busy (supervisor mid-respawn) the stamp carries ``busy`` instead
        of blocking behind the respawn."""
        from .failover import write_heartbeat

        last_manifest: dict = {}
        while not self._stopping:
            # Bounded wait, never the full respawn: a fresh manifest when
            # the lock frees quickly, else the last known one + ``busy``.
            if self._lock.acquire(timeout=min(0.5, self.heartbeat_every_s)):
                try:
                    last_manifest = self.manifest_locked()
                    payload = last_manifest
                finally:
                    self._lock.release()
            else:
                payload = {**last_manifest, "busy": True}
            # Suppress, not handle: a transiently full disk must not kill
            # the beacon; the next tick re-stamps.
            with contextlib.suppress(OSError):
                write_heartbeat(self.heartbeat_path, payload)
            time.sleep(self.heartbeat_every_s)

    def manifest_locked(self) -> dict:
        """``manifest()`` body for callers already holding ``_lock``."""
        return {
            "shards": [
                {
                    "name": s.name,
                    "port": s.port,
                    "httpPort": s.http_port,
                    "pid": (
                        s.proc.pid
                        if s.proc is not None and s.proc.poll() is None
                        else None
                    ),
                    "restarts": s.restarts,
                    "crashLooped": s.crash_looped,
                    **({"lastError": s.last_error} if s.last_error else {}),
                }
                for s in self.shards
            ]
        }

    # ------------------------------------------------------------- promotion
    def promote(self, name: str) -> bool:
        """Operator/standby-controller promote path: revive a shard the
        restart budget gave up on (``crashLooped``) — or restart a dead
        one explicitly — reusing the supervisor's spawn machinery with a
        FRESH budget window.  Returns False for an unknown shard or one
        that is still alive."""
        with self._lock:
            shard = next((s for s in self.shards if s.name == name), None)
            if shard is None:
                return False
            if shard.proc is not None and shard.proc.poll() is None:
                return False  # alive: nothing to promote onto its ports
            shard.crash_times = []
            shard.crash_looped = False
            shard.crash_acked = False
            shard.backoff_s = 0.0
            shard.next_restart_at = 0.0
            shard.restarts += 1
            try:
                _spawn(shard, abort=lambda: self._stopping)
                shard.last_error = ""
            except Exception as e:  # noqa: BLE001 — surfaced in the manifest
                shard.last_error = repr(e)[-200:]
                self._record_crash(shard, time.monotonic())
                return False
            return True


def shard_index(doc_id: str, n_shards: int) -> int:
    return sum(doc_id.encode()) % n_shards


def _spawn(shard: Shard, attempts: int = 10, abort=None) -> None:
    """Start the shard process and wait for its readiness line. Retries a
    few times: a restart may race the dying process's listener (transient
    bind failure). ``abort`` (checked between attempts and after readiness)
    lets a stopping supervisor bail without leaking the fresh child."""
    env = dict(os.environ)
    cmd = [
        sys.executable, "-m", "fluidframework_tpu_torch.server.netserver",
        "--port", str(shard.port),
        "--http-port", str(shard.http_port),
    ]
    last_err = ""
    for attempt in range(attempts):
        if abort is not None and abort():
            raise RuntimeError(f"shard {shard.name} spawn aborted (stopping)")
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env
        )
        # Readiness wait: full 30s budget (cold hosts can take >10s), but
        # polled in 1s slices so an abort (stop()) reacts promptly.
        rdy = False
        for _tick in range(30):
            r, _w, _x = select.select([proc.stdout], [], [], 1)
            if r:
                rdy = True
                break
            if abort is not None and abort():
                break
        line = proc.stdout.readline() if rdy else ""
        if line.strip():
            if abort is not None and abort():
                proc.kill()
                proc.wait(timeout=10)
                raise RuntimeError(f"shard {shard.name} spawn aborted (stopping)")
            shard.proc = proc
            ready = json.loads(line)
            shard.port = ready["port"]
            shard.http_port = ready["httpPort"]
            # Drain both pipes for the life of the process: a chatty child
            # must never block on a full pipe buffer (which would stall the
            # server while poll() still says alive).
            for stream in (proc.stdout, proc.stderr):
                threading.Thread(
                    target=_drain, args=(stream,), daemon=True
                ).start()
            return
        proc.kill()
        try:
            _out, err = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            err = "readiness timeout"
        last_err = err.strip().splitlines()[-1] if err.strip() else "no output"
        time.sleep(0.1 * (attempt + 1))
    raise RuntimeError(f"shard {shard.name} failed to start: {last_err}")


def _drain(stream) -> None:
    # Suppress, not handle: the pipe closing mid-iteration IS shutdown.
    with contextlib.suppress(ValueError, OSError):
        for _line in stream:
            pass


def launch(config: dict, supervise: bool = False) -> Deployment:
    """Bring up every shard in the config, wait for readiness, optionally
    start the crash-restart supervisor."""
    shards = [
        Shard(
            name=entry.get("name", f"shard{i}"),
            port=int(entry.get("port", 0)),
            http_port=int(entry.get("httpPort", 0)),
        )
        for i, entry in enumerate(config.get("shards", [{}]))
    ]
    dep = Deployment(
        shards=shards,
        supervise=supervise,
        restart_budget=int(config.get("restartBudget", 5)),
        crash_window_s=float(config.get("crashWindowS", 60.0)),
        restart_backoff_s=float(config.get("restartBackoffS", 0.5)),
        max_restart_backoff_s=float(config.get("maxRestartBackoffS", 8.0)),
        heartbeat_path=config.get("heartbeatFile"),
        heartbeat_every_s=float(config.get("heartbeatEveryS", 1.0)),
    )
    try:
        for s in shards:
            _spawn(s)
    except BaseException:
        dep.stop()
        raise
    if supervise:
        dep._thread = threading.Thread(target=dep._supervise_loop, daemon=True)
        dep._thread.start()
        if dep.heartbeat_path is not None:
            dep._hb_thread = threading.Thread(
                target=dep._heartbeat_loop, name="launcher-heartbeat",
                daemon=True,
            )
            dep._hb_thread.start()
    return dep


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--supervise", action="store_true")
    args = p.parse_args()
    with open(args.config) as f:
        config = json.load(f)
    dep = launch(config, supervise=args.supervise)
    print(json.dumps(dep.manifest()), flush=True)

    def on_term(_sig, _frm):
        dep.stop()
        sys.exit(0)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    threading.Event().wait()


if __name__ == "__main__":
    main()
