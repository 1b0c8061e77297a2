"""Presence: ephemeral per-session state over signals (never sequenced).

A port of ``fluidframework_tpu/framework/presence.py`` (no JAX in it).

Reference parity: packages/framework/presence* —
``PresenceDatastoreManagerImpl`` (presence-runtime/src/runtime/
presenceDatastoreManager.ts:195): per-client latest-value workspaces
broadcast via ``runtime.submitSignal`` (:343) with a batched outbound queue
(:473), and a join handshake: a newcomer broadcasts "join" and current
members respond with their state so the newcomer catches up (protocol.ts).
Presence data rides signals only — no ops, no sequence numbers, no summary
footprint.

The typed surface mirrors presence-definitions:
- ``states_workspace(id)`` -> workspace of value managers: ``latest``
  (one value per attendee, latestTypes.ts) and ``latest_map``
  (per-attendee keyed items, latestMapTypes.ts);
- ``notifications_workspace(id)`` -> named fire-and-forget notification
  emitters (notificationsTypes.ts — broadcast, never retained);
- attendee events (``on_attendee_joined``/``on_attendee_left``,
  presenceTypes.ts Attendee) derived from the same signal fabric.
"""

from __future__ import annotations

from typing import Any, Callable


def _subscribe(listeners: list, fn) -> Callable[[], None]:
    """Append + return an idempotent unsubscribe handle."""
    listeners.append(fn)

    def unsubscribe() -> None:
        if fn in listeners:
            listeners.remove(fn)

    return unsubscribe


class Presence:
    """One client's view of a presence workspace on a container."""

    def __init__(self, container, clock=None,
                 attendee_timeout_s: float = 30.0) -> None:
        import time

        self._container = container
        # One clock domain per instance (tests inject a simulated clock).
        self._clock = clock if clock is not None else time.monotonic
        self._client_id = container.runtime.client_id
        # state key -> client id -> (rev, value).  Revisions are per-key
        # per-writer monotonic stamps (ref datastore rev): a lost or
        # reordered signal can never let stale state clobber newer state —
        # receivers keep the highest rev (signal-loss recovery).
        self._remote: dict[str, dict[str, tuple[Any, Any]]] = {}
        self._local: dict[str, Any] = {}
        self._rev: dict[str, int] = {}  # our own per-key revision counters
        # Wire revisions are [epoch, n]: the epoch (instance birth stamp)
        # makes a RESTARTED client's fresh counters beat its own pre-crash
        # cached revs (a lost leave signal must not mute the comeback).
        self._epoch = time.time_ns()
        # Heartbeat cadence: refresh peers' last-seen view of us even when
        # idle, so expiry only ever fires on genuinely gone peers.
        self._last_heartbeat: float | None = None
        self._queue: dict[str, Any] = {}  # batched unflushed local sets
        # Tightest queued update's flush-by time (allowableUpdateLatency).
        self._flush_deadline: float | None = None
        self._listeners: list[Callable[[str, str, Any], None]] = []
        # Attendees: client ids seen on the presence fabric, with a
        # last-activity stamp; signal-silent attendees NOT covered by the
        # audience expire after ``attendee_timeout_s`` (ref attendee
        # disconnected-after-inactivity).
        self._attendees: set[str] = set()
        self._last_seen: dict[str, float] = {}
        self._attendee_timeout = attendee_timeout_s
        # Joiner catch-up responses pending our (ranked) jitter window
        # (ref presenceDatastoreManager.ts:195 joiningClients).
        self._pending_catchup: dict[str, float] = {}
        # joiner -> time we last saw a catch-up covering OUR state; a join
        # signal processed AFTER the primary's (synchronous fan-out
        # reentrancy) must not schedule a redundant backup.
        self._recent_catchup: dict[str, float] = {}
        self._joined_listeners: list[Callable[[str], None]] = []
        self._left_listeners: list[Callable[[str], None]] = []
        self._notification_listeners: dict[str, list] = {}
        container.on_signal(self._on_signal)
        # Sequenced LEAVE (crash/disconnect without a voluntary leave()
        # signal) also departs the fabric — the reference derives attendee
        # disconnect from the audience, not from a courtesy signal.
        self._unsub_member_left = _subscribe(
            container.runtime.member_left_listeners, self._drop_client
        )
        # Loader containers expose the full Audience (read members
        # included): attendee lifecycle keys off its membership events, so
        # read-only clients that never op still join/leave the fabric
        # (ref presence attendee status from audience removeMember).
        audience = getattr(container, "audience", None)
        self._unsub_audience: list[Callable[[], None]] = []
        if audience is not None:
            self._unsub_audience = [
                audience.on_add_member(self._on_audience_add),
                audience.on_remove_member(
                    lambda cid, _d: self._drop_client(cid)
                ),
            ]
        # Join handshake: ask current members for their state.
        container.submit_signal({"presence": "join"})

    def _on_audience_add(self, client_id: str, _details: dict) -> None:
        if client_id != self._my_id():
            self._saw(client_id)

    # ------------------------------------------------------------------ write
    def set(self, key: str, value: Any,
            allowed_latency_s: float | None = None,
            now: float | None = None) -> None:
        """Queue a local state update (batched; ref queued signal sends).

        ``allowed_latency_s`` is the reference's allowableUpdateLatency
        (presenceDatastoreManager.ts:473): the update may coalesce with
        later ones, but must be on the wire within that window — ``tick``
        flushes once the TIGHTEST queued deadline passes.  None = wait for
        an explicit flush (or a tighter co-queued update's deadline).
        ``now`` defaults to the presence CLOCK (constructor-injectable) so
        simulated and wall clocks never mix within one instance."""
        self._local[key] = value
        self._rev[key] = self._rev.get(key, 0) + 1
        self._queue[key] = value
        if allowed_latency_s is not None:
            now = self._clock() if now is None else now
            deadline = now + allowed_latency_s
            if self._flush_deadline is None or deadline < self._flush_deadline:
                self._flush_deadline = deadline

    def tick(self, now: float | None = None) -> bool:
        """Timer hook: flush lapsed latency windows, send due joiner
        catch-ups, emit idle heartbeats, expire signal-silent attendees;
        returns whether STATE went out (heartbeats are housekeeping and
        do not count)."""
        now = self._clock() if now is None else now
        sent = False
        if self._flush_deadline is not None and now >= self._flush_deadline:
            had_updates = bool(self._queue)
            self.flush()
            sent = sent or had_updates
        connected = getattr(self._container, "connected", True)
        for joiner, deadline in list(self._pending_catchup.items()):
            if now >= deadline and connected:
                del self._pending_catchup[joiner]
                self._send_catchup(joiner)
                sent = True
        # Idle keepalive: a silent-but-connected peer must keep refreshing
        # everyone's last-seen stamp or expiry would falsely fire on it.
        # Any outbound presence signal counts (flush/_send_catchup stamp
        # too), so actively-updating clients emit no redundant hb; a
        # DISCONNECTED client skips — submitting would raise, and peers
        # are supposed to see it go quiet.
        if self._attendee_timeout is not None and self._attendees and connected:
            interval = self._attendee_timeout / 3.0
            if (
                self._last_heartbeat is None
                or now - self._last_heartbeat >= interval
            ):
                self._last_heartbeat = now
                self._container.submit_signal({"presence": "hb"})
        self._expire_attendees(now)
        # Bounded bookkeeping: served-joiner stamps age out.
        for joiner, t in list(self._recent_catchup.items()):
            if now - t > 60.0:
                del self._recent_catchup[joiner]
        return sent

    def flush(self) -> None:
        """Broadcast queued updates as ONE signal (ref batch queue :473)."""
        self._flush_deadline = None
        if not self._queue:
            return
        updates, self._queue = self._queue, {}
        self._last_heartbeat = self._clock()  # state traffic IS a keepalive
        self._container.submit_signal({
            "presence": "update",
            "states": {k: [self._wire_rev(k), v] for k, v in updates.items()},
        })

    def _wire_rev(self, key: str) -> list:
        return [self._epoch, self._rev.get(key, 0)]

    @staticmethod
    def _rev_lt(a, b) -> bool:
        """rev a < rev b; wire revs are [epoch, n] lists."""
        return tuple(a) < tuple(b)

    def set_now(self, key: str, value: Any) -> None:
        self.set(key, value)
        self.flush()

    # ------------------------------------------------------------------- read
    def local(self, key: str) -> Any:
        return self._local.get(key)

    def states(self, key: str) -> dict[str, Any]:
        """client id -> latest value, including our own."""
        out = {c: v for c, (_r, v) in self._remote.get(key, {}).items()}
        if key in self._local:
            out[self._my_id()] = self._local[key]
        return out

    def remote_states(self, key: str) -> dict[str, Any]:
        return {c: v for c, (_r, v) in self._remote.get(key, {}).items()}

    def on_update(self, listener: Callable[[str, str, Any], None]) -> Callable[[], None]:
        """listener(client_id, key, value) per received remote update;
        returns an unsubscribe handle (repeated acquisition of value
        managers must not accumulate permanent listeners)."""
        return _subscribe(self._listeners, listener)

    def _my_id(self) -> str:
        return self._container.runtime.client_id or self._client_id or ""

    # -------------------------------------------------------------- attendees
    def attendees(self) -> set[str]:
        """Remote client ids currently on the presence fabric."""
        return set(self._attendees)

    def on_attendee_joined(self, fn: Callable[[str], None]) -> Callable[[], None]:
        return _subscribe(self._joined_listeners, fn)

    def on_attendee_left(self, fn: Callable[[str], None]) -> Callable[[], None]:
        return _subscribe(self._left_listeners, fn)

    def _saw(self, client_id: str) -> None:
        self._last_seen[client_id] = self._clock()
        if client_id not in self._attendees:
            self._attendees.add(client_id)
            for fn in list(self._joined_listeners):
                fn(client_id)

    def _expire_attendees(self, now: float) -> None:
        """Drop attendees silent beyond the timeout and not vouched for by
        the audience (signal-only peers whose leave signal was lost)."""
        if self._attendee_timeout is None:
            return
        audience = getattr(self._container, "audience", None)
        covered = set()
        if audience is not None:
            covered = set(audience.get_members())
        for cid in list(self._attendees):
            if cid in covered:
                continue
            if now - self._last_seen.get(cid, now) > self._attendee_timeout:
                self._drop_client(cid)

    # ------------------------------------------------------------- workspaces
    def states_workspace(self, workspace_id: str) -> "StatesWorkspace":
        """Typed value-manager workspace (ref StatesWorkspace)."""
        return StatesWorkspace(self, workspace_id)

    def notifications_workspace(self, workspace_id: str) -> "NotificationsWorkspace":
        """Fire-and-forget notification emitters (ref NotificationsWorkspace:
        broadcast only, never retained, no late-joiner catch-up)."""
        return NotificationsWorkspace(self, workspace_id)

    def _emit_notification(self, channel: str, name: str, payload: Any) -> None:
        self._container.submit_signal(
            {"presence": "notify", "ch": channel, "name": name, "payload": payload}
        )

    # ---------------------------------------------------------------- inbound
    def _on_signal(self, sig) -> None:
        content = sig.contents
        if not isinstance(content, dict) or "presence" not in content:
            return
        if sig.client_id == self._my_id():
            return
        kind = content["presence"]
        if kind != "leave":
            self._saw(sig.client_id)
        if kind == "join":
            # A newcomer asked for state (ref joiningClients catch-up,
            # presenceDatastoreManager.ts:195).  Every member knows the
            # whole datastore (own + cached remote state), so ONE response
            # suffices: members rank deterministically and the first
            # responds at once; the rest schedule a jittered backup
            # response, suppressed when an earlier responder's catch-up
            # already covered their state (thundering-herd avoidance).
            self.flush()
            rank = self._catchup_rank(sig.client_id)
            now = self._clock()
            if rank == 0:
                self._send_catchup(sig.client_id)
            elif now - self._recent_catchup.get(sig.client_id, -1e9) > 1.0:
                self._pending_catchup[sig.client_id] = now + 0.05 * rank
        elif kind == "update":
            self._merge_states(sig.client_id, content["states"])
        elif kind == "catchup":
            # Full-datastore relay: merge EVERY client's entries by rev —
            # this is also how members recover state their own lost
            # signals missed.
            for cid, states in content["data"].items():
                if cid == self._my_id():
                    continue
                self._saw(cid)
                self._merge_states(cid, states)
            joiner = content["for"]
            mine = content["data"].get(self._my_id())
            if mine is not None:
                # Our state was relayed to the joiner: stand down (and
                # remember, in case the join itself arrives after the
                # primary's response in the synchronous fan-out).  If the
                # relay was STALE — the responder missed some of our
                # updates — broadcast just the newer entries as a
                # correction, which also heals the responder.
                stale = {
                    k: [self._wire_rev(k), v]
                    for k, v in self._local.items()
                    if k not in mine
                    or self._rev_lt(mine[k][0], self._wire_rev(k))
                }
                if stale:
                    self._container.submit_signal(
                        {"presence": "update", "states": stale}
                    )
                self._pending_catchup.pop(joiner, None)
                self._recent_catchup[joiner] = self._clock()
        elif kind == "notify":
            for fn in list(self._notification_listeners.get(content["ch"], [])):
                fn(sig.client_id, content["name"], content["payload"])
        elif kind == "leave":
            self._drop_client(sig.client_id)

    def _merge_states(self, client_id: str, states: dict[str, Any]) -> None:
        """Merge one client's {key: [[epoch, n], value]} entries, highest
        rev wins (stale/reordered signals never regress state; a fresh
        epoch beats any pre-restart rev)."""
        for key, (rev, value) in states.items():
            slot = self._remote.setdefault(key, {})
            cur = slot.get(client_id)
            if cur is not None and not self._rev_lt(cur[0], rev):
                continue
            slot[client_id] = (rev, value)
            for listener in self._listeners:
                listener(client_id, key, value)

    def _catchup_rank(self, joiner: str) -> int:
        """Our deterministic position among the members able to answer a
        join (stable id sort): rank 0 answers immediately, the rest are
        jittered backups."""
        candidates = sorted(
            (self._attendees | {self._my_id()}) - {joiner}
        )
        return candidates.index(self._my_id())

    def _send_catchup(self, joiner: str) -> None:
        """Broadcast the full known datastore for a joiner."""
        data: dict[str, dict[str, Any]] = {}
        me = self._my_id()
        for key, value in self._local.items():
            data.setdefault(me, {})[key] = [self._wire_rev(key), value]
        # Stateless members (self included) still announce: the joiner
        # learns the whole attendee set from one response, and their
        # backup responses stand down.
        data.setdefault(me, {})
        for cid in self._attendees:
            if cid != joiner:
                data.setdefault(cid, {})
        for key, per_client in self._remote.items():
            for cid, (rev, value) in per_client.items():
                data.setdefault(cid, {})[key] = [rev, value]
        self._last_heartbeat = self._clock()
        self._container.submit_signal(
            {"presence": "catchup", "for": joiner, "data": data}
        )

    def _drop_client(self, client_id: str) -> None:
        for per_key in self._remote.values():
            per_key.pop(client_id, None)
        self._last_seen.pop(client_id, None)
        self._pending_catchup.pop(client_id, None)
        self._recent_catchup.pop(client_id, None)
        if client_id in self._attendees:
            self._attendees.discard(client_id)
            for fn in list(self._left_listeners):
                fn(client_id)

    def leave(self) -> None:
        """Announce departure (ref disconnect cleanup): peers drop our state."""
        self._container.submit_signal({"presence": "leave"})
        self._queue.clear()
        self._flush_deadline = None  # nothing left to flush: no phantom tick

    def dispose(self) -> None:
        """Detach from the runtime (unregisters the LEAVE listener) and drop
        local listeners — constructing Presence repeatedly on one container
        must not accumulate permanent registrations."""
        self._unsub_member_left()
        for unsub in self._unsub_audience:
            unsub()
        self._unsub_audience = []
        self._listeners.clear()
        self._joined_listeners.clear()
        self._left_listeners.clear()
        self._notification_listeners.clear()


# ---------------------------------------------------------------------------
# Typed workspaces (ref presence-definitions value managers)
# ---------------------------------------------------------------------------

def _esc(part: str) -> str:
    """Escape the ':' namespace separator inside user-chosen ids, so a
    Latest key containing ':' can never collide with a LatestMap item path
    (the same user-key-collision class the snapshot format stamp avoids)."""
    return part.replace("%", "%25").replace(":", "%3A")


def _unesc(part: str) -> str:
    return part.replace("%3A", ":").replace("%25", "%")


class Latest:
    """One value per attendee (ref LatestRaw, latestTypes.ts): ``local``
    get/set, per-attendee remote reads, update events."""

    def __init__(self, ws: "StatesWorkspace", key: str, initial: Any = None,
                 allowed_latency_s: float | None = None) -> None:
        self._p = ws._presence
        self._key = f"{_esc(ws.workspace_id)}:{_esc(key)}"
        # Per-manager allowableUpdateLatency (ref latestTypes.ts settings).
        self.allowed_latency_s = allowed_latency_s
        if initial is not None:
            self._p.set(self._key, initial, allowed_latency_s)

    @property
    def local(self) -> Any:
        return self._p.local(self._key)

    @local.setter
    def local(self, value: Any) -> None:
        self._p.set(self._key, value, self.allowed_latency_s)

    def get_remote(self, client_id: str) -> Any:
        return self._p.remote_states(self._key).get(client_id)

    def get_remotes(self) -> dict[str, Any]:
        return self._p.remote_states(self._key)

    def on_updated(self, fn: Callable[[str, Any], None]) -> Callable[[], None]:
        key = self._key

        def listener(client_id: str, k: str, value: Any) -> None:
            if k == key:
                fn(client_id, value)

        return self._p.on_update(listener)


class LatestMap:
    """Per-attendee keyed items (ref LatestMapRaw, latestMapTypes.ts):
    each attendee holds a map; items update independently."""

    def __init__(self, ws: "StatesWorkspace", key: str) -> None:
        self._p = ws._presence
        self._prefix = f"{_esc(ws.workspace_id)}:{_esc(key)}:"

    def set_item(self, item: str, value: Any) -> None:
        self._p.set(self._prefix + _esc(item), value)

    def local_item(self, item: str) -> Any:
        return self._p.local(self._prefix + _esc(item))

    def get_remote(self, client_id: str) -> dict[str, Any]:
        out = {}
        for full_key, per_client in self._p._remote.items():
            if full_key.startswith(self._prefix) and client_id in per_client:
                _rev, value = per_client[client_id]
                out[_unesc(full_key[len(self._prefix):])] = value
        return out

    def on_item_updated(self, fn: Callable[[str, str, Any], None]) -> Callable[[], None]:
        prefix = self._prefix

        def listener(client_id: str, k: str, value: Any) -> None:
            if k.startswith(prefix):
                fn(client_id, _unesc(k[len(prefix):]), value)

        return self._p.on_update(listener)


class StatesWorkspace:
    def __init__(self, presence: Presence, workspace_id: str) -> None:
        self._presence = presence
        self.workspace_id = workspace_id

    def latest(self, key: str, initial: Any = None,
               allowed_latency_s: float | None = None) -> Latest:
        return Latest(self, key, initial, allowed_latency_s)

    def latest_map(self, key: str) -> LatestMap:
        return LatestMap(self, key)

    def flush(self) -> None:
        self._presence.flush()


class NotificationsWorkspace:
    def __init__(self, presence: Presence, workspace_id: str) -> None:
        self._presence = presence
        self.workspace_id = workspace_id

    def emit(self, name: str, payload: Any = None) -> None:
        """Broadcast immediately; never queued, never retained."""
        self._presence._emit_notification(self.workspace_id, name, payload)

    def on_notification(self, fn: Callable[[str, str, Any], None]) -> Callable[[], None]:
        """fn(client_id, name, payload) per received notification;
        returns an unsubscribe handle."""
        return _subscribe(
            self._presence._notification_listeners.setdefault(self.workspace_id, []),
            fn,
        )
