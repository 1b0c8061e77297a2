"""Audience: every client connected to the op stream, read connections

A port of ``fluidframework_tpu/loader/audience.py`` (no JAX in it).

included.

Reference parity: container-loader/src/audience.ts.
The quorum only ever holds WRITE clients (a read connection never produces a
sequenced join); the Audience is the loader's full-membership surface:

- write members arrive/depart with sequenced join/leave messages;
- read members arrive/depart with the service's clientJoin/clientLeave
  system signals (nexus broadcasts them; the connect handshake's
  initialClients primes late subscribers) — signal delivery is unreliable,
  so duplicate adds with identical payloads are tolerated silently
  (audience.ts:56);
- ``get_self`` names this connection's own membership
  (audience.ts getSelf/setCurrentClientId — the member record may lag the
  id when the audience hasn't caught up yet).
"""

from __future__ import annotations

from typing import Any, Callable


class Audience:
    """clientId -> member details ({"mode": "read"|"write", ...})."""

    def __init__(self) -> None:
        self._members: dict[str, dict[str, Any]] = {}
        self._current_client_id: str | None = None
        self._add_listeners: list[Callable[[str, dict], None]] = []
        self._remove_listeners: list[Callable[[str, dict], None]] = []
        self._self_listeners: list[Callable[[str | None, str], None]] = []

    # ------------------------------------------------------------ membership
    def add_member(self, client_id: str, details: dict[str, Any]) -> None:
        """Add a client (audience.ts addMember:52).  A duplicate add must
        carry the identical payload (signal redelivery), never a different
        one (that would be two clients under one id)."""
        existing = self._members.get(client_id)
        if existing is not None:
            if existing != details:
                raise AssertionError(
                    f"audience member {client_id!r} re-added with different "
                    f"payload (ref assert 0x4b2): {existing} != {details}"
                )
            return
        self._members[client_id] = details
        for fn in list(self._add_listeners):
            fn(client_id, details)

    def remove_member(self, client_id: str) -> bool:
        """Remove a client; returns whether it was present
        (audience.ts removeMember:71)."""
        details = self._members.pop(client_id, None)
        if details is None:
            return False
        for fn in list(self._remove_listeners):
            fn(client_id, details)
        return True

    def get_members(self) -> dict[str, dict[str, Any]]:
        return dict(self._members)

    def get_member(self, client_id: str) -> dict[str, Any] | None:
        return self._members.get(client_id)

    # ------------------------------------------------------------------ self
    def set_current_client_id(self, client_id: str) -> None:
        if self._current_client_id != client_id:
            old = self._current_client_id
            self._current_client_id = client_id
            for fn in list(self._self_listeners):
                fn(old, client_id)

    def get_self(self) -> dict[str, Any] | None:
        if self._current_client_id is None:
            return None
        return {
            "clientId": self._current_client_id,
            "client": self.get_member(self._current_client_id),
        }

    # ---------------------------------------------------------------- events
    def on_add_member(self, fn: Callable[[str, dict], None]) -> Callable[[], None]:
        self._add_listeners.append(fn)
        return lambda: self._add_listeners.remove(fn)

    def on_remove_member(self, fn: Callable[[str, dict], None]) -> Callable[[], None]:
        self._remove_listeners.append(fn)
        return lambda: self._remove_listeners.remove(fn)

    def on_self_changed(
        self, fn: Callable[[str | None, str], None]
    ) -> Callable[[], None]:
        self._self_listeners.append(fn)
        return lambda: self._self_listeners.remove(fn)
