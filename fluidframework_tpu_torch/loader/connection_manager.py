"""Connection state machine: open/close, identity epochs, backoff, modes.

A port of ``fluidframework_tpu/loader/connection_manager.py`` (no JAX in it).

Reference parity: container-loader/src/connectionManager.ts (:140) — each
(re)connection is a fresh identity (the reference's server assigns a new
clientId per socket; here the manager derives ``base~epochN``), reconnects
apply exponential backoff (tracked as a delay value — the host owns the
clock), and connections are "read" or "write": read connections never join
the quorum and cannot submit (read→write escalation reconnects in write
mode, connectionManager.ts read/write escalation).

Backoff policy (the flow-control contract): delays are exponential
with FULL JITTER — uniform in ``(0, min(cap, initial * 2^attempt)]`` — so a
nack storm (the front shedding under overload) does not resynchronize every
backed-off client into a thundering herd at the same retry instant.  A
server-supplied ``retry_after`` (the admission nack's load-derived hint) is
honored as a FLOOR under the jittered delay, never shortened.  Cumulative
consumed backoff is tracked against a deadline: a host that keeps retrying
past ``backoff_deadline_s`` of accumulated waiting gets ``exhausted`` and
should surface the failure instead of spinning forever.
"""

from __future__ import annotations

import random
from typing import Any, Callable

from ..driver.definitions import DeltaConnection, DocumentService
from ..protocol.messages import Nack, SequencedMessage, SignalMessage


class BackoffPolicy:
    """Jittered exponential backoff with a retry_after floor + deadline.

    Shared by the ConnectionManager (reconnect delays) and the chaos/soak
    clients (in-connection resubmit delays).  ``rng`` is injectable so
    seeded harnesses stay deterministic; the host owns the clock — this
    class only COMPUTES delays (``next_delay``) and accounts the consumed
    total against the deadline."""

    INITIAL_S = 0.5
    MAX_S = 8.0

    def __init__(
        self,
        rng: random.Random | None = None,
        initial_s: float = INITIAL_S,
        max_s: float = MAX_S,
        deadline_s: float = 60.0,
    ) -> None:
        self._rng = rng if rng is not None else random.Random()
        self.initial_s = initial_s
        self.max_s = max_s
        self.deadline_s = deadline_s
        self.attempts = 0
        self.spent_s = 0.0

    def next_delay(self, retry_after: float = 0.0) -> float:
        """The next advisory delay: full-jitter exponential, floored at the
        server's ``retry_after`` hint.  Computing a delay escalates the
        ladder but does NOT consume deadline — only time actually waited
        counts (``consume``): a burst of shed submits produces one nack
        per op, and a client that never slept must not arrive at its
        reconnect with the deadline already burned."""
        cap = min(self.max_s, self.initial_s * (2.0 ** self.attempts))
        self.attempts += 1
        # 1 ms floor: a zero delay would defeat the jitter's decorrelation
        # (and hosts assert the advisory delay is nonzero after a nack).
        return max(retry_after, self._rng.uniform(0.0, cap), 1e-3)

    def consume(self, waited_s: float) -> None:
        """Account time ACTUALLY waited against the deadline."""
        self.spent_s += waited_s

    @property
    def exhausted(self) -> bool:
        """True once the accumulated waiting crossed the deadline: the host
        should fail the operation rather than keep retrying."""
        return self.spent_s > self.deadline_s

    def reset(self) -> None:
        """Successful (re)admission: the next failure starts fresh."""
        self.attempts = 0
        self.spent_s = 0.0


class ConnectionManager:
    INITIAL_BACKOFF_S = BackoffPolicy.INITIAL_S
    MAX_BACKOFF_S = BackoffPolicy.MAX_S

    def __init__(
        self,
        service: DocumentService,
        base_client_id: str,
        backoff_rng: random.Random | None = None,
        backoff_deadline_s: float = 60.0,
    ) -> None:
        self._service = service
        self._base = base_client_id
        self._epoch = 0
        self.connection: DeltaConnection | None = None
        self.connect_count = 0
        self.next_backoff_s = 0.0  # advisory delay before the next attempt
        self.backoff = BackoffPolicy(
            rng=backoff_rng, deadline_s=backoff_deadline_s
        )
        # The last nack's server-supplied hint, kept so a host computing its
        # own schedule still sees the floor the front asked for.
        self.last_retry_after_s = 0.0

    # --------------------------------------------------------------- identity
    def next_client_id(self) -> str:
        """The identity the NEXT connection will use (stable until open)."""
        return self._base if self._epoch == 0 else f"{self._base}~r{self._epoch}"

    @property
    def client_id(self) -> str | None:
        return self.connection.client_id if self.connection else None

    @property
    def connected(self) -> bool:
        return self.connection is not None and self.connection.connected

    @property
    def mode(self) -> str | None:
        return self.connection.mode if self.connection else None

    # ------------------------------------------------------------------ open
    def open(
        self,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
    ) -> DeltaConnection:
        if self.connected:
            raise RuntimeError("already connected")
        client_id = self.next_client_id()
        self._epoch += 1

        def on_nack(nack: Nack) -> None:
            # The connection already tore itself down; escalate backoff so
            # the next attempt is delayed (ref reconnect-on-nack with delay;
            # retry_after from the server is a floor, never a shortcut).
            self._bump_backoff(nack.retry_after)
            if nack_listener is not None:
                nack_listener(nack)

        conn = self._service.connect_to_delta_stream(
            client_id, listener, on_nack, signal_listener, mode=mode
        )
        self.connection = conn
        self.connect_count += 1
        return conn

    def close(self) -> None:
        if self.connection is not None:
            self.connection.disconnect()
            self.connection = None

    def reset_backoff(self) -> None:
        self.next_backoff_s = 0.0
        self.last_retry_after_s = 0.0
        self.backoff.reset()

    @property
    def backoff_exhausted(self) -> bool:
        """Cumulative advisory delays crossed the deadline: the host should
        surface a connection failure instead of retrying further."""
        return self.backoff.exhausted

    def _bump_backoff(self, retry_after: float = 0.0) -> None:
        self.last_retry_after_s = max(self.last_retry_after_s, retry_after)
        self.next_backoff_s = self.backoff.next_delay(retry_after)
