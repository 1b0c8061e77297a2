"""The port's own copy of ``fluidframework_tpu/protocol/channel.py`` (no JAX in it).

The channel plugin boundary: the ONLY coupling between a DDS and the rest.

Reference parity: datastore-definitions/src/channel.ts — ``IDeltaHandler``
(:140, processMessages/reSubmit/applyStashedOp/rollback), ``IDeltaConnection``
(:203, submit + dirty), ``IChannelFactory`` (:294, create/load), and
runtime-definitions ``IRuntimeMessageCollection`` (bunched messages sharing
one sequenced envelope). This boundary is what lets the device kernel backend
swap in behind any DDS type without the runtime knowing.

Layering: this contract lives in ``protocol`` (base layer) exactly like the
reference keeps datastore-definitions in its contracts tier — both the dds
layer and the runtime layer import it DOWNWARD (fftpu-check layer-check
enforces this; it used to live in ``runtime`` and made every DDS module an
upward importer).  ``runtime.channel`` remains as a re-export shim.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Protocol


@dataclass
class MessageEnvelope:
    """Sequencing info shared by every message in a bunch."""

    client_id: str
    seq: int
    min_seq: int
    ref_seq: int


@dataclass
class ChannelMessage:
    """One op within a bunch (ref IRuntimeMessagesContent)."""

    contents: Any
    local: bool
    local_metadata: Any = None


@dataclass
class MessageCollection:
    """A bunch of contiguous same-channel messages (ref IRuntimeMessageCollection).

    The container runtime bunches contiguous inbound messages addressed to
    the same channel into one collection — the seam the device backend widens
    into a single batched kernel launch (containerRuntime.ts:3428-3462).
    """

    envelope: MessageEnvelope
    messages: list[ChannelMessage]


def bunch_contiguous(pairs, dispatch) -> None:
    """Group a stream of (key, item) pairs into maximal contiguous same-key
    runs and dispatch each run once — the message-bunching seam used at both
    the container→datastore and datastore→channel hops
    (containerRuntime.ts:3428-3462)."""
    run: list = []
    run_key = None
    for key, item in pairs:
        if key != run_key:
            if run:
                dispatch(run_key, run)
            run, run_key = [], key
        run.append(item)
    if run:
        dispatch(run_key, run)


class ChannelDeltaConnection:
    """The channel's handle for submitting ops upward (ref IDeltaConnection).

    ``submit`` stages contents + local metadata into the container outbox;
    the metadata round-trips back to the channel when its own op is
    sequenced (via PendingStateManager zip) or on resubmit.
    """

    def __init__(
        self,
        submit_fn: Callable[..., None],
        quorum_fn: Callable[[str], int],
        client_id_fn: Callable[[], str],
        members_fn: Callable[[], list[str]] | None = None,
        ref_seq_fn: Callable[[], int] | None = None,
    ) -> None:
        self._submit = submit_fn
        self._quorum = quorum_fn
        self._client_id = client_id_fn
        self._members = members_fn or (lambda: [])
        self._ref_seq = ref_seq_fn or (lambda: 0)
        self.connected = False

    def submit(self, contents: Any, local_metadata: Any = None, internal: bool = False) -> None:
        """``internal=True`` marks protocol-internal ops a DDS mints while
        PROCESSING inbound messages (e.g. PactMap accept signoffs) — exempt
        from the reentrancy guard that blocks user edits in that window."""
        self._submit(contents, local_metadata, internal)

    def ref_seq(self) -> int:
        """Last sequence number the hosting container has processed."""
        return self._ref_seq()

    def short_id(self, client_id: str) -> int:
        """Numeric join-order id for a client (the quorum table lookup)."""
        return self._quorum(client_id)

    def client_id(self) -> str:
        """The hosting container's current connection identity."""
        return self._client_id()

    def quorum_members(self) -> list[str]:
        """Currently joined client ids, in join order (consensus DDSes use
        this as the signoff set at proposal-sequencing time)."""
        return self._members()


class Channel(ABC):
    """A DDS instance as seen by the runtime (ref IChannel + IDeltaHandler).

    Concrete DDSes subclass this; they must not assume anything about the
    transport beyond this contract.
    """

    channel_type: str = ""

    def __init__(self, channel_id: str) -> None:
        self.id = channel_id
        self._connection: ChannelDeltaConnection | None = None

    # ------------------------------------------------------------- lifecycle
    def connect(self, connection: ChannelDeltaConnection) -> None:
        self._connection = connection

    @property
    def is_attached(self) -> bool:
        return self._connection is not None

    def submit_local_message(
        self, contents: Any, local_metadata: Any = None, internal: bool = False
    ) -> None:
        if self._connection is None:
            raise RuntimeError(f"channel {self.id!r} is not attached")
        self._connection.submit(contents, local_metadata, internal)

    # --------------------------------------------------------------- inbound
    @abstractmethod
    def process_messages(self, collection: MessageCollection) -> None:
        """Apply a bunch of sequenced messages (local ones are acks)."""

    # ---------------------------------------------------- reconnect / stash
    @abstractmethod
    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        """Re-mint one pending op for a new connection (ref reSubmitCore).

        The channel must re-stage (possibly rewritten) contents through its
        connection; positions/conflict data may need rebasing onto state
        that advanced while disconnected.
        """

    def apply_stashed(self, contents: Any) -> Any:
        """Apply a stashed (previously pending, never sequenced) op locally,
        as if just minted but NOT submitted; returns the local metadata the
        pending-state replay will resubmit with (ref applyStashedOp,
        sharedObject.ts:693)."""
        raise NotImplementedError(f"{self.channel_type}: stashed ops unsupported")

    def on_min_seq(self, min_seq: int) -> None:
        """Collab-window floor advanced (drives compaction). Default no-op."""

    def on_client_leave(self, client_id: str, seq: int) -> None:
        """A client's leave was sequenced at ``seq``. Consensus DDSes (task
        queues, ordered collections) release that client's holdings here
        (ref quorum removeMember listeners). Default no-op."""

    def rollback(self, contents: Any, local_metadata: Any) -> None:
        """Undo one not-yet-flushed local op (ref IDeltaHandler.rollback)."""
        raise NotImplementedError(f"{self.channel_type}: rollback unsupported")

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        """Emit a JSON-compatible snapshot of sequenced state (ref
        SharedObject.summarize). Pending local state is NOT included —
        that travels via the pending-state stash."""
        raise NotImplementedError(f"{self.channel_type}: summarize unsupported")

    def load(self, summary: dict[str, Any]) -> None:
        """Initialize from a summary produced by ``summarize``."""
        raise NotImplementedError(f"{self.channel_type}: load unsupported")


class ChannelFactory(Protocol):
    """Type-string -> channel constructor (ref IChannelFactory, channel.ts:294)."""

    channel_type: str

    def create(self, channel_id: str) -> Channel: ...
