"""Container: the loader-level lifecycle object tying all layers together.

A port of ``fluidframework_tpu/loader/container.py`` (no JAX in it).

Reference parity: container-loader/src/container.ts — ``Container.load``
(:324) = snapshot fetch → runtime boot → delta-stream connect → gap replay;
``createDetached`` (:382) + ``attach``; ``getPendingLocalState`` (:1152);
close semantics. The Container owns the ProtocolHandler (quorum/proposals),
the DeltaManager (ordered pump + gap repair) and the ContainerRuntime
(op application), and drives reconnect/escalation.

Layering note: the ContainerRuntime never sees the driver — it
talks to the DeltaManager through the same document-adapter contract the
unit tests use to wire it straight to a LocalDocument.
"""

from __future__ import annotations

from typing import Any, Callable

from ..driver.definitions import DocumentServiceFactory
from ..protocol.messages import MessageType, SignalMessage
from ..runtime.container_runtime import ContainerRuntime
from .audience import Audience
from .delta_manager import DeltaManager
from .protocol import ProtocolHandler


class Container:
    """One loaded collaborative document (ref IContainer)."""

    def __init__(self, runtime: ContainerRuntime, registry: dict[str, Any]) -> None:
        self.runtime = runtime
        self._registry = registry
        self.protocol: ProtocolHandler | None = None
        self.delta_manager: DeltaManager | None = None
        self._storage = None
        self._service = None
        self.attached = False
        self._stash: str | None = None
        self._mode = "write"
        # Cleanups run at close (e.g. a spawned hidden summarizer must
        # leave when its parent does, or it pins the MSN forever).
        self._close_hooks: list[Callable[[], None]] = []
        # Full connected-membership surface: write members from sequenced
        # joins/leaves, read members from the service's clientJoin/
        # clientLeave system signals (ref audience.ts).
        self.audience = Audience()

    def _wire_audience(self) -> None:
        self.protocol.on_member_change(
            lambda kind, cid: (
                self.audience.add_member(cid, {"mode": "write"})
                if kind == "join"
                else self.audience.remove_member(cid)
            )
        )
        self.delta_manager.on_signal(self._audience_signal)

    def _audience_signal(self, sig: SignalMessage) -> None:
        # Membership events come ONLY from the service identity (empty
        # sender — connects reject empty client ids, so app signals cannot
        # spoof audience membership or crash dispatch via the duplicate-add
        # assertion).
        if sig.client_id != "":
            return
        c = sig.contents
        if not isinstance(c, dict):
            return
        if c.get("type") == "clientJoin":
            self.audience.add_member(c["clientId"], dict(c["details"]))
        elif c.get("type") == "clientLeave":
            self.audience.remove_member(c["clientId"])

    # ------------------------------------------------------------------ load
    @staticmethod
    def load(
        doc_id: str,
        service_factory: DocumentServiceFactory,
        registry: dict[str, Any],
        client_id: str,
        stash: str | None = None,
        mode: str = "write",
        track_attribution: bool = False,
        _summarizer: bool = False,
    ) -> "Container":
        """Boot from the service: latest snapshot + trailing ops + live
        stream."""
        from ..runtime.summary import SUMMARIZER_SUFFIX

        if client_id.endswith(SUMMARIZER_SUFFIX) and not _summarizer:
            # The suffix IS the non-interactive marker every replica's
            # election trusts; an interactive client wearing it would be
            # silently unelectable (and a lone one would never summarize).
            raise ValueError(
                f"client id suffix {SUMMARIZER_SUFFIX!r} is reserved for "
                "spawned summarizer clients"
            )
        service = service_factory.create_document_service(doc_id)
        storage = service.connect_to_storage()
        # Like the reference's mixinAttributor, attribution tracking is a
        # runtime OPTION that must be configured uniformly across a
        # document's clients; snapshots carrying an attribution table also
        # enable it on loaders regardless of their own option.
        runtime = ContainerRuntime(
            registry, container_id=client_id,
            track_attribution=track_attribution,
        )
        protocol = ProtocolHandler()
        snap = storage.get_latest_snapshot()
        base_seq = 0
        if snap is not None:
            base_seq, summary = snap
            runtime.load_snapshot(summary["runtime"])
            protocol.load(summary["protocol"])
        c = Container(runtime, registry)
        c._service = service
        c._storage = storage
        c.protocol = protocol
        c.delta_manager = DeltaManager(
            service, protocol, base_client_id=client_id, last_processed_seq=base_seq
        )
        # Members already in the snapshot's quorum predate our hooks.
        for cid in protocol.quorum.members:
            c.audience.add_member(cid, {"mode": "write"})
        c._wire_audience()
        c.attached = True
        c._stash = stash
        c.connect(mode=mode)
        return c

    # ------------------------------------------------- detached create/attach
    @staticmethod
    def create_detached(
        registry: dict[str, Any],
        container_id: str = "detached",
        track_attribution: bool = False,
    ) -> "Container":
        """A container with no service: build structure + edit locally;
        everything parks as pending until attach (ref createDetached :382)."""
        return Container(
            ContainerRuntime(
                registry, container_id=container_id,
                track_attribution=track_attribution,
            ),
            registry,
        )

    def attach(
        self,
        doc_id: str,
        service_factory: DocumentServiceFactory,
        client_id: str,
    ) -> None:
        """Bind a detached container to a document: write a structure-only
        snapshot at seq 0 (the channel layout; detached content replays as
        trailing ops on join — the reference bakes detached state into the
        initial summary, an equivalent bootstrap), then connect."""
        if self.attached:
            raise RuntimeError("already attached")
        service = service_factory.create_document_service(doc_id)
        storage = service.connect_to_storage()
        if storage.get_latest_snapshot() is None:
            structure = {
                "runtime": {
                    "seq": 0,
                    "minSeq": 0,
                    "quorum": {},
                    "datastores": {
                        ds_id: ds.structure_summary()
                        for ds_id, ds in self.runtime.datastores.items()
                    },
                },
                "protocol": ProtocolHandler().summarize(),
            }
            storage.write_snapshot(0, structure)
        self._service = service
        self._storage = storage
        self.protocol = ProtocolHandler()
        self.delta_manager = DeltaManager(
            service, self.protocol, base_client_id=client_id, last_processed_seq=0
        )
        self._wire_audience()
        self.attached = True
        self.connect()

    # ------------------------------------------------------------- connection
    def connect(self, mode: str | None = None) -> None:
        """(Re)open a connection in ``mode`` — defaults to the container's
        current mode, so reconnect never silently escalates read→write."""
        if not self.attached:
            raise RuntimeError("connect before attach")
        mode = self._mode if mode is None else mode
        self._mode = mode
        self.audience.set_current_client_id(
            self.delta_manager.connection_manager.next_client_id()
        )
        if mode == "write":
            stash, self._stash = self._stash, None
            self.runtime.connect(
                self.delta_manager,
                self.delta_manager.connection_manager.next_client_id(),
                stash=stash,
            )
        else:
            self.delta_manager.connect_read(self.runtime.process_sequenced)

    def disconnect(self) -> None:
        if self.runtime.has_document:
            self.runtime.disconnect()
        else:
            self.delta_manager.connection_manager.close()

    def reconnect(self) -> None:
        """New connection epoch; pending ops resubmit after the new join
        sequences."""
        self.disconnect()
        self.connect()

    def reconnect_with_backoff(
        self,
        sleep: Callable[[float], None] | None = None,
        max_attempts: int = 16,
    ) -> int:
        """Reconnect honoring the nack/backoff contract: wait the advisory
        jittered delay (floored at the server's ``retryAfter``) before each
        attempt, retry transient failures, and give up when the connection
        manager's cumulative-backoff deadline is exhausted.  Pending local
        ops replay on the successful rejoin (the existing reconnect
        machinery).  Returns the attempts taken; ``sleep`` is injectable so
        deterministic harnesses can virtualize the clock."""
        import time as _time

        from ..driver.definitions import DriverError

        sleep = _time.sleep if sleep is None else sleep
        self.disconnect()
        last: Exception | None = None
        for attempt in range(1, max_attempts + 1):
            self.delta_manager.wait_backoff(sleep)  # raises once exhausted
            try:
                self.connect()
                return attempt
            except (DriverError, OSError) as e:
                if isinstance(e, DriverError) and not e.can_retry:
                    # Fatal rejection (auth, protocol): no amount of
                    # waiting readmits this client.
                    raise
                # The next iteration's wait_backoff computes an escalated
                # delay itself (next_backoff_s is consumed/zeroed).
                last = e
        raise DriverError(
            f"reconnect failed after {max_attempts} attempts: {last}",
            can_retry=False,
        )

    def escalate_to_write(self) -> None:
        """read → write escalation (ref connectionManager read/write modes):
        reconnect in write mode; parked local edits replay on join."""
        self.delta_manager.connection_manager.close()
        self.connect(mode="write")

    @property
    def connected(self) -> bool:
        return (
            self.delta_manager is not None
            and self.delta_manager.connection_manager.connected
        )

    @property
    def joined(self) -> bool:
        return self.runtime.joined

    def close(self, error: Exception | None = None) -> None:
        for hook in list(self._close_hooks):
            hook()
        self._close_hooks.clear()
        if self.delta_manager is not None:
            self.delta_manager.connection_manager.close()
        self.runtime.close(error)

    # --------------------------------------------------------------- proposals
    def propose(self, key: str, value: Any) -> None:
        """Quorum proposal; accepted (on every replica) once the MSN passes
        its sequence number (ref quorum.ts propose)."""
        self.runtime.submit_protocol_message(
            MessageType.PROPOSE, {"key": key, "value": value}
        )

    # ---------------------------------------------------------------- signals
    def submit_signal(self, content: Any) -> None:
        self.delta_manager.submit_signal(content)

    def on_signal(self, listener: Callable[[SignalMessage], None]) -> None:
        self.delta_manager.on_signal(listener)

    # ------------------------------------------------------------- checkpoint
    def summarize_to_storage(self) -> int:
        """Write a full snapshot at the current seq (client-driven summary;
        the election/heuristics live in runtime/summary.py). Requires no
        local pending ops — the reference's summarizer is a dedicated client
        with none, so acked state == full state."""
        if self.runtime.pending_op_count:
            raise RuntimeError("cannot summarize with pending local ops")
        seq = self.runtime.ref_seq
        self._storage.write_snapshot(
            seq,
            {"runtime": self.runtime.summarize(), "protocol": self.protocol.summarize()},
        )
        return seq

    def make_summary_manager(self, config=None):
        """Wire a SummaryManager (election + heuristics + incremental
        summary upload) for this container (ref SummaryManager spawn,
        summaryManager.ts:95)."""
        from ..runtime.summary import SummaryManager

        return SummaryManager(
            self.runtime,
            self._storage,
            config=config,
            protocol_summarize=self.protocol.summarize,
        )

    def make_hidden_summarizer(self, doc_id: str, service_factory, config=None):
        """Summarize through a spawned hidden client while this interactive
        client holds the election (ref summaryManager.ts:95 +
        summarizer.ts:89 — the summarizer is its own non-interactive
        container, so interactive pending edits never block a summary)."""
        from ..runtime.summary import HiddenSummaryManager

        hs = HiddenSummaryManager(
            self, doc_id, service_factory, self._registry, config=config
        )
        self._close_hooks.append(hs.stop)
        return hs

    # ------------------------------------------------------------------ stash
    def get_pending_local_state(self) -> str:
        if self._stash is not None:
            # A stash held through a read-mode session was never applied
            # (only a write connection replays it): hand back the original
            # rather than the runtime's empty pending set, so offline edits
            # survive a read-only load/save cycle.
            return self._stash
        return self.runtime.get_pending_local_state()
