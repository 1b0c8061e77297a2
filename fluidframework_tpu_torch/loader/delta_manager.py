"""DeltaManager: the ordered inbound pump with gap repair.

A port of ``fluidframework_tpu/loader/delta_manager.py`` (no JAX in it).

Reference parity: container-loader/src/deltaManager.ts (:154) — inbound ops
are delivered strictly in sequence order: duplicates (seq <= last processed)
are dropped, out-of-order arrivals are parked and the missing range is
fetched from delta storage (``fetchMissingDeltas`` :560); outbound ops ride
the current connection. The manager ALSO implements the document-adapter
contract the ContainerRuntime connects to (connect/disconnect/submit), so
the runtime is agnostic to whether it is wired straight to a LocalDocument
(unit tests) or through driver + loader (this path).

Handler chain: every in-order sequenced message flows to the protocol
handler first (quorum/proposals), then to the runtime subscriber.
"""

from __future__ import annotations

from typing import Any, Callable

from ..driver.definitions import DocumentService
from ..protocol.messages import Nack, SequencedMessage, SignalMessage
from .connection_manager import ConnectionManager
from .protocol import ProtocolHandler


class DeltaManager:
    def __init__(
        self,
        service: DocumentService,
        protocol: ProtocolHandler,
        base_client_id: str,
        last_processed_seq: int = 0,
    ) -> None:
        self._service = service
        self._storage = service.connect_to_delta_storage()
        self.protocol = protocol
        self.connection_manager = ConnectionManager(service, base_client_id)
        self.last_processed_seq = last_processed_seq
        self._runtime_handler: Callable[[SequencedMessage], None] | None = None
        self._signal_listeners: list[Callable[[SignalMessage], None]] = []
        self._parked: dict[int, SequencedMessage] = {}  # out-of-order arrivals
        self._paused = False
        self._pause_buffer: list[SequencedMessage] = []

    # ------------------------------------------------------- handler plumbing
    def on_signal(self, listener: Callable[[SignalMessage], None]) -> None:
        self._signal_listeners.append(listener)

    def _deliver(self, msg: SequencedMessage) -> None:
        """In-order delivery point: protocol first, then runtime."""
        self.last_processed_seq = msg.seq
        self.protocol.process_message(msg)
        if self._runtime_handler is not None:
            self._runtime_handler(msg)

    def _on_stream(self, msg: SequencedMessage) -> None:
        if self._paused:
            self._pause_buffer.append(msg)
            return
        self._process_inbound(msg)

    def _process_inbound(self, msg: SequencedMessage) -> None:
        if msg.seq <= self.last_processed_seq:
            return  # duplicate (reconnect overlap)
        if msg.seq > self.last_processed_seq + 1:
            # Gap: park this op, repair from delta storage (deltaManager.ts:560).
            self._parked[msg.seq] = msg
            self._fetch_missing(self.last_processed_seq + 1, msg.seq - 1)
        else:
            self._deliver(msg)
        # Drain any parked ops that are now contiguous.
        while self.last_processed_seq + 1 in self._parked:
            self._deliver(self._parked.pop(self.last_processed_seq + 1))

    # Zero-progress reads are retried: get_deltas is allowed to return fewer
    # ops than asked (a networked delta store can lag the broadcast stream
    # briefly), so only a persistently empty window is an unrepairable gap.
    GAP_FETCH_RETRIES = 8

    def _fetch_missing(self, from_seq: int, to_seq: int) -> None:
        stalls = 0
        while from_seq <= to_seq:
            got = self._storage.get_deltas(from_seq, to_seq)
            for m in got:
                if m.seq == self.last_processed_seq + 1:
                    self._deliver(m)
            if self.last_processed_seq + 1 == from_seq:
                stalls += 1
                if stalls >= self.GAP_FETCH_RETRIES:
                    raise RuntimeError(
                        f"delta storage cannot supply seq {from_seq} "
                        f"(requested [{from_seq}, {to_seq}]) after "
                        f"{stalls} attempts: unrepairable gap"
                    )
                continue
            stalls = 0
            from_seq = self.last_processed_seq + 1

    def _on_signal_msg(self, sig: SignalMessage) -> None:
        for listener in self._signal_listeners:
            listener(sig)

    # ----------------------------------------------------------- pause/resume
    def pause(self) -> None:
        """Hold inbound processing (ref DeltaQueue pause — used by the
        summarizer to snapshot at a stable seq)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False
        buffered, self._pause_buffer = self._pause_buffer, []
        for msg in buffered:
            self._process_inbound(msg)

    def process_slice(self, max_ops: int, max_seconds: float | None = None) -> int:
        """Process up to ``max_ops`` buffered inbound ops (and stop early
        when ``max_seconds`` of wall clock elapses) WITHOUT unpausing — the
        DeltaScheduler's time-slicing primitive (ref deltaScheduler.ts:25:
        inbound processing yields every 50 ms so the host stays responsive).
        Returns the number processed; pending remainder stays buffered."""
        import time as _time

        assert self._paused, "process_slice requires a paused delta manager"
        t0 = _time.perf_counter()
        n = 0
        while self._pause_buffer and n < max_ops:
            if max_seconds is not None and _time.perf_counter() - t0 >= max_seconds:
                break
            self._process_inbound(self._pause_buffer.pop(0))
            n += 1
        return n

    @property
    def inbound_backlog(self) -> int:
        return len(self._pause_buffer)

    # -------------------------------------------------------- nack backoff
    def wait_backoff(self, sleep: Callable[[float], None]) -> float:
        """Consume the connection manager's advisory reconnect delay (the
        jittered, retry_after-floored value the last nack produced) through
        the host-supplied clock; returns the delay waited.  Raises once the
        cumulative backoff crosses the manager's deadline — a host looping
        on this primitive cannot retry forever against a front that keeps
        shedding it (the admission contract's client half)."""
        cm = self.connection_manager
        if cm.backoff_exhausted:
            from ..driver.definitions import DriverError

            raise DriverError(
                f"reconnect backoff deadline exhausted after "
                f"{cm.backoff.spent_s:.1f}s of accumulated waiting",
                can_retry=False,
            )
        delay = cm.next_backoff_s
        if delay <= 0.0:
            delay = cm.backoff.next_delay(cm.last_retry_after_s)
        sleep(delay)
        cm.backoff.consume(delay)  # only time actually waited counts
        cm.next_backoff_s = 0.0
        return delay

    # ---------------------------------------- document adapter (runtime side)
    def connect(
        self,
        client_id: str,
        subscriber: Callable[[SequencedMessage], None],
        on_nack: Callable[[Nack], None] | None = None,
    ) -> SequencedMessage:
        """ContainerRuntime's document.connect: open a write connection,
        repair the snapshot→stream gap synchronously, return the join.

        ``client_id`` must be the ConnectionManager's ``next_client_id()``
        (the Container hands it down)."""
        assert client_id == self.connection_manager.next_client_id()
        self._runtime_handler = subscriber
        conn = self.connection_manager.open(
            self._on_stream, on_nack, self._on_signal_msg, mode="write"
        )
        self._catch_up(conn.checkpoint_seq)
        self.connection_manager.reset_backoff()
        return conn.join_msg

    def connect_read(self, subscriber: Callable[[SequencedMessage], None]) -> None:
        """Read-mode connect: stream + catch-up, no join, no submit."""
        self._runtime_handler = subscriber
        conn = self.connection_manager.open(
            self._on_stream, None, self._on_signal_msg, mode="read"
        )
        self._catch_up(conn.checkpoint_seq)

    def _catch_up(self, checkpoint_seq: int) -> None:
        if checkpoint_seq > self.last_processed_seq:
            self._fetch_missing(self.last_processed_seq + 1, checkpoint_seq)

    def disconnect(self, client_id: str) -> None:
        self.connection_manager.close()

    def submit(self, wire: Any) -> None:
        conn = self.connection_manager.connection
        if conn is None or not conn.connected:
            from ..driver.definitions import DriverError

            raise DriverError("submit while disconnected")
        conn.submit(wire)

    def submit_signal(self, content: Any) -> None:
        conn = self.connection_manager.connection
        if conn is None or not conn.connected:
            from ..driver.definitions import DriverError

            raise DriverError("signal while disconnected")
        conn.submit_signal(content)

    # Attachment blob passthroughs (the runtime's BlobManager talks to its
    # "document", which through the loader is this adapter; storage owns
    # blobs — ref blobManager uploads via the storage service).  One cached
    # storage service per document: per-call construction would re-mint the
    # storage token for every blob op.
    def _blob_storage(self):
        if not hasattr(self, "_blob_storage_svc"):
            self._blob_storage_svc = self._service.connect_to_storage()
        return self._blob_storage_svc

    def upload_blob(self, content: str) -> str:
        return self._blob_storage().upload_blob_content(content)

    def read_blob(self, blob_id: str) -> str:
        return self._blob_storage().read_blob_content(blob_id)

class DeltaScheduler:
    """Drives a paused DeltaManager in slices (ref DeltaScheduler's 50 ms
    budget, deltaScheduler.ts:25-33): call ``run_slice()`` from the host
    loop; processing yields control between slices so UI/host work
    interleaves with catch-up storms."""

    DEFAULT_BUDGET_S = 0.05  # the reference's 50 ms slice

    def __init__(self, dm: "DeltaManager", ops_per_slice: int = 100,
                 seconds_per_slice: float | None = DEFAULT_BUDGET_S) -> None:
        self._dm = dm
        self.ops_per_slice = ops_per_slice
        self.seconds_per_slice = seconds_per_slice
        dm.pause()

    def run_slice(self) -> int:
        return self._dm.process_slice(self.ops_per_slice, self.seconds_per_slice)

    def drain(self) -> int:
        n = 0
        while self._dm.inbound_backlog:
            n += self.run_slice()
        return n

    def stop(self) -> None:
        """Return the delta manager to immediate (unsliced) processing."""
        self._dm.resume()
