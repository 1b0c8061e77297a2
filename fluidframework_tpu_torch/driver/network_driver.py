"""Network driver: the driver contracts over TCP + HTTP fronts.

A port of ``fluidframework_tpu/driver/network_driver.py`` (no JAX in it).

Reference parity: routerlicious-driver — ``DocumentService`` backed by a
real service: the delta stream over the nexus socket protocol
(driver-base/src/documentDeltaConnection.ts socket.io analog, here JSON
lines over TCP), delta ranges and snapshots over the alfred/historian REST
front (documentStorageService/deltaStorageService).

Threading model: a reader thread drains the socket into a queue; message
DISPATCH happens on the host's thread via ``pump()`` (or the blocking
``sync()``, which drains until the server echoes a marker — deterministic
quiescence without sleeps).  This mirrors the reference's inbound
DeltaQueue: the wire is asynchronous, processing is single-threaded.
"""

from __future__ import annotations

import http.client
import json
import queue
import socket
import threading
from typing import Any, Callable

from ..protocol.messages import Nack, SequencedMessage, SignalMessage, UnsequencedMessage
from .definitions import (
    DeltaConnection,
    DeltaStorageService,
    DocumentService,
    DocumentServiceFactory,
    DriverError,
    StorageService,
)


def _seq_from_dict(d: dict) -> SequencedMessage:
    return SequencedMessage.from_json(json.dumps(d))


class NetworkDeltaConnection(DeltaConnection):
    """One TCP delta-stream connection (ref DocumentDeltaConnection)."""

    def __init__(
        self,
        host: str,
        port: int,
        doc_id: str,
        client_id: str,
        mode: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None,
        signal_listener: Callable[[SignalMessage], None] | None,
        token: str | None = None,
        boot_listener: Callable[[], None] | None = None,
        interests: list | None = None,
    ) -> None:
        self.client_id = client_id
        self.mode = mode
        self._listener = listener
        self._nack_listener = nack_listener
        self._signal_listener = signal_listener
        self._boot_listener = boot_listener
        self.boot_resyncs = 0
        self._inbound: queue.Queue = queue.Queue()
        self._connected = False
        self._sync_counter = 0

        self._sock = socket.create_connection((host, port), timeout=30)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._wlock = threading.Lock()
        try:
            connect_req = {
                "t": "connect",
                "doc": doc_id,
                "client": client_id,
                "mode": mode,
                "token": token,
                "signals": signal_listener is not None,
            }
            if interests is not None:
                # Scoped presence workspace: only signals whose scope key
                # is in this list (plus unscoped signals) are delivered.
                connect_req["interests"] = list(interests)
            self._send(connect_req)
            # Handshake: block for the joined ack.  Broadcasts for this
            # socket can land BEFORE it (e.g. our own audience clientJoin
            # signal fans out during connect) — buffer them for dispatch
            # after the handshake, the reference driver-base
            # earlyOpHandler pattern (documentDeltaConnection.ts:54).
            while True:
                line = self._rfile.readline()
                if not line:
                    raise DriverError("connection closed during handshake")
                ack = json.loads(line)
                if ack.get("t") == "error":
                    raise DriverError(
                        f"connection rejected: {ack.get('reason')}",
                        can_retry=bool(ack.get("canRetry", False)),
                    )
                if ack.get("t") == "joined":
                    break
                self._inbound.put(ack)  # early broadcast: deliver post-join
            self.join_msg = _seq_from_dict(ack["join"]) if ack.get("join") else None
            self.checkpoint_seq = ack["deliveredSeq"]
        except BaseException:
            # A failed handshake must not leak the socket (reconnect loops
            # would exhaust fds).
            self._rfile.close()
            self._sock.close()
            raise
        self._connected = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # ----------------------------------------------------------------- wire
    def _send(self, obj: dict) -> None:
        data = (json.dumps(obj) + "\n").encode()
        with self._wlock:
            self._sock.sendall(data)

    def _read_loop(self) -> None:
        try:
            for raw in self._rfile:
                line = raw.strip()
                if line:
                    self._inbound.put(json.loads(line))
        except (OSError, ValueError):
            pass
        self._inbound.put({"t": "__eof__"})

    # ------------------------------------------------------------- dispatch
    def pump(self, block_s: float | None = None) -> int:
        """Dispatch buffered inbound messages on the CALLER's thread;
        returns the number dispatched."""
        n = 0
        while True:
            try:
                item = self._inbound.get(timeout=block_s) if block_s else self._inbound.get_nowait()
            except queue.Empty:
                return n
            block_s = None  # only the first get blocks
            if self._dispatch(item):
                n += 1

    def _dispatch(self, item: dict) -> bool:
        kind = item.get("t")
        if kind == "op":
            self._listener(_seq_from_dict(item["msg"]))
            return True
        if kind == "nack":
            # A protocol nack invalidates the connection (ref: server
            # closes the socket; client reconnects).  An ADMISSION nack
            # (canRetry, retryAfter set) sheds the op BEFORE the sequencer
            # saw it: the connection and the client's clientSeq stream are
            # both still valid — keep the socket, hand the nack up, and
            # let the sender back off retryAfter and resubmit in place.
            if not item.get("canRetry", False):
                self.disconnect()
            if self._nack_listener is not None:
                self._nack_listener(
                    Nack(
                        client_id=item["clientId"],
                        client_seq=item["clientSeq"],
                        reason=item["reason"],
                        retry_after=item.get("retryAfter", 0.0),
                    )
                )
            return True
        if kind == "signal":
            if self._signal_listener is not None:
                self._signal_listener(
                    SignalMessage(client_id=item["clientId"], contents=item["contents"])
                )
            return True
        if kind == "resync":
            # Fan-out plane drop-to-catch-up: ``boot: true`` means this
            # connection's missed range left the retained log — the host
            # must re-seed from the historian snapshot tier and reconnect
            # (the FleetConsumer implements the full fetch-adopt-resume
            # loop; container hosts register ``boot_listener`` to reload
            # through their storage service).
            if item.get("boot"):
                self.boot_resyncs += 1
                if self._boot_listener is not None:
                    self._boot_listener()
            return False
        if kind == "sync":
            self._sync_seen = item.get("n")
            return False
        if kind == "__eof__":
            self._connected = False
            return False
        return False

    def sync(self, timeout_s: float = 10.0) -> int:
        """Round-trip a marker through the server: every message the server
        broadcast to this socket BEFORE the echo is dispatched when this
        returns.  The deterministic quiescence primitive for tests and
        batch-mode hosts."""
        if not self._connected:
            return self.pump()
        self._sync_counter += 1
        want = self._sync_counter
        self._sync_seen = None
        self._send({"t": "sync", "n": want})
        dispatched = 0
        while self._sync_seen != want:
            try:
                item = self._inbound.get(timeout=timeout_s)
            except queue.Empty:
                raise DriverError(f"sync {want} timed out after {timeout_s}s")
            if self._dispatch(item):
                dispatched += 1
            if not self._connected:
                break
        return dispatched

    # ---------------------------------------------------------------- sends
    def submit(self, message: Any) -> None:
        if not self._connected:
            raise DriverError("submit on disconnected connection")
        if self.mode != "write":
            raise DriverError("read connection cannot submit ops", can_retry=False)
        assert isinstance(message, UnsequencedMessage)
        self._send({"t": "submit", "msg": json.loads(message.to_json())})

    def submit_signal(self, content: Any) -> None:
        if not self._connected:
            raise DriverError("signal on disconnected connection")
        self._send({"t": "signal", "content": content})

    def disconnect(self) -> None:
        if self._connected:
            self._connected = False
            try:
                self._send({"t": "disconnect"})
            except OSError:
                pass
            # Wait for the server-side EOF: the handler ticket-and-broadcasts
            # our leave BEFORE closing the socket, so once the reader thread
            # exits, the leave is ordered ahead of any later sync marker.
            self._reader.join(timeout=5.0)
            try:
                self._sock.close()
            except OSError:
                pass

    @property
    def connected(self) -> bool:
        return self._connected


class _Http:
    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port

    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        token: str | None = None,
    ) -> tuple[int, dict]:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            payload = json.dumps(body) if body is not None else None
            headers = {"Content-Type": "application/json"} if payload else {}
            if token:
                headers["Authorization"] = f"Bearer {token}"
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()


# Storage reads authenticate under this pseudo-client identity (the token
# provider signs for it; the server validates the same scope).
STORAGE_CLIENT = "__storage__"


class HttpDeltaStorageService(DeltaStorageService):
    def __init__(self, http: _Http, doc_id: str, token: str | None = None) -> None:
        self._http = http
        self._doc = doc_id
        self._token = token

    def get_deltas(self, from_seq: int, to_seq: int) -> list[SequencedMessage]:
        status, body = self._http.request(
            "GET", f"/doc/{self._doc}/deltas?from={from_seq}&to={to_seq}",
            token=self._token,
        )
        if status != 200:
            raise DriverError(f"delta read failed: {body}")
        return [_seq_from_dict(d) for d in body["ops"]]


class HttpStorageService(StorageService):
    def __init__(self, http: _Http, doc_id: str, token: str | None = None) -> None:
        self._http = http
        self._doc = doc_id
        self._token = token

    def get_latest_snapshot(self) -> tuple[int, dict] | None:
        status, body = self._http.request(
            "GET", f"/doc/{self._doc}/snapshot", token=self._token
        )
        if status == 404:
            return None
        if status != 200:
            raise DriverError(f"snapshot read failed: {body}")
        return body["seq"], body["summary"]

    def write_snapshot(self, seq: int, summary: dict) -> None:
        status, body = self._http.request(
            "PUT", f"/doc/{self._doc}/snapshot", {"seq": seq, "summary": summary},
            token=self._token,
        )
        if status != 200:
            raise DriverError(f"snapshot write failed: {body}")

    def upload_summary(self, summary_tree: dict) -> str:
        status, body = self._http.request(
            "POST", f"/doc/{self._doc}/summary", {"tree": summary_tree},
            token=self._token,
        )
        if status != 200:
            raise DriverError(f"summary upload failed: {body}")
        return body["handle"]

    def upload_blob_content(self, content: str) -> str:
        status, body = self._http.request(
            "POST", f"/doc/{self._doc}/blob", {"content": content},
            token=self._token,
        )
        if status != 200:
            raise DriverError(f"blob upload failed: {body}")
        return body["id"]

    def read_blob_content(self, blob_id: str) -> str:
        status, body = self._http.request(
            "GET", f"/doc/{self._doc}/blob/{blob_id}", token=self._token
        )
        if status != 200:
            # 404 = definitively absent (not retryable); other statuses may
            # be transient — callers distinguishing "missing" from "broken"
            # rely on can_retry.
            raise DriverError(f"blob read failed: {body}", can_retry=status != 404)
        return body["content"]

    def get_versions(self, max_count: int = 5) -> list[dict]:
        status, body = self._http.request(
            "GET", f"/doc/{self._doc}/versions?max={max_count}", token=self._token
        )
        if status != 200:
            raise DriverError(f"version list failed: {body}")
        return body["versions"]

    def get_snapshot_version(self, version_id: str) -> tuple[int, dict] | None:
        status, body = self._http.request(
            "GET", f"/doc/{self._doc}/snapshot?version={version_id}",
            token=self._token,
        )
        if status == 404:
            return None
        if status != 200:
            raise DriverError(f"versioned snapshot read failed: {body}")
        return body["seq"], body["summary"]


class NetworkDocumentService(DocumentService):
    def __init__(self, factory: "NetworkDocumentServiceFactory", doc_id: str) -> None:
        self._f = factory
        self._doc = doc_id

    def connect_to_delta_stream(
        self,
        client_id: str,
        listener: Callable[[SequencedMessage], None],
        nack_listener: Callable[[Nack], None] | None = None,
        signal_listener: Callable[[SignalMessage], None] | None = None,
        mode: str = "write",
        boot_listener: Callable[[], None] | None = None,
    ) -> DeltaConnection:
        token = None
        if self._f.token_provider is not None:
            token = self._f.token_provider(self._doc, client_id)
        conn = NetworkDeltaConnection(
            self._f.host, self._f.port, self._doc, client_id, mode,
            listener, nack_listener, signal_listener, token=token,
            boot_listener=boot_listener,
        )
        self._f.live_connections.append(conn)
        return conn

    def _storage_token(self) -> str | None:
        if self._f.token_provider is None:
            return None
        return self._f.token_provider(self._doc, STORAGE_CLIENT)

    def connect_to_delta_storage(self) -> DeltaStorageService:
        return HttpDeltaStorageService(self._f.http, self._doc, self._storage_token())

    def connect_to_storage(self) -> StorageService:
        return HttpStorageService(self._f.http, self._doc, self._storage_token())


class NetworkDocumentServiceFactory(DocumentServiceFactory):
    """Driver factory bound to one service plane (host, tcp port, http
    port).  Tracks every delta connection it opens so hosts/tests can pump
    them deterministically (``sync_all``)."""

    def __init__(
        self, host: str, port: int, http_port: int, token_provider=None
    ) -> None:
        self.host = host
        self.port = port
        self.http = _Http(host, http_port)
        self.token_provider = token_provider
        self.live_connections: list[NetworkDeltaConnection] = []

    def create_document_service(self, doc_id: str) -> DocumentService:
        return NetworkDocumentService(self, doc_id)

    def sync_all(self, rounds: int = 16) -> int:
        """Dispatch until every live connection is quiescent: repeated sync
        rounds, stopping after a full round that dispatched nothing (an op
        dispatched on one connection may trigger submits that feed
        another)."""
        total = 0
        for _ in range(rounds):
            n = 0
            for conn in list(self.live_connections):
                if conn.connected:
                    n += conn.sync()
                else:
                    # Final drain, then drop: dead connections must not
                    # accumulate across reconnect churn.
                    n += conn.pump()
                    self.live_connections.remove(conn)
            total += n
            if n == 0:
                return total
        raise DriverError(f"sync_all did not quiesce after {rounds} rounds")
