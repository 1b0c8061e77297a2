"""One loadgen worker: an OS process owning real client sessions.

    python -m fluidframework_tpu_torch.loadgen.worker --config worker3.json

A port of ``fluidframework_tpu/loadgen/worker.py``.  Workers are host-only
clients: they import ``testing.chaos`` (which loads ``torch`` through
``device.py``) but never touch a device, and each drain report carries
``cuda_initialized`` (``torch.cuda.is_initialized()``), which the
coordinator's callers check stays false.

The worker dials the coordinator's control socket (JSON lines), announces
itself, then runs phases on command — each phase is a barrier: the
coordinator releases all workers into a phase together and waits for
every ``phase_done`` before moving on.

Sessions are the REAL client stack: every writer rides a
``NetworkDeltaConnection`` over TCP with stop-and-wait submission,
admission-nack backoff, and delta-storage catch-up — the exact
flow-control contract ``testing.chaos`` established (the string and tree
writers ARE the chaos writers; the map / matrix / channel-string writers
extend the same ``_ChaosWireClient`` base).  Op end-to-end latency
(edit staged -> sequenced ack dispatched) samples into per-phase
``utils.telemetry.Histogram``s and ships back losslessly (``to_wire``)
for coordinator-side merge.

The boot-storm phase drives the historian snapshot tier over HTTP: cold
GETs (ETag recorded) and conditional re-GETs (304 expected), both timed.
Scoped presence rides a signals-only session per worker subscribed to a
strict subset of the scope universe; signals published outside a
worker's interest set must never arrive (``foreign`` stays 0) — the
receiver-side check paired with the fanout plane's
``presence_scope_drops`` counter.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import json
import random
import socket
import sys
import time
import traceback
from collections import deque

from ..dds.channels import SharedStringChannel
from ..dds.shared_map import SharedMap
from ..dds.shared_matrix import SharedMatrix
from ..driver.network_driver import NetworkDeltaConnection
from ..framework.undo_redo import UndoRedoStackManager
from ..protocol.channel import (
    ChannelDeltaConnection,
    ChannelMessage,
    MessageCollection,
    MessageEnvelope,
)
from ..protocol.messages import MessageType
from ..testing.chaos import (
    ChaosTreeWriter,
    ChaosWriter,
    TornConnection,
    _ChaosWireClient,
)
from ..utils.telemetry import Histogram
from .schedule import DocSpec, WorkerSchedule, zipf_weights


# --------------------------------------------------------------- families
class MapWriter(_ChaosWireClient):
    """One raw-wire SharedMap client.  The map replica ignores JOIN
    messages (last-write-wins needs no quorum shorts), so join tracking
    lives here at the wire-client level."""

    def _init_replica(self) -> None:
        self.replica = SharedMap(self.client_id)
        self._joined = False

    def _assert_joined(self) -> None:
        assert self._joined, "join not delivered"

    def _apply(self, msg) -> None:
        if msg.seq <= self.last_seq:
            return  # catch-up / live-stream overlap
        self.last_seq = msg.seq
        if (
            msg.type == MessageType.JOIN
            and msg.contents.get("clientId") == self.client_id
        ):
            self._joined = True
        self.replica.process(msg)

    def edit(self) -> None:
        rng = self._rng
        r = rng.random()
        keys = sorted(self.replica.keys())
        if r < 0.78 or not keys:
            self.replica.set(f"k{rng.randrange(12)}", rng.randrange(10_000))
        elif r < 0.97:
            self.replica.delete(rng.choice(keys))
        else:
            self.replica.clear()

    def flush(self) -> int:
        sent = 0
        for m in self.replica.take_outbox():
            self._submit_one(m)
            sent += 1
        return sent

    def digest(self):
        return {k: self.replica.get(k) for k in sorted(self.replica.keys())}


class MatrixWriter(_ChaosWireClient):
    """One raw-wire SharedMatrix client (the matrix replica tracks the
    quorum itself — same join contract as SharedString)."""

    def _init_replica(self) -> None:
        self.replica = SharedMatrix(self.client_id)

    def _assert_joined(self) -> None:
        assert self.replica.short_client >= 0, "join not delivered"

    def _apply(self, msg) -> None:
        if msg.seq <= self.last_seq:
            return
        self.last_seq = msg.seq
        self.replica.process(msg)

    def edit(self) -> None:
        m, rng = self.replica, self._rng
        r, c = m.row_count, m.col_count
        if r == 0 or (r < 5 and rng.random() < 0.3):
            m.insert_rows(rng.randint(0, r), rng.randint(1, 2))
            return
        if c == 0 or (c < 5 and rng.random() < 0.3):
            m.insert_cols(rng.randint(0, c), rng.randint(1, 2))
            return
        x = rng.random()
        if x < 0.7 or (r <= 1 and c <= 1):
            m.set_cell(rng.randrange(r), rng.randrange(c), rng.randrange(1000))
        elif x < 0.85 and r > 1:
            m.remove_rows(rng.randrange(r), 1)
        elif c > 1:
            m.remove_cols(rng.randrange(c), 1)
        else:
            m.remove_rows(rng.randrange(r), 1)

    def flush(self) -> int:
        sent = 0
        for m in self.replica.take_outbox():
            self._submit_one(m)
            sent += 1
        return sent

    def digest(self):
        return self.replica.to_grid()


class ChanStringWriter(_ChaosWireClient):
    """A CHANNEL-level SharedString client: the full
    ``SharedStringChannel`` (interval collections, undo-redo) bridged to
    the wire through a ``ChannelDeltaConnection`` shim, the
    ``ChaosTreeWriter`` idiom.  Staged contents + local metadata pairs
    queue in submit order; our own sequenced ops pop the metadata FIFO
    (the container PendingStateManager zip, collapsed to one channel).

    The quorum table builds from JOIN messages — catch-up replays the log
    from seq 1, so every client that ever sequenced an op resolves."""

    def _init_replica(self) -> None:
        self.channel = SharedStringChannel("s")
        self._quorum: dict[str, int] = {}
        self._joined = False
        self._outbox: list = []
        self._md_fifo: deque = deque()
        self._client_seq = 0
        self._iv_serial = 0
        shim = ChannelDeltaConnection(
            submit_fn=self._stage,
            quorum_fn=lambda cid: self._quorum[cid],
            client_id_fn=lambda: self.client_id,
            ref_seq_fn=lambda: self.last_seq,
        )
        shim.connected = True
        self.channel.connect(shim)
        self.intervals = self.channel.get_interval_collection("marks")
        self.undo = UndoRedoStackManager()

    def _stage(self, contents, local_metadata=None, internal=False) -> None:
        self._outbox.append(contents)
        self._md_fifo.append(local_metadata)

    def _assert_joined(self) -> None:
        assert self._joined, "join not delivered"

    def _apply(self, msg) -> None:
        if msg.seq <= self.last_seq:
            return
        self.last_seq = msg.seq
        if msg.type == MessageType.JOIN:
            self._quorum[msg.contents["clientId"]] = msg.contents["short"]
            if msg.contents.get("clientId") == self.client_id:
                self._joined = True
            return
        if msg.type != MessageType.OP:
            return
        local = msg.client_id == self.client_id
        md = self._md_fifo.popleft() if local else None
        self.channel.process_messages(MessageCollection(
            envelope=MessageEnvelope(
                client_id=msg.client_id, seq=msg.seq,
                min_seq=msg.min_seq, ref_seq=msg.ref_seq,
            ),
            messages=[ChannelMessage(
                contents=msg.contents, local=local, local_metadata=md,
            )],
        ))

    def edit(self) -> None:
        """One mixed channel edit: string insert/remove through the
        undo-redo capture path, undo/redo replays, and interval collection
        add/change/delete.  Every call stages at least one op (fallbacks
        land on an insert), so the latency histogram never times a no-op."""
        rng = self._rng
        n = len(self.channel.text)
        kind = rng.choices(
            ["ins", "rm", "undo", "redo", "ivadd", "ivmut"],
            [6, 2, 1, 1, 2, 2],
        )[0]
        if kind == "undo" and self.undo.undoable:
            if self.undo.undo() and self._outbox:
                return
        elif kind == "redo" and self.undo.redoable:
            if self.undo.redo() and self._outbox:
                return
        elif kind == "ivadd" and n >= 2:
            a = rng.randint(0, n - 1)
            self._iv_serial += 1
            self.intervals.add(
                a, rng.randint(a, n - 1),
                props={"w": self.client_id},
                interval_id=f"{self.client_id}-iv{self._iv_serial}",
            )
            return
        elif kind == "ivmut" and n >= 2:
            ids = sorted(self.intervals.sequenced)
            if ids:
                iid = rng.choice(ids)
                if rng.random() < 0.6:
                    a = rng.randint(0, n - 1)
                    self.intervals.change(iid, start=a, end=rng.randint(a, n - 1))
                else:
                    self.intervals.delete(iid)
                return
        if kind == "rm" and n >= 4:
            p = rng.randint(0, n - 2)
            self.undo.capture_string_remove(self.channel, p, p + 1)
        else:
            self.undo.capture_string_insert(
                self.channel, rng.randint(0, n),
                "".join(rng.choice("mnopqrst")
                        for _ in range(rng.randint(1, 5))),
            )
        self.undo.close_current_operation()

    def flush(self) -> int:
        from ..protocol.messages import UnsequencedMessage

        sent = 0
        out, self._outbox = self._outbox, []
        for contents in out:
            self._client_seq += 1
            self._submit_one(UnsequencedMessage(
                client_id=self.client_id, client_seq=self._client_seq,
                ref_seq=self.last_seq, type=MessageType.OP,
                contents=contents,
            ))
            sent += 1
        return sent

    def digest(self):
        return chan_string_digest(self.channel, self.intervals)


def chan_string_digest(channel: SharedStringChannel, coll) -> dict:
    """The channel family's identity surface: visible text + every
    sequenced interval's (id, endpoints) — JSON-stable, so digests
    compare equal across the control-socket round trip."""
    return {
        "text": channel.text,
        "intervals": sorted(
            [iid, iv.start, iv.end] for iid, iv in coll.sequenced.items()
        ),
    }


WRITER_CLASSES = {
    "string": ChaosWriter,
    "tree": ChaosTreeWriter,
    "map": MapWriter,
    "matrix": MatrixWriter,
    "chan_string": ChanStringWriter,
}


def family_digest(writer, family: str):
    if family == "string":
        return writer.replica.text
    if family == "tree":
        return writer.root_json()
    return writer.digest()


# ----------------------------------------------------------- host oracles
def oracle_map(log) -> dict:
    """Fault-free replay of a sequenced log through a host SharedMap."""
    replica = SharedMap("__oracle__")
    for msg in log:
        replica.process(msg)
    return {k: replica.get(k) for k in sorted(replica.keys())}


def oracle_matrix(log) -> list:
    """Fault-free replay through a host SharedMatrix (grid view)."""
    replica = SharedMatrix("__oracle__")
    for msg in log:
        replica.process(msg)
    return replica.to_grid()


def oracle_chan_string(log) -> dict:
    """Fault-free replay through a read-only SharedStringChannel (every
    message remote — the oracle identity never appears in the log)."""
    quorum: dict[str, int] = {}
    channel = SharedStringChannel("s")
    shim = ChannelDeltaConnection(
        submit_fn=lambda contents, md=None, internal=False: None,
        quorum_fn=lambda cid: quorum[cid],
        client_id_fn=lambda: "__oracle__",
        ref_seq_fn=lambda: 0,
    )
    shim.connected = True
    channel.connect(shim)
    coll = channel.get_interval_collection("marks")
    for msg in log:
        if msg.type == MessageType.JOIN:
            quorum[msg.contents["clientId"]] = msg.contents["short"]
        elif msg.type == MessageType.OP:
            channel.process_messages(MessageCollection(
                envelope=MessageEnvelope(
                    client_id=msg.client_id, seq=msg.seq,
                    min_seq=msg.min_seq, ref_seq=msg.ref_seq,
                ),
                messages=[ChannelMessage(contents=msg.contents, local=False)],
            ))
    return chan_string_digest(channel, coll)


# ------------------------------------------------------------- presence
class PresenceAgent:
    """A signals-only session: subscribes a scoped interest set at
    connect, publishes presence across the FULL scope universe, and
    verifies the receiver half of the contract — a signal scoped outside
    our interests must never arrive (``foreign`` stays 0)."""

    def __init__(self, host, port, doc_id, client_id, interests) -> None:
        self.interests = set(interests)
        self.sent = 0
        self.recv = 0
        self.foreign = 0
        self.conn = NetworkDeltaConnection(
            host, port, doc_id, client_id, "read",
            listener=lambda m: None, nack_listener=None,
            signal_listener=self._on_signal,
            interests=sorted(self.interests),
        )

    def _on_signal(self, sig) -> None:
        c = sig.contents
        if not isinstance(c, dict) or c.get("type") != "presence":
            return
        self.recv += 1
        scope = c.get("scope")
        if scope is not None and scope not in self.interests:
            self.foreign += 1

    def publish(self, scope: str, payload) -> None:
        self.conn.submit_signal(
            {"type": "presence", "scope": scope, "data": payload}
        )
        self.sent += 1

    def pump(self) -> int:
        return self.conn.pump()

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self.conn.disconnect()


# -------------------------------------------------------------- the loop
def _historian_get(host, port, doc_id, etag=None):
    """One timed historian snapshot GET; returns (status, etag, dt_s)."""
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        headers = {"If-None-Match": etag} if etag else {}
        t0 = time.perf_counter()
        conn.request("GET", f"/doc/{doc_id}/snapshot", headers=headers)
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("ETag"), time.perf_counter() - t0
    finally:
        conn.close()


class WorkerRuntime:
    """The phase machine for one worker process (also drivable in-process
    by tests — the control socket is the only process-shaped seam)."""

    def __init__(self, cfg: dict) -> None:
        self.cfg = cfg
        self.host = cfg.get("host", "127.0.0.1")
        self.ws = WorkerSchedule(**cfg["worker"])
        self.docs = [DocSpec(**d) for d in cfg["docs"]]
        self.shards = cfg["shards"]  # [{"port","http_port","historian_port"}]
        self.scopes = list(cfg["scopes"])
        self.rng = random.Random(self.ws.seed)
        self.weights = zipf_weights(len(self.docs), cfg["zipf_a"])
        self.writers: dict[str, object] = {}
        self.hists: dict[str, Histogram] = {}
        self.presence: PresenceAgent | None = None
        self._serial = 0
        self.counters = {
            "ops": 0,
            "ops_sequenced": 0,
            "nack_backoffs": 0,
            "reconnects": 0,
            "torn": 0,
            "boots_cold": 0,
            "boots_304": 0,
            "boot_errors": 0,
        }

    # ------------------------------------------------------------ sessions
    def _make_writer(self, doc: DocSpec):
        self._serial += 1
        shard = self.shards[doc.shard]
        cls = WRITER_CLASSES[doc.family]
        return cls(
            self.host, shard["port"], shard["http_port"], doc.doc_id,
            f"w{self.ws.worker_id}.{doc.doc_id}.{self._serial}",
            random.Random(self.rng.getrandbits(32)),
        )

    def _retire(self, doc_id: str) -> None:
        w = self.writers.pop(doc_id, None)
        if w is None:
            return
        self.counters["ops_sequenced"] += w.ops_submitted
        self.counters["nack_backoffs"] += w.nack_backoffs
        w.close()

    def _writer(self, doc: DocSpec):
        w = self.writers.get(doc.doc_id)
        if w is None:
            w = self._make_writer(doc)
            self.writers[doc.doc_id] = w
        return w

    def _one_op(self, hist: Histogram) -> None:
        doc = self.rng.choices(self.docs, self.weights)[0]
        try:
            w = self._writer(doc)
            w.edit()
            t0 = time.perf_counter()
            w.flush()
            hist.record(time.perf_counter() - t0)
            self.counters["ops"] += 1
        except TornConnection:
            # A torn session is replaced with a fresh identity the next
            # time the doc is picked (delta-storage catch-up) — the
            # reconnect-churn contract the chaos harness established.
            self.counters["torn"] += 1
            self._retire(doc.doc_id)

    # -------------------------------------------------------------- phases
    def run_phase(self, name: str) -> dict:
        hist = self.hists.setdefault(name, Histogram())
        if name == "ramp":
            # Warm every doc (every family joins + edits at least once),
            # then the seeded remainder by Zipf popularity.
            for doc in self.docs:
                self._one_op_on(doc, hist)
            for _ in range(self.ws.ramp_ops):
                self._one_op(hist)
            if self.presence is None:
                self.presence = PresenceAgent(
                    self.host, self.shards[self.docs[0].shard]["port"],
                    self.docs[0].doc_id,
                    f"presence-w{self.ws.worker_id}",
                    self.ws.interests,
                )
        elif name == "steady":
            for i in range(1, self.ws.steady_ops + 1):
                self._one_op(hist)
                if self.ws.signal_every and i % self.ws.signal_every == 0:
                    self.presence.publish(
                        self.rng.choice(self.scopes),
                        {"worker": self.ws.worker_id, "op": i},
                    )
                    self.presence.pump()
                if self.ws.reconnect_every and i % self.ws.reconnect_every == 0:
                    live = sorted(self.writers)
                    if live:
                        doc_id = self.rng.choice(live)
                        self.writers[doc_id].tear()
                        self._retire(doc_id)
                        self.counters["reconnects"] += 1
            self.presence.pump()
        elif name == "boot_storm":
            cold = self.hists.setdefault("boot_cold", Histogram())
            warm = self.hists.setdefault("boot_304", Histogram())
            fleet_docs = [d for d in self.docs if d.family in ("string", "tree")]
            fw = zipf_weights(len(fleet_docs), self.cfg["zipf_a"])
            for _ in range(self.ws.boots):
                doc = self.rng.choices(fleet_docs, fw)[0]
                hport = self.shards[doc.shard]["historian_port"]
                status, etag, dt = _historian_get(self.host, hport, doc.doc_id)
                if status != 200 or not etag:
                    self.counters["boot_errors"] += 1
                    continue
                cold.record(dt)
                self.counters["boots_cold"] += 1
                status, _, dt = _historian_get(
                    self.host, hport, doc.doc_id, etag=etag
                )
                if status == 304:
                    warm.record(dt)
                    self.counters["boots_304"] += 1
                else:
                    self.counters["boot_errors"] += 1
        elif name == "drain":
            return self._drain()
        else:
            raise ValueError(f"unknown phase {name!r}")
        return {"ops": self.counters["ops"]}

    def _one_op_on(self, doc: DocSpec, hist: Histogram) -> None:
        try:
            w = self._writer(doc)
            w.edit()
            t0 = time.perf_counter()
            w.flush()
            hist.record(time.perf_counter() - t0)
            self.counters["ops"] += 1
        except TornConnection:
            self.counters["torn"] += 1
            self._retire(doc.doc_id)

    def _drain(self) -> dict:
        """Settle every session and ship the final report: per-doc
        digests, per-phase histograms (lossless), counters, presence."""
        digests = {}
        for doc in self.docs:
            w = self.writers.get(doc.doc_id)
            if w is None:
                # The session was torn/churned away: a fresh replica
                # catches up from delta storage — it must converge too.
                w = self._make_writer(doc)
                self.writers[doc.doc_id] = w
            w.settle()
            digests[doc.doc_id] = family_digest(w, doc.family)
        presence_stats = {"sent": 0, "recv": 0, "foreign": 0}
        if self.presence is not None:
            self.presence.pump()
            presence_stats = {
                "sent": self.presence.sent,
                "recv": self.presence.recv,
                "foreign": self.presence.foreign,
            }
        for doc_id in sorted(self.writers):
            self._retire(doc_id)
        if self.presence is not None:
            self.presence.close()
        return {
            "digests": digests,
            "hists": {k: h.to_wire() for k, h in self.hists.items()},
            "counters": dict(self.counters),
            "presence": presence_stats,
            "cuda_initialized": _cuda_initialized(),
        }

    def close(self) -> None:
        for doc_id in sorted(self.writers):
            with contextlib.suppress(Exception):
                self._retire(doc_id)
        if self.presence is not None:
            self.presence.close()


def _cuda_initialized() -> bool:
    """Whether this process initialised CUDA (it must not: workers are
    host-only clients).  ``torch`` is already loaded through
    ``testing.chaos``; a process without it initialised nothing."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


# --------------------------------------------------------- process entry
def _send_line(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


def run(config_path: str) -> int:
    with open(config_path) as f:
        cfg = json.load(f)
    rt = WorkerRuntime(cfg)
    sock = socket.create_connection(
        (rt.host, cfg["control_port"]), timeout=300
    )
    rfile = sock.makefile("r", encoding="utf-8")
    try:
        _send_line(sock, {"t": "hello", "worker": rt.ws.worker_id})
        for line in rfile:
            req = json.loads(line)
            kind = req.get("t")
            if kind == "phase":
                name = req["name"]
                try:
                    stats = rt.run_phase(name)
                except Exception:
                    _send_line(sock, {
                        "t": "error",
                        "worker": rt.ws.worker_id,
                        "phase": name,
                        "trace": traceback.format_exc(),
                    })
                    return 1
                _send_line(sock, {
                    "t": "phase_done",
                    "worker": rt.ws.worker_id,
                    "phase": name,
                    "stats": stats,
                })
            elif kind == "bye":
                return 0
        return 1  # coordinator hung up without a bye
    finally:
        rt.close()
        with contextlib.suppress(OSError):
            sock.close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="loadgen-worker")
    p.add_argument("--config", required=True,
                   help="path to the worker config JSON the coordinator "
                        "wrote (schedule share + topology + control port)")
    args = p.parse_args(argv)
    return run(args.config)


if __name__ == "__main__":
    sys.exit(main())
