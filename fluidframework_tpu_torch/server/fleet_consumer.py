"""Fleet consumer: wire bytes -> native encoder -> device, end to end.

A port of ``fluidframework_tpu/server/fleet_consumer.py`` over the port's
engines.  It subscribes to a firehose (``{"t": "consume", "doc": ...}``,
answered by ``{"t": "consuming"}``, then bare SequencedMessage JSON lines;
the deltas-topic consumer seam) for a fleet of documents and feeds the RAW
BYTES into a batched engine's ``ingest_lines`` (the C++ wire encoder,
``native/ingest.cpp``).  The Python data plane touches bytes only at chunk
granularity — per-socket ``recv``, one ``rfind(b"\\n")`` to peel the
trailing partial line, one ``ingest_lines`` call — and op application runs
on the engine's device in its batched ``step``.

- one epoll readiness wait covers the whole socket set;
- a ``summaryAck`` in a chunk triggers the engine's ``compact`` (the MSN
  floor itself rides each host's ``min_seq``);
- flow control: a doc over the engine's high ingest watermark
  (``update_overload``) has its socket unregistered until the queue drains
  below the low one;
- a boot marker (``{"t":"resync","boot":true}``) fetches the doc's latest
  snapshot from the historian's HTTP API (``GET /doc/<id>/snapshot``),
  adopts it (``engine.adopt_boot_snapshot``) and re-subscribes from its seq;
- ``run_for`` pumps to a row count and steps; ``health`` is the engine's
  health plus the transport counters.
- ``RankFleetConsumer``: the consumer of one rank of a rank mesh (one
  process a card, ``fleet_main --mesh N`` under ``torch.distributed.run``):
  every rank reads the same firehose, and a pump stages, per doc, only the
  lines every rank has read, so every rank steps the same rows.

With a mesh-served engine (``fleet_main --mesh N``) staging packs by doc
placement and ``health()`` carries the per-shard load surface
(``shard_ops``/``shard_queue_depth``/``hot_shards``, and with
``--seg-shards`` the segment-lane gauges) that drives live doc migration
(``engine.rebalance_hot_shards``).
"""

from __future__ import annotations

import collections
import contextlib
import http.client
import json
import selectors
import socket

import numpy as np

from ..fanout.plane import RESYNC_BOOT_MARKER
from ..models.doc_batch_engine import DocBatchEngine

_BOOT_MARKER = RESYNC_BOOT_MARKER.rstrip(b"\n")


class FleetConsumer:
    """One firehose socket per document, feeding one batched engine."""

    def __init__(
        self,
        host: str,
        port: int,
        engine: DocBatchEngine,
        doc_ids: list[str],
        recv_bytes: int = 1 << 16,
        boot_store=None,
        historian: tuple[str, int] | None = None,
    ) -> None:
        if len(doc_ids) > engine.n_docs:
            raise ValueError(
                f"{len(doc_ids)} documents > engine capacity {engine.n_docs}"
            )
        self.engine = engine
        self.doc_ids = list(doc_ids)
        self._host = host
        self._port = port
        # Snapshot-boot tier address ((host, port) of the historian HTTP
        # front): the client half of the fan-out plane's
        # ``{"t":"resync","boot":true}`` contract — when a firehose falls
        # off the retained log, the consumer fetches the latest historian
        # snapshot, adopts it into the engine, and re-consumes from its
        # seq.  Without it a boot marker kills the doc's socket (the
        # supervisor restart path).
        self._historian = historian
        self.boot_resyncs = 0
        self.boot_resync_failures = 0
        self.booted_docs: list[int] = []
        if boot_store is not None:
            # Boot-from-summary: seed the engine from the latest acked
            # scribe commits (or checkpoint records) BEFORE attaching, so
            # the firehose catch-up replay of the covered prefix is
            # skipped by seq floor and only the post-ack tail applies
            # (counted as boot_replay_len in engine health).
            self.booted_docs = engine.restore_from_checkpoints(
                store=boot_store
            )
        self._recv_bytes = recv_bytes
        self._socks: list[socket.socket] = []
        self._tails: list[bytes] = [b"" for _ in doc_ids]
        self.rows_staged = 0
        self.bytes_consumed = 0
        # Doc indices whose firehose socket the SERVER closed (shard
        # restart/shutdown): the consumer is dead for those docs and its
        # supervisor should restart it.
        self.dead_socks: set[int] = set()
        # Credit-based flow control: docs over the engine's high ingest
        # watermark have their socket UNREGISTERED from the selector (no
        # reads, socket kept open) until the queue drains below the low
        # watermark — the backlog backs up into the kernel buffer and the
        # server's outbound queue, where admission control sees it and
        # starts shedding producers.  The engine's OverloadGate owns the
        # hysteresis; this set mirrors which sockets are parked.
        self.paused_socks: set[int] = set()
        self.pump_pauses = 0
        self.pump_resumes = 0
        self._sel = selectors.DefaultSelector()  # epoll: no FD_SETSIZE cap
        try:
            for doc_id in doc_ids:
                s = self._subscribe(doc_id)
                self._socks.append(s)  # tracked immediately: any later
                self._sel.register(   # failure closes the whole set
                    s, selectors.EVENT_READ, len(self._socks) - 1
                )
        except BaseException:
            self.close()
            raise

    def _subscribe(self, doc_id: str, from_seq: int = 0) -> socket.socket:
        """Open one firehose subscription (handshake done, socket
        nonblocking); ``from_seq`` skips the already-covered prefix of the
        catch-up (the boot-resync re-consume floor)."""
        s = self._connect(self._host, self._port)
        try:
            req = {"t": "consume", "doc": doc_id}
            if from_seq:
                req["from"] = from_seq
            s.sendall((json.dumps(req) + "\n").encode())
            # Unbuffered ack read: a buffered reader would swallow
            # catch-up bytes already in flight behind the ack line.
            ack_buf = bytearray()
            while not ack_buf.endswith(b"\n"):
                ch = s.recv(1)
                if not ch:
                    raise RuntimeError(
                        "connection closed during consume handshake"
                    )
                ack_buf += ch
            ack = json.loads(ack_buf)
            if ack.get("t") != "consuming":
                raise RuntimeError(f"consume handshake failed: {ack}")
            s.setblocking(False)
            return s
        except BaseException:
            s.close()
            raise

    @staticmethod
    def _connect(host: str, port: int) -> socket.socket:
        """getaddrinfo-iterating connect (IPv6/multi-address hosts) with a
        deep receive buffer set BEFORE connect (so the TCP window scales):
        the producer can dump a whole backlog into the kernel in one go
        instead of 64KB ping-pong gated on the consumer's drain cadence."""
        err: Exception | None = None
        for family, kind, proto, _cn, addr in socket.getaddrinfo(
            host, port, type=socket.SOCK_STREAM
        ):
            s = socket.socket(family, kind, proto)
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(30)
                s.connect(addr)
                return s
            except OSError as e:
                err = e
                s.close()
        raise err if err is not None else OSError(f"no addresses for {host}")

    # ------------------------------------------------------------ data plane
    def pump(self, wait_s: float = 0.02) -> int:
        """Drain every READY socket once; returns op rows staged this pass.

        One ``select`` readiness wait covers the whole socket set — an
        idle socket costs nothing (the old per-socket recv-timeout walk
        stalled the drain up to 50ms per quiet socket per pass, which was
        most of the measured wire-ingest gap)."""
        staged = 0
        acked = False
        if len(self.dead_socks) == len(self._socks):
            return 0
        # Resume first: queues drained by step() between pumps may have
        # fallen below the low watermark — re-register those sockets so
        # this very select sees their backlog.
        self._apply_flow_control()
        for idx, feed in self._read_ready(wait_s):
            # Scribe-driven MSN: a summary ack in the feed is the zamboni
            # TRIGGER (one substring probe per chunk, anchored on the wire
            # type field — no extra parse).  The compaction floor itself is
            # each host's min_seq, refreshed by the ack message's own
            # min_seq stamp through ingest; the ack's contents["msn"] is
            # the durable ack-derived floor, carried on the wire for
            # consumers that need durability-bounded windows.
            acked = acked or b'"type":"summaryAck"' in feed
            if _BOOT_MARKER in feed:
                # Fan-out plane drop-to-catch-up, boot flavor: the missed
                # range left the retained log — snapshot-boot instead of
                # consuming a gapped stream (one substring probe per
                # chunk, same idiom as the summaryAck trigger).
                staged += self._handle_boot_marker(idx, feed)
                continue
            staged += self.engine.ingest_lines(idx, feed)
        self.rows_staged += staged
        if staged:
            # Pause any doc this pass pushed over its high watermark BEFORE
            # the next select, so one hot doc stops accumulating host-side
            # the moment the megastep budget falls behind.
            self._apply_flow_control()
        if acked:
            # Compact collab windows on the ack, not on a timer: the
            # scribe's durable floor just advanced, and every host's
            # min_seq was refreshed by the ack message itself.
            self.engine.compact()
            self.engine.counters.bump("msn_compactions")
        return staged

    def _read_ready(self, wait_s: float):
        """Yield ``(doc index, feed)`` for every ready socket with complete
        lines: one ``select``, then each socket drained (its trailing
        partial line kept for the next pass)."""
        ready = self._sel.select(wait_s)
        for key, _events in ready:
            idx, sock = key.data, key.fileobj
            if idx in self.dead_socks:
                continue
            chunks: list[bytes] = []
            while True:
                try:
                    data = sock.recv(self._recv_bytes)
                except (BlockingIOError, TimeoutError, socket.timeout):
                    break
                except OSError:
                    self._mark_dead(idx, sock)
                    break
                if not data:  # orderly close: the shard went away
                    self._mark_dead(idx, sock)
                    break
                chunks.append(data)
            if not chunks:
                continue
            buf = self._tails[idx] + b"".join(chunks)
            cut = buf.rfind(b"\n")
            if cut < 0:
                self._tails[idx] = buf
                continue
            feed, self._tails[idx] = buf[: cut + 1], buf[cut + 1 :]
            self.bytes_consumed += len(feed)
            yield idx, feed

    def _handle_boot_marker(self, idx: int, feed: bytes) -> int:
        """Consume the pre-marker prefix, then snapshot-boot: fetch the
        latest historian snapshot, adopt it into the engine, and
        re-subscribe the firehose from its seq.  Post-marker bytes are
        DISCARDED — the re-subscription's catch-up re-delivers everything
        past the adopted floor, so dropping them is what keeps the stream
        gapless."""
        head, _, _rest = feed.partition(_BOOT_MARKER)
        cut = head.rfind(b"\n")
        staged = 0
        if cut >= 0:
            staged += self.engine.ingest_lines(idx, head[: cut + 1])
        self._tails[idx] = b""
        self._boot_resync(idx)
        return staged

    def _boot_resync(self, idx: int) -> None:
        doc_id = self.doc_ids[idx]
        old = self._socks[idx]
        with contextlib.suppress(KeyError, ValueError):
            self._sel.unregister(old)
        with contextlib.suppress(OSError):
            old.close()
        try:
            if self._historian is None:
                raise RuntimeError(
                    "boot resync marker without a historian address"
                )
            # Short timeout: this fetch runs on the pump thread (boot
            # resyncs are rare, but a wedged historian must not stall the
            # whole fleet's drain for long — failure falls to the
            # supervisor restart path below).
            conn = http.client.HTTPConnection(*self._historian, timeout=5)
            try:
                conn.request("GET", f"/doc/{doc_id}/snapshot")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
            if resp.status != 200:
                raise RuntimeError(f"historian snapshot read: {body}")
            # The historian's seq stamp is authoritative (the snapshot's
            # commit seq), so it lands after the record's own keys.
            record = {**body["summary"], "doc": doc_id,
                      "seq": int(body["seq"])}
            result = self.engine.adopt_boot_snapshot(idx, record)
            if not result.adopted:
                # Refused below the doc's floor: the snapshot cannot help,
                # and the server already declared this consumer's range
                # gone — re-subscribing from the engine's own floor would
                # just draw another boot marker (an infinite resync loop
                # that looks healthy).  Fall to the supervisor path.
                raise RuntimeError(
                    f"boot snapshot seq {record['seq']} at or below doc "
                    f"floor {result.floor}: nothing to adopt"
                )
            sock = self._subscribe(doc_id, from_seq=result.floor)
        except (OSError, RuntimeError, ValueError, KeyError) as e:
            # No snapshot to boot from (or the re-subscribe died): the doc
            # is dead for this consumer, exactly like a server close — the
            # supervisor restart path owns it from here.
            self.boot_resync_failures += 1
            self.engine.counters.bump("boot_resync_failures")
            self.dead_socks.add(idx)
            if self.engine.counters.logger is not None:
                self.engine.counters.logger.error(
                    "boot_resync_failed", f"doc {doc_id}: {e}"
                )
            return
        self._socks[idx] = sock
        self._sel.register(sock, selectors.EVENT_READ, idx)
        self.paused_socks.discard(idx)
        self.boot_resyncs += 1
        self.engine.counters.bump("boot_resyncs_handled")

    def _apply_flow_control(self) -> None:
        """Advance the engine's watermark hysteresis and park/re-arm the
        affected firehose sockets (per-partition pause/resume).  A paused
        socket stays open — its unread broadcast accumulates in the kernel
        buffer and the shard's outbound queue, which is exactly the signal
        the front's admission control sheds producers on."""
        to_pause, to_resume = self.engine.update_overload()
        for d in to_pause:
            if d in self.dead_socks or d in self.paused_socks:
                continue
            self.paused_socks.add(d)
            self.pump_pauses += 1
            with contextlib.suppress(KeyError, ValueError):
                self._sel.unregister(self._socks[d])
        for d in to_resume:
            if d not in self.paused_socks:
                continue
            self.paused_socks.discard(d)
            if d in self.dead_socks:
                continue
            self.pump_resumes += 1
            self._sel.register(self._socks[d], selectors.EVENT_READ, d)

    def step(self) -> int:
        """Apply everything staged as one batched device step (the engine
        runs its own recovery, watchdog cadence, and checkpoint cadence
        inside ``step`` when configured)."""
        return self.engine.step()

    def health(self) -> dict:
        """Engine health counters + this consumer's transport state."""
        out = self.engine.health()
        out.update(
            dead_socks=len(self.dead_socks),
            rows_staged=self.rows_staged,
            bytes_consumed=self.bytes_consumed,
            booted_docs=len(self.booted_docs),
            paused_docs=len(self.paused_socks),
            pump_pauses=self.pump_pauses,
            pump_resumes=self.pump_resumes,
            boot_resyncs=self.boot_resyncs,
            boot_resync_failures=self.boot_resync_failures,
        )
        return out

    def run_for(self, expected_rows: int, max_idle_pumps: int = 200) -> None:
        """Pump until ``expected_rows`` op rows staged (test/bench driver);
        raises if the stream stays idle for ``max_idle_pumps`` passes."""
        idle = 0
        while self.rows_staged < expected_rows:
            if self.paused_socks:
                # A doc hit its ingest watermark: drain the backlog on
                # device so the gate can re-arm its socket (the serving
                # loop's step() plays this role in production).
                self.step()
            if self.pump() == 0:
                idle += 1
                if idle >= max_idle_pumps:
                    raise TimeoutError(
                        f"firehose idle: {self.rows_staged}/{expected_rows} rows"
                    )
            else:
                idle = 0
        self.step()

    def _mark_dead(self, idx: int, sock: socket.socket) -> None:
        self.dead_socks.add(idx)
        # A paused (already-unregistered) socket can die too: suppress the
        # double-unregister, keep the dead mark.
        with contextlib.suppress(KeyError, ValueError):
            self._sel.unregister(sock)

    def close(self) -> None:
        for s in self._socks:
            with contextlib.suppress(OSError):
                s.close()
        self._socks = []
        with contextlib.suppress(OSError, AttributeError):
            self._sel.close()


class RankFleetConsumer(FleetConsumer):
    """The consumer of one rank of a rank mesh (``parallel.mesh.rank_mesh``:
    one process a card, each holding its shard's rows of the same engine).
    Every rank subscribes to the same firehose.  A pump reads what the
    sockets hold into per-doc line buffers, then one ``min_all`` over the
    ranks agrees, per doc, on the lines every rank has read (and on the
    docs whose socket every rank saw close); each rank stages exactly
    those, so every rank's engine holds the same rows before each
    (collective) ``step``.  A ``summaryAck`` among the staged lines
    triggers ``compact`` on every rank alike.  A boot marker marks the doc
    dead (no historian on a rank mesh: the supervisor restart path).
    ``pump`` is collective: every rank calls it in the same order."""

    def __init__(self, host: str, port: int, engine, doc_ids: list[str], mesh,
                 recv_bytes: int = 1 << 16, boot_store=None) -> None:
        super().__init__(host, port, engine, doc_ids, recv_bytes=recv_bytes,
                         boot_store=boot_store)
        self._mesh = mesh
        self._lines: list[collections.deque] = [collections.deque() for _ in doc_ids]
        self._closed: set[int] = set()

    def _mark_dead(self, idx: int, sock: socket.socket) -> None:
        # The close is this rank's alone until every rank saw it (``pump``).
        self._closed.add(idx)
        with contextlib.suppress(KeyError, ValueError):
            self._sel.unregister(sock)

    def pump(self, wait_s: float = 0.02) -> int:
        """Read every ready socket, then stage the lines every rank has
        read; returns op rows staged (the same on every rank)."""
        self._apply_flow_control()
        if len(self._closed) < len(self._socks):
            for idx, feed in self._read_ready(wait_s):
                head, marker, _rest = feed.partition(_BOOT_MARKER)
                if marker:
                    feed = head[: head.rfind(b"\n") + 1]
                    self._closed.add(idx)
                    with contextlib.suppress(KeyError, ValueError):
                        self._sel.unregister(self._socks[idx])
                self._lines[idx].extend(feed.splitlines(keepends=True))
        n = len(self._lines)
        mine = np.array([len(q) for q in self._lines]
                        + [int(i in self._closed) for i in range(n)], np.int64)
        agreed = self._mesh.min_all(mine)
        staged = 0
        acked = False
        for idx in range(n):
            take = int(agreed[idx])
            if take:
                q = self._lines[idx]
                feed = b"".join(q.popleft() for _ in range(take))
                acked = acked or b'"type":"summaryAck"' in feed
                staged += self.engine.ingest_lines(idx, feed)
            if agreed[n + idx] and not self._lines[idx]:
                self.dead_socks.add(idx)
        self.rows_staged += staged
        if staged:
            self._apply_flow_control()
        if acked:
            self.engine.compact()
            self.engine.counters.bump("msn_compactions")
        return staged
