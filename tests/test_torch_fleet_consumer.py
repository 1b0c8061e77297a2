"""The port's fleet consumer and its entry point against the JAX package's.

A reference ``NetworkServer`` with ``SharedString`` writers serves its
firehose over real TCP sockets to a reference ``FleetConsumer`` over the
reference engine and to the port's over the port's engine
(``device="cpu"``), attached to the same server.  After each drain the two
engines agree on every raw state column, text, annotation and error latch,
and the consumers on their transport counters.  Covered: a fleet with a
live tail, boot from a scribe summary, a dead socket when the shard closes,
flow control pausing and resuming a doc at its watermarks, and a
boot-marker resync against a stub shard and historian (adopted and refused).
Then ``fleet_main`` as a subprocess: the port's (``--device cpu``) serves
the reference's texts, and its restart probe shows ``restored`` and
``checkpointed_ops_skipped > 0``.  The reference engines run without a
mesh, as the port does.
"""

from __future__ import annotations

import json
import os
import random
import socket
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from fluidframework_tpu.dds.shared_string import SharedString
from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.server.fleet_consumer import FleetConsumer as RefConsumer
from fluidframework_tpu.server.netserver import NetworkServer
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu.server.ordered_log import Topic as RefTopic
from fluidframework_tpu.server.scribe import ScribeConfig as RefScribeConfig
from fluidframework_tpu.server.scribe import ScribeLambda as RefScribe
from fluidframework_tpu.server.scribe import SummaryRecordStore as RefSummaryStore
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.native import ingest_native
from fluidframework_tpu_torch.protocol.messages import SequencedMessage as PortMsg
from fluidframework_tpu_torch.runtime.summary import make_scribe_ack
from fluidframework_tpu_torch.server.fleet_consumer import RESYNC_BOOT_MARKER, FleetConsumer
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore, Topic
from fluidframework_tpu_torch.server.scribe import ScribeConfig, ScribeLambda, SummaryRecordStore

import torch_twins as twins
from test_torch_recovery import assert_engines_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(max_segments=64, text_capacity=512, max_insert_len=8, ops_per_step=8,
            remove_slots=2, prop_slots=2, ob_slots=2)
# Transport counters both consumers keep with the same meaning.
TRANSPORT = ("dead_socks", "rows_staged", "bytes_consumed", "booted_docs",
             "boot_resyncs", "boot_resync_failures")


@pytest.fixture(scope="module", autouse=True)
def _native_encoder():
    ingest_native.warm()
    if not (ingest_native.loaded() and twins.reference_encoder_loaded()):
        pytest.skip("the native ingest encoder did not build (no g++)")


@pytest.fixture
def server():
    srv = NetworkServer().start()
    yield srv
    srv.stop()


def _writers(server, doc_id: str, n: int) -> list[SharedString]:
    with server.lock:
        doc = server.service.document(doc_id)
        out = []
        for w in range(n):
            c = SharedString(client_id=f"{doc_id}-w{w}")
            doc.connect(c.client_id, c.process)
            out.append(c)
        doc.process_all()
    return out


def _flush(server, doc_id: str, writers) -> int:
    n = 0
    with server.lock:
        doc = server.service.document(doc_id)
        for c in writers:
            for m in c.take_outbox():
                doc.submit(m)
                n += 1
        doc.process_all()
    return n


def _edit_round(server, fleets, rows, rng):
    for i, (doc_id, writers) in enumerate(fleets):
        for c in writers:
            n = len(c.text)
            if rng.random() < 0.7 or n < 4:
                c.insert_text(rng.randint(0, n), "".join(
                    rng.choice("abcdef") for _ in range(rng.randint(1, 6))))
            else:
                p = rng.randint(0, n - 2)
                c.remove_range(p, p + 1)
        rows[i] += _flush(server, doc_id, writers)


def _pair(n_docs, keys, **kw):
    kw = {**GEOM, **kw}
    return (RefEngine(n_docs, use_mesh=False, doc_keys=keys, **kw),
            DocBatchEngine(n_docs, device="cpu", doc_keys=keys, **kw))


def _transport(fc) -> dict:
    h = fc.health()
    return {k: h[k] for k in TRANSPORT}


def test_consumer_matches_reference_over_tcp(server):
    """Catch-up history, then a live tail landing while both consumers
    are attached."""
    rng = random.Random(3)
    fleets = [(f"d{i}", _writers(server, f"d{i}", 2)) for i in range(4)]
    rows = [0] * 4
    for _ in range(3):
        _edit_round(server, fleets, rows, rng)
    keys = [d for d, _ in fleets]
    ref, port = _pair(4, keys)
    consumers = [RefConsumer("127.0.0.1", server.port, ref, keys),
                 FleetConsumer("127.0.0.1", server.port, port, keys)]
    try:
        t = threading.Thread(target=lambda: [_edit_round(server, fleets, rows, rng)
                                             for _ in range(3)])
        t.start()
        t.join()
        for fc in consumers:
            fc.run_for(sum(rows))
        assert_engines_equal(ref, port, 4)
        for i, (_doc, writers) in enumerate(fleets):
            assert port.text(i) == writers[0].text
        assert all(h.mode == "native" for h in port.hosts)
        assert _transport(consumers[1]) == _transport(consumers[0])
        assert consumers[1].rows_staged == sum(rows)
    finally:
        for fc in consumers:
            fc.close()


def test_consumer_boots_from_scribe_summary_like_reference(server, tmp_path):
    writers = _writers(server, "db", 2)
    a, b = writers
    a.insert_text(0, "hello scribe")
    _flush(server, "db", writers)
    b.remove_range(0, 6)
    _flush(server, "db", writers)
    with server.lock:
        log = list(server.service.document("db").sequencer.log)
    stores = {}
    for name, topic, Scribe, Config, Store, conv in (
        ("ref", RefTopic("deltas", 1), RefScribe, RefScribeConfig, RefSummaryStore,
         lambda m: m),
        ("port", Topic("deltas", 1), ScribeLambda, ScribeConfig, SummaryRecordStore,
         lambda m: PortMsg.from_json(m.to_json())),
    ):
        for m in log:
            topic.produce("db", conv(m))
        kw = {"device": "cpu"} if name == "port" else {}
        scribe = Scribe(topic, str(tmp_path / name), config=Config(max_ops=1), **kw)
        scribe.pump()
        stores[name] = Store.from_scribe(scribe)
    assert stores["port"].load("db") == stores["ref"].load("db")
    a.insert_text(len(a.text), "!")
    tail_rows = _flush(server, "db", writers)
    ref, port = _pair(1, ["db"], max_insert_len=16)
    consumers = [RefConsumer("127.0.0.1", server.port, ref, ["db"], boot_store=stores["ref"]),
                 FleetConsumer("127.0.0.1", server.port, port, ["db"],
                               boot_store=stores["port"])]
    try:
        assert [fc.booted_docs for fc in consumers] == [[0], [0]]
        assert port.text(0) == "scribe"
        for fc in consumers:
            fc.run_for(tail_rows)
        assert port.text(0) == a.text == "scribe!"
        assert_engines_equal(ref, port, 1)
        hr, hp = consumers[0].health(), consumers[1].health()
        for k in (*TRANSPORT, "checkpointed_ops_skipped", "boot_replay_len"):
            assert hp[k] == hr[k], k
        assert hp["boot_replay_len"] == tail_rows and hp["checkpointed_ops_skipped"] > 0
        assert port.hosts[0].base_seq == ref.hosts[0].base_seq
    finally:
        for fc in consumers:
            fc.close()


class _StubShard:
    """A firehose that answers the consume handshake and then serves
    scripted bytes per connection: ``script(doc, from_seq)`` returns the
    bytes to send after the ack.  Records every request it saw."""

    def __init__(self, script, close_after=False):
        self.script = script
        self.close_after = close_after
        self.requests: list[dict] = []
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.conns: list[socket.socket] = []
        self._t = threading.Thread(target=self._serve, daemon=True)
        self._t.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(1)
                if not chunk:
                    break
                buf += chunk
            req = json.loads(buf)
            self.requests.append(req)
            conn.sendall(b'{"t":"consuming"}\n' + self.script(req["doc"], req.get("from", 0)))
            if self.close_after:
                conn.close()
            else:
                self.conns.append(conn)

    def close(self):
        self.sock.close()
        for c in self.conns:
            c.close()


class _StubHistorian:
    """``GET /doc/<id>/snapshot`` answering one scripted snapshot."""

    def __init__(self, seq, summary):
        body = json.dumps({"seq": seq, "commit": "c0", "summary": summary}).encode()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):  # noqa: N802
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_consumer_marks_a_closed_shard_dead():
    for Engine, Consumer, kw in ((RefEngine, RefConsumer, {"use_mesh": False}),
                                 (DocBatchEngine, FleetConsumer, {"device": "cpu"})):
        shard = _StubShard(lambda _d, _f: b"", close_after=True)
        eng = Engine(1, recovery="off", **GEOM, **kw)
        fc = Consumer("127.0.0.1", shard.port, eng, ["dx"])
        try:
            assert not fc.dead_socks
            for _ in range(100):
                fc.pump()
                if fc.dead_socks:
                    break
            assert fc.dead_socks == {0} and fc.health()["dead_socks"] == 1
            assert fc.pump() == 0  # every socket dead: nothing to drain
        finally:
            fc.close()
            shard.close()


def _insert_lines(seqs, client="w0", start_len=0):
    """Sequenced single-writer appends of "ab" as wire bytes."""
    out = [PortMsg(client_id=client, client_seq=0, ref_seq=0, seq=0, min_seq=0,
                   type="join", contents={"clientId": client, "short": 0}).wire_line()]
    for s in seqs:
        out.append(PortMsg(client_id=client, client_seq=s, ref_seq=s - 1, seq=s,
                           min_seq=0, contents={"type": 0, "pos1": 2 * (s - 1),
                                                "seg": "ab"}).wire_line())
    return out


def test_flow_control_pauses_and_resumes_like_reference():
    """A doc whose catch-up passes the high watermark in one pump is parked
    (its socket unregistered) until ``step`` drains it below the low one;
    both consumers end identical, with the same rows and bytes.  The
    scribe's summaryAck at the end of the feed triggers one compaction."""
    lines = _insert_lines(range(1, 41))
    ack = make_scribe_ack("dq", 40, "c0").wire_line()
    shard = _StubShard(lambda _d, _f: b"".join(lines) + ack)
    ref, port = _pair(1, ["dq"], overload_high_watermark=8, overload_low_watermark=2,
                      max_segments=128, text_capacity=1024)
    consumers = [RefConsumer("127.0.0.1", shard.port, ref, ["dq"]),
                 FleetConsumer("127.0.0.1", shard.port, port, ["dq"])]
    try:
        for fc in consumers:
            fc.run_for(40)
            fc.pump(wait_s=0.01)  # the drained doc's socket re-arms here
        assert_engines_equal(ref, port, 1)
        assert port.text(0) == "ab" * 40
        for fc in consumers:
            assert fc.pump_pauses >= 1 and fc.pump_resumes >= 1
            assert not fc.paused_socks
        assert _transport(consumers[1]) == _transport(consumers[0])
        hr, hp = ref.health(), port.health()
        for k in ("overload", "overloaded_docs", "megastep_budget", "msn_compactions"):
            assert hp[k] == hr[k], k
        assert hp["msn_compactions"] == 1
        assert hp["overload_events"] >= 1
    finally:
        for fc in consumers:
            fc.close()
        shard.close()


@pytest.mark.parametrize("case", ["adopted", "refused"])
def test_boot_marker_resync_like_reference(case, tmp_path):
    """The firehose delivers ops 1-5, then the boot marker and bytes that
    must be dropped; the consumer reads the historian's snapshot and either
    adopts it (seq 9) and re-subscribes from 9, converging with a full
    replay, or refuses it (seq 5, the floor) and marks the doc dead."""
    lines = _insert_lines(range(1, 13))
    snap_seq = 9 if case == "adopted" else 5
    rec_eng = DocBatchEngine(1, device="cpu", doc_keys=["dr"],
                             checkpoint_store=CheckpointStore(str(tmp_path / "rec")), **GEOM)
    rec_eng.ingest_batch([0] * (snap_seq + 1),
                         [PortMsg.from_json(line.decode()) for line in lines[: snap_seq + 1]])
    rec_eng.step()
    rec_eng.maybe_checkpoint(force=True)
    record = {k: v for k, v in CheckpointStore(str(tmp_path / "rec")).load("dr").items()
              if k not in ("doc", "seq")}

    def script(_doc, from_seq):
        if from_seq == 0:
            return b"".join(lines[:6]) + RESYNC_BOOT_MARKER + lines[7]
        return b"".join(lines[from_seq + 1:])

    out = {}
    for name, Engine, Consumer, Store, kw in (
        ("ref", RefEngine, RefConsumer, RefStore, {"use_mesh": False}),
        ("port", DocBatchEngine, FleetConsumer, CheckpointStore, {"device": "cpu"}),
    ):
        shard, hist = _StubShard(script), _StubHistorian(snap_seq, record)
        # With a checkpoint store a native doc tracks its applied floor.
        eng = Engine(1, recovery="off", doc_keys=["dr"], **GEOM, **kw,
                     checkpoint_store=Store(str(tmp_path / name)))
        fc = Consumer("127.0.0.1", shard.port, eng, ["dr"], historian=("127.0.0.1", hist.port))
        try:
            for _ in range(400):
                fc.pump(wait_s=0.01)
                fc.step()
                if fc.dead_socks or eng.hosts[0].last_seq >= 12:
                    break
            out[name] = {
                "requests": list(shard.requests), "text": eng.text(0),
                "floor": eng.hosts[0].last_seq, "transport": _transport(fc),
                "adopted": eng.counters.get("boot_snapshots_adopted"),
                "stale": eng.counters.get("boot_snapshots_stale"),
                "dead": sorted(fc.dead_socks),
            }
            if name == "port":
                port_eng = eng
            else:
                ref_eng = eng
        finally:
            fc.close()
            shard.close()
            hist.close()
    assert out["port"] == out["ref"]
    got = out["port"]
    if case == "adopted":
        assert got["requests"] == [{"t": "consume", "doc": "dr"},
                                   {"t": "consume", "doc": "dr", "from": 9}]
        assert got["adopted"] == 1 and got["transport"]["boot_resyncs"] == 1
        assert got["floor"] == 12 and got["text"] == "ab" * 12 and not got["dead"]
        assert_engines_equal(ref_eng, port_eng, 1)
    else:
        assert got["requests"] == [{"t": "consume", "doc": "dr"}]
        assert got["stale"] == 1 and got["dead"] == [0]
        assert got["transport"]["boot_resync_failures"] == 1
        assert got["text"] == "ab" * 5


def _fleet_main(argv, reference=False):
    if reference:
        code = ("import jax; jax.config.update('jax_platforms', 'cpu');"
                "from fluidframework_tpu.server.fleet_main import main;"
                f"raise SystemExit(main({argv!r}))")
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
               *argv, "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def test_fleet_main_serves_reference_texts_and_restarts(server, tmp_path):
    fleets = [(f"m{i}", _writers(server, f"m{i}", 2)) for i in range(3)]
    rows = [0] * 3
    rng = random.Random(5)
    for _ in range(3):
        _edit_round(server, fleets, rows, rng)
    docs = ",".join(d for d, _ in fleets)
    base = ["--port", str(server.port), "--docs", docs, "--max-insert-len", "8",
            "--capacity", "256", "--text-capacity", "2048", "--status-every", "60"]
    ref_lines = _fleet_main([*base, "--exit-after-rows", str(sum(rows))], reference=True)
    ckpt = str(tmp_path / "ckpt")
    port_lines = _fleet_main([*base, "--exit-after-rows", str(sum(rows)),
                              "--checkpoint-dir", ckpt])
    want = {d: writers[0].text for d, writers in fleets}
    assert ref_lines[-1]["texts"] == want
    done = port_lines[-1]
    assert done["done"] and done["errors"] == 0 and done["texts"] == want
    assert done["health"]["checkpoints_written"] == 3
    ready = next(line for line in port_lines if line.get("ready"))
    assert ready == {"ready": True, "family": "string", "docs": docs.split(","),
                     "port": server.port}
    # Restart after more traffic: the checkpoints restore first, the
    # firehose catch-up of the checkpointed prefix is skipped, and only the
    # new rows stage.
    new = [0] * 3
    _edit_round(server, fleets, new, rng)
    again = _fleet_main([*base, "--exit-after-rows", str(sum(new)), "--checkpoint-dir", ckpt])
    assert again[0]["restored"] == docs.split(",")
    assert again[-1]["health"]["checkpointed_ops_skipped"] > 0
    assert again[-1]["texts"] == {d: writers[0].text for d, writers in fleets}


def test_fleet_main_standby_scribe_metrics_trace_in_process(server, tmp_path, capsys):
    """The port's ``main`` in this process, on the CPU, with the serving
    flags the subprocess runs leave out: a standby (``--standby``) that
    promotes when the primary's lease lapses, boots the doc from a scribe
    summary (``--scribe-dir``), serves ``/metrics`` (``--metrics-port``),
    runs the bounded-staleness writer (``--ckpt-stale-seconds``), writes a
    trace (``--trace``), and stops at ``--exit-after-rows``."""
    from fluidframework_tpu_torch.server.failover import LeaseFile
    from fluidframework_tpu_torch.server.fleet_main import main

    writers = _writers(server, "df", 2)
    a, b = writers
    a.insert_text(0, "hello fleet")
    _flush(server, "df", writers)
    topic = Topic("deltas", 1)
    with server.lock:
        for m in server.service.document("df").sequencer.log:
            topic.produce("df", PortMsg.from_json(m.to_json()))
    scribe = ScribeLambda(topic, str(tmp_path / "scribe"), config=ScribeConfig(max_ops=1),
                          device="cpu")
    scribe.pump()
    scribe.close()
    b.insert_text(0, ">")
    tail = _flush(server, "df", writers)
    lease_path = str(tmp_path / "lease.json")
    assert LeaseFile(lease_path, "primary", ttl_s=0.3).acquire()  # never renewed
    argv = ["--port", str(server.port), "--docs", "df", "--device", "cpu",
            "--max-insert-len", "16", "--capacity", "64", "--text-capacity", "512",
            "--standby", "--lease-file", lease_path, "--standby-poll", "0.05",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--scribe-dir", str(tmp_path / "scribe"),
            "--metrics-port", "0", "--trace", str(tmp_path / "trace.json"),
            "--ckpt-stale-seconds", "0.01", "--ckpt-sweep-interval", "0.01",
            "--exit-after-rows", str(tail)]
    result = []
    t = threading.Thread(target=lambda: result.append(main(argv)), daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and result == [0]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    keys = [next(iter(x)) for x in lines]
    for key in ("standby", "promoted", "bootedFromSummary", "metricsPort", "ready", "trace"):
        assert key in keys, (key, keys)
    done = next(x for x in lines if x.get("done"))
    assert done["texts"] == {"df": a.text} and done["errors"] == 0
    assert done["rows"] == tail and done["health"]["checkpointed_ops_skipped"] > 0
    assert done["health"]["standby_promotions"] == 1
    assert done["lease"]["lease_lost"] is False and "ckptWriter" in done
    trace = next(x for x in lines if "trace" in x)
    assert trace["events"] > 0 and os.path.getsize(tmp_path / "trace.json") > 0
    rec = LeaseFile(lease_path, "probe").read()
    assert rec["holder"].startswith("fleet-") and rec["expires"] == 0.0  # released
    with server.lock:
        last = server.service.document("df").sequencer.log[-1].seq
    assert CheckpointStore(str(tmp_path / "ckpt")).load("df")["seq"] == last


@pytest.mark.parametrize("family", ["string", "tree"])
def test_fleet_main_coordinated_drain_in_process(family, tmp_path, capsys):
    """``--drain-file``: once the file names each doc's target seq, the
    process pumps until every doc applied it, checkpoints, prints the final
    texts (``--family string``) or trees (``--family tree``) with
    ``drained`` and exits 0; the state equals an in-process engine's."""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.server.fleet_main import main

    from test_tree_batch_engine import drive_tree_docs

    if family == "string":
        docs = {"s0": _insert_lines(range(1, 9)), "s1": _insert_lines(range(1, 5), client="w1")}
        eng = DocBatchEngine(2, device="cpu", **GEOM)
    else:
        svc, _expected = drive_tree_docs(2, seed=8, steps=12)
        docs = {f"t{d}": [m.wire_line() for m in svc.document(f"doc{d}").sequencer.log]
                for d in range(2)}
        eng = TreeBatchEngine(2, device="cpu")
    for d, lines in enumerate(docs.values()):
        eng.ingest_lines(d, b"".join(lines))
    eng.step()
    want = {doc: json.loads(lines[-1])["sequenceNumber"] for doc, lines in docs.items()}
    shard = _StubShard(lambda doc, _f: b"".join(docs[doc]))
    drain = tmp_path / "drain.json"
    argv = ["--port", str(shard.port), "--docs", ",".join(docs), "--device", "cpu",
            "--family", family, "--max-insert-len", "8", "--capacity", "64",
            "--text-capacity", "512", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--drain-file", str(drain)]
    result = []
    t = threading.Thread(target=lambda: result.append(main(argv)), daemon=True)
    try:
        t.start()
        drain.write_text(json.dumps({"want": want}))
        t.join(timeout=120)
    finally:
        shard.close()
    assert not t.is_alive() and result == [0]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    done = lines[-1]
    assert done["done"] and done["drained"] and done["errors"] == 0
    if family == "string":
        assert done["texts"] == {doc: eng.text(d) for d, doc in enumerate(docs)}
    else:
        assert done["trees"] == {doc: eng.tree_json(d) for d, doc in enumerate(docs)}
    assert done["health"]["checkpoints_written"] == 2


# Each flag's run: 8 docs, doc 0 holding most of the traffic (48 appends
# against 2 for each other doc).
_FLAG_RUNS = {
    "--mesh": ["--mesh", "4"],
    "--seg-shards": ["--mesh", "4", "--seg-shards", "2"],
    # One doc a shard: the hot shard's only doc is the hotspot, so the
    # rebalance promotes it to a 2-shard lane, re-blocked every 8 ops.
    "--seg-rebalance-every": ["--mesh", "8", "--seg-shards", "2",
                              "--seg-rebalance-every", "8", "--rebalance-every", "1e-6"],
    "--spare-slots": ["--mesh", "4", "--spare-slots", "4"],
    # Doc 1 shares doc 0's hot shard: it migrates to a spare slot.
    "--rebalance-every": ["--mesh", "4", "--spare-slots", "4", "--rebalance-every", "1e-6"],
}


@pytest.mark.parametrize("flag,item", [
    ("--mesh", "item 8"), ("--seg-shards", "item 7"), ("--seg-rebalance-every", "item 7"),
    ("--spare-slots", "item 5"), ("--rebalance-every", "item 5"),
])
def test_fleet_main_refuses_unported_options(flag, item, capsys):
    """Each option once refused with its ROADMAP queue 1 item (``item``,
    now done) serves: a skewed 8-doc stream through ``main`` with the flag
    ends with texts equal to an in-process engine's, on the mesh the flag
    builds; the rebalance flags print their ``migrations`` line (a
    migration to a spare slot; a promotion, ``to == -1``, that re-blocks)."""
    from fluidframework_tpu_torch.server.fleet_main import main

    docs = {f"f{d}": _insert_lines(range(1, 49 if d == 0 else 3)) for d in range(8)}
    eng = DocBatchEngine(8, device="cpu", **GEOM)
    for d, lines in enumerate(docs.values()):
        eng.ingest_lines(d, b"".join(lines))
    eng.step()
    shard = _StubShard(lambda doc, _f: b"".join(docs[doc]))
    argv = ["--port", str(shard.port), "--docs", ",".join(docs), "--device", "cpu",
            "--max-insert-len", "8", "--capacity", "64", "--text-capacity", "512",
            "--ops-per-step", "8", "--exit-after-rows", str(48 + 7 * 2), *_FLAG_RUNS[flag]]
    try:
        assert main(argv) == 0, item
    finally:
        shard.close()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    done = lines[-1]
    assert done["done"] and done["errors"] == 0
    assert done["texts"] == {doc: eng.text(d) for d, doc in enumerate(docs)}
    health = done["health"]
    assert health["n_shards"] == int(_FLAG_RUNS[flag][1])
    assert health["segment_shards"] == (2 if "--seg-shards" in _FLAG_RUNS[flag] else 1)
    moves = [m for x in lines if "migrations" in x for m in x["migrations"]]
    if flag == "--rebalance-every":
        assert moves == [{"doc": "f1", "from": 0, "to": moves[0]["to"]}] and moves[0]["to"] > 0
        assert health["doc_migrations"] == 1
    elif flag == "--seg-rebalance-every":
        assert moves == [{"doc": "f0", "from": 0, "to": -1}]
        assert health["seg_promotions"] == 1 and health["seg_rebalances"] >= 1
    else:
        assert moves == []
