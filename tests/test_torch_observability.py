"""The port's observability plane: telemetry, flight recorder, metrics
plane, and the engines' spans, latency sampling and telemetry hooks.

Mirrors the engine-local cases of tests/test_observability.py: histogram
percentiles against numpy quantiles and merges, the recorder's ring
wraparound, span nesting, the no-op path, the Chrome trace schema, phase
totals and shares, Prometheus render and parse (and the HTTP server on
localhost), ``PerformanceEvent``, ``SampledTelemetryHelper.flush_all``,
``flush_telemetry``, latency gauges in ``health()`` (against the reference
engine's), and a fleet run's ``ingest`` -> ``upload`` -> ``dispatch`` ->
``readback`` spans.  Beyond the reference file: the checkpoint and restore
spans, the tree engine's host-fold spans, the rebase window's spans, the
long-document plane's, and ``health()`` leaving out the recompile gauges
the port cannot measure.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.observability import (
    FlightRecorder,
    MetricsPlane,
    MetricsServer,
    install,
    instant,
    parse_prometheus,
    phase_shares,
    phase_totals,
    recorder,
    render_prometheus,
    span,
    uninstall,
)
from fluidframework_tpu_torch.observability import flight_recorder
from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore
from fluidframework_tpu_torch.utils.telemetry import (
    Histogram,
    Logger,
    PerformanceEvent,
    SampledTelemetryHelper,
    create_child_logger,
)

from test_tree_batch_engine import drive_tree_docs

ENGINE = dict(max_segments=64, text_capacity=512, max_insert_len=8, ops_per_step=4)


@pytest.fixture(autouse=True)
def _no_global_recorder():
    """Every test starts and ends with no global recorder installed."""
    uninstall()
    yield
    uninstall()


# ------------------------------------------------------------------ Histogram

def test_histogram_empty_and_single_sample():
    h = Histogram()
    assert h.percentile(0.5) is None and h.snapshot() == {"count": 0}
    h.record(0.0042)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert h.percentile(q) == pytest.approx(0.0042)
    assert h.snapshot()["p99"] == pytest.approx(0.0042)


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_histogram_percentiles_vs_numpy(dist):
    rng = np.random.default_rng(7)
    if dist == "uniform":
        samples = rng.uniform(1e-5, 1e-1, size=5000)
    else:
        samples = np.exp(rng.normal(-7.0, 1.5, size=5000))
    h = Histogram()
    for v in samples:
        h.record(float(v))
    for q in (0.5, 0.9, 0.99):
        got, want = h.percentile(q), float(np.quantile(samples, q))
        assert want / h.growth <= got <= want * h.growth, (q, got, want)
    assert h.count == len(samples) and h.sum == pytest.approx(samples.sum(), rel=1e-9)
    assert h.min == pytest.approx(samples.min()) and h.max == pytest.approx(samples.max())


def test_histogram_merge_and_wire_round_trip():
    rng = np.random.default_rng(3)
    samples = rng.uniform(1e-6, 1e-2, size=2000)
    whole, a, b = Histogram(), Histogram(), Histogram()
    for v in samples:
        whole.record(float(v))
    for v in samples[:777]:
        a.record(float(v))
    for v in samples[777:]:
        b.record(float(v))
    a.merge(b)
    assert a.count == whole.count and a.sum == pytest.approx(whole.sum)
    for q in (0.5, 0.9, 0.99):
        assert a.percentile(q) == whole.percentile(q)
    back = Histogram.from_wire(json.loads(json.dumps(whole.to_wire())))
    assert back.snapshot() == whole.snapshot()
    with pytest.raises(ValueError, match="layouts"):
        a.merge(Histogram(growth=2.0))
    with pytest.raises(ValueError):
        a.percentile(1.5)


# ------------------------------------------------------------ flight recorder

def test_ring_wraparound():
    rec = FlightRecorder(capacity=8)
    for i in range(20):
        rec.instant(f"e{i}")
    assert len(rec) == 8 and rec.dropped == 12
    assert [e.name for e in rec.events()] == [f"e{i}" for i in range(12, 20)]
    ts = [e.ts_ns for e in rec.events()]
    assert ts == sorted(ts)
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_span_nesting_and_instants():
    rec = install(FlightRecorder())
    assert recorder() is rec
    with span("outer", k=1):
        with span("inner"):
            pass
        instant("mark", x=2)
    by_name = {e.name: e for e in rec.events()}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer.ph == "X" and outer.args == {"k": 1} and inner.args is None
    assert outer.ts_ns <= inner.ts_ns
    assert inner.ts_ns + inner.dur_ns <= outer.ts_ns + outer.dur_ns
    assert by_name["mark"].ph == "i" and by_name["mark"].args == {"x": 2}
    assert uninstall() is rec and recorder() is None


def test_noop_path_without_recorder():
    """No recorder: ``span`` hands out the one shared no-op span (one
    global read, no lock, no allocation of a recorder event) and
    ``instant`` does nothing."""
    assert span("free", a=1) is flight_recorder._NULL_SPAN
    with span("free"):
        instant("free2")
    rec = FlightRecorder()
    with span("still_free"):
        pass
    assert len(rec) == 0


def test_chrome_trace_schema(tmp_path):
    rec = FlightRecorder()
    with rec.span("phase_a", doc="d0"):
        pass
    rec.instant("recovery_complete", ms=1.5)
    path = tmp_path / "trace.json"
    assert rec.export_chrome_trace(str(path)) == 2
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms" and isinstance(doc["traceEvents"], list)
    for ev in doc["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        else:
            assert ev["ph"] == "i" and ev["s"] == "t"
    assert [e for e in doc["traceEvents"] if e["ph"] == "X"][0]["args"] == {"doc": "d0"}


def test_phase_totals_and_shares():
    rec = FlightRecorder()
    for name in ("a", "a", "b"):
        with rec.span(name):
            pass
    rec.instant("i")
    totals = phase_totals(rec.events())
    assert set(totals) == {"a", "b"} and totals["a"] >= 0
    assert sum(phase_shares(rec.events()).values()) == pytest.approx(1.0, abs=0.01)
    assert phase_shares([]) == {}


# --------------------------------------------------------------- metrics plane

def test_render_parse_round_trip():
    h = Histogram()
    for v in (0.001, 0.002, 0.004, 0.1):
        h.record(v)
    tree = {
        "engine": {"rows": 42, "ok": True, "shard_queue_depth": [3, 0, 7],
                   "label": "not-a-metric"},
        "latency": {"op_latency": h},
    }
    parsed = parse_prometheus(render_prometheus(tree))
    assert parsed[("fftpu_engine_rows", ())] == 42.0
    assert parsed[("fftpu_engine_ok", ())] == 1.0
    assert parsed[("fftpu_engine_shard_queue_depth", (("idx", "2"),))] == 7.0
    assert parsed[("fftpu_latency_op_latency_count", ())] == 4.0
    assert 0.001 <= parsed[("fftpu_latency_op_latency", (("quantile", "0.5"),))] <= 0.01
    assert not any("label" in name for name, _ in parsed)
    with pytest.raises(ValueError):
        parse_prometheus("not a metric line at all {")


def test_metrics_server_on_localhost():
    plane = MetricsPlane()
    plane.register("src", lambda: {"value": 5, "note": "text"})
    plane.register("bad", lambda: 1 / 0)
    srv = MetricsServer(plane, port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert parse_prometheus(text)[("fftpu_src_value", ())] == 5.0
        status = json.loads(urllib.request.urlopen(f"{base}/status", timeout=10).read())
        assert status["src"] == {"value": 5, "note": "text"}
        assert "scrape_error" in status["bad"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    finally:
        srv.stop()


# ------------------------------------------------------------------ telemetry

def test_performance_event_start_timestamp_and_cancel():
    import time as _time

    log = Logger()
    before = _time.time()
    with PerformanceEvent(log, "load", docId="d"):
        pass
    (e,) = log.matching(category="performance")
    assert e["eventName"] == "load_end" and e["duration"] >= 0
    assert before <= e["startTime"] <= _time.time()
    with pytest.raises(RuntimeError):
        with PerformanceEvent(log, "load"):
            raise RuntimeError("boom")
    (c,) = log.matching(category="error")
    assert c["eventName"] == "load_cancel" and c["startTime"] > 0


def test_child_logger_prefixes_and_inherits():
    seen = []
    root = Logger("fleet", sink=seen.append, properties={"host": "h"})
    child = create_child_logger(root, "engine", {"doc": "d0"})
    child.generic("step", n=1)
    assert seen == [{"host": "h", "doc": "d0", "eventName": "fleet:engine:step",
                     "category": "generic", "n": 1}]


def test_flush_all_drains_residual_buckets():
    log = Logger()
    h = SampledTelemetryHelper(log, "applyOp", sample_every=10)
    for _ in range(7):
        h.record(0.001, bucket="insert")
    for _ in range(3):
        h.record(0.002, bucket="remove")
    assert not log.matching(eventName="applyOp")
    assert h.flush_all() == 2
    events = log.matching(eventName="applyOp")
    assert {e["bucket"] for e in events} == {"insert", "remove"}
    assert sum(e["count"] for e in events) == 10
    assert h.flush_all() == 0


# --------------------------------------------------------------- the engines

def _feed(eng, n_docs: int, rounds: int) -> None:
    for d in range(n_docs):
        eng.ingest(d, SequencedMessage(
            seq=0, min_seq=0, ref_seq=0, client_id="w0", client_seq=0,
            type=MessageType.JOIN, contents={"clientId": "w0", "short": 0}))
    for seq in range(1, rounds + 1):
        eng.ingest_batch(list(range(n_docs)), [
            SequencedMessage(seq=seq, min_seq=0, ref_seq=seq - 1, client_id="w0",
                             client_seq=seq, type=MessageType.OP,
                             contents={"type": 0, "pos1": 0, "seg": "ab"})
            for _ in range(n_docs)])
        eng.step()


def test_engine_flush_telemetry():
    """A ``telemetry`` logger gets one ``engine_step`` event per 64 steps;
    ``flush_telemetry`` drains the tail, as the reference engine's."""
    events = {}
    for name, eng_cls, kw in (("ref", RefEngine, {"use_mesh": False}),
                              ("port", DocBatchEngine, {"device": "cpu"})):
        log = Logger()
        eng = eng_cls(1, recovery="off", telemetry=log, **ENGINE, **kw)
        _feed(eng, 1, 3)
        assert not log.matching(eventName="engine_step")
        eng.flush_telemetry()
        (e,) = log.matching(eventName="engine_step")
        events[name] = (e["bucket"], e["count"])
    assert events["port"] == events["ref"] == ("step", 3)


def test_latency_gauges_match_reference():
    """Every staged op sampled: the port's sample counts, per-doc
    histograms and gauge names equal the reference's; p99 >= p50 >= 0;
    the port leaves out the recompile gauges."""
    healths = {}
    for name, eng_cls, kw in (("ref", RefEngine, {"use_mesh": False}),
                              ("port", DocBatchEngine, {"device": "cpu"})):
        eng = eng_cls(2, recovery="off", latency_sample_every=1, **ENGINE, **kw)
        _feed(eng, 2, 4)
        h = healths[name] = eng.health()
        assert h["latency_samples"] == 8
        assert h["latency_p99_ms"] >= h["latency_p50_ms"] >= 0
        assert eng.latency_histograms()["op_latency"].count == 8
        assert eng.doc_latency(0).count == eng.doc_latency(1).count == 4
        assert eng.doc_latency(5) is None
    port = healths["port"]
    assert "recompiles" not in port and "despecializations" not in port
    assert "recompiles" in healths["ref"]
    assert set(healths["port"]) - set(healths["ref"]) <= {"ob_gate_syncs", "ops_staged"}
    every16 = DocBatchEngine(2, device="cpu", **ENGINE)
    _feed(every16, 2, 16)
    assert every16.health()["latency_samples"] == 2  # 32 ops / 16


def test_engine_spans_and_metrics_text():
    rec = install(FlightRecorder())
    eng = DocBatchEngine(2, device="cpu", recovery="grow", latency_sample_every=1, **ENGINE)
    _feed(eng, 2, 2)
    names = {e.name for e in rec.events()}
    assert {"ingest", "upload", "dispatch", "readback"} <= names
    reads = {e.args["kind"] for e in rec.events() if e.name == "readback"}
    assert reads == {"error_count"}  # no error latched: the vector is never read
    plane = MetricsPlane()
    plane.register("engine", eng.health)
    plane.register("latency", eng.latency_histograms)
    parsed = parse_prometheus(plane.metrics_text())
    assert parsed[("fftpu_engine_latency_samples", ())] > 0
    assert ("fftpu_engine_recompiles", ()) not in parsed
    assert parsed[("fftpu_latency_op_latency", (("quantile", "0.99"),))] > 0
    json.loads(plane.status_json())


def test_checkpoint_and_restore_spans(tmp_path):
    """A sweep, its writes, a restore's phases and the incident's close."""
    store = CheckpointStore(str(tmp_path))
    eng = DocBatchEngine(2, device="cpu", checkpoint_store=store, **ENGINE)
    _feed(eng, 2, 2)
    rec = install(FlightRecorder())
    assert eng.maybe_checkpoint(force=True) == [0, 1]
    assert eng.checkpoint_stale(max_ops_behind=1) == []
    fresh = DocBatchEngine(2, device="cpu", checkpoint_store=store, **ENGINE)
    assert fresh.restore_from_checkpoints() == [0, 1]
    _feed(fresh, 2, 3)
    names = [e.name for e in rec.events()]
    for name in ("checkpoint_sweep", "checkpoint", "restore_scan", "restore_load",
                 "restore_build", "restore_scatter", "recovery_complete"):
        assert name in names, name
    assert names.count("checkpoint") == 2
    assert {e.args["lane"] for e in rec.events() if e.name == "checkpoint"} == {"batch"}


def test_quarantine_reports_to_the_logger():
    log = Logger()
    eng = DocBatchEngine(1, device="cpu", telemetry=log, **ENGINE)
    _feed(eng, 1, 1)
    eng.ingest(0, SequencedMessage(seq=2, min_seq=0, ref_seq=1, client_id="ghost",
                                   client_seq=2, contents={"type": 0, "pos1": 0, "seg": "x"}))
    assert 0 in eng.quarantine
    (q,) = log.matching(eventName="doc_quarantined")
    assert q["category"] == "error" and q["doc"] == "0"
    assert log.matching(eventName="poison_op_dropped")


def test_tree_engine_spans_and_telemetry():
    svc, expected = drive_tree_docs(2, seed=1, steps=12)
    log = Logger()
    rec = install(FlightRecorder())
    eng = TreeBatchEngine(2, device="cpu", telemetry=log)
    for d in range(2):
        for msg in svc.document(f"doc{d}").sequencer.log:
            eng.ingest(d, msg)
    eng.step()
    assert [eng.values(d) for d in range(2)] == [expected[0], expected[1]]
    names = {e.name for e in rec.events()}
    assert {"host_fold_mark_alloc", "host_fold_rebase", "host_fold_translate",
            "upload", "dispatch", "readback"} <= names
    assert eng.counters.logger is log
    assert "recompiles" not in eng.health()


def test_rebase_window_spans():
    svc, expected = drive_tree_docs(2, seed=3, steps=12)
    rec = install(FlightRecorder())
    eng = TreeBatchEngine(2, device="cpu", device_rebase=True)
    for d in range(2):
        for msg in svc.document(f"doc{d}").sequencer.log:
            eng.ingest(d, msg)
    eng.step()
    assert [eng.values(d) for d in range(2)] == [expected[0], expected[1]]
    windows = eng.health()["rebase_windows"]
    assert windows > 0
    counts = {n: sum(e.name == n for e in rec.events())
              for n in ("rebase_kernel_encode", "rebase_kernel_dispatch", "rebase_kernel_decode")}
    assert counts["rebase_kernel_dispatch"] == counts["rebase_kernel_decode"] == windows
    assert counts["rebase_kernel_encode"] >= windows


def test_long_doc_plane_spans():
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.parallel.long_doc import make_sharded_ops, shard_doc_state
    from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh

    mesh = docs_segs_mesh("cpu")
    state = shard_doc_state(mk.init_state(16, 2, 2, 64, 2, device="cpu"), mesh)
    vis, resolve, mark = make_sharded_ops(mesh, state)
    rec = install(FlightRecorder())
    assert int(vis(state, 0, 0)) == 0
    resolve(state, torch.zeros(2, dtype=torch.int32), 0, 0)
    mark(state, 0, 0, 1, 0, 0, 0)
    ops = [e.args["op"] for e in rec.events() if e.name == "seg_collective"]
    assert ops == ["visible_length", "resolve", "mark_range"]
