"""The port's loadgen traffic plant against the reference's.

The twin of ``tests/test_loadgen.py``:

- schedule determinism, JSON round trip and strict-subset interests, and
  the port's schedule JSON equal to the reference's, byte for byte, for
  the same seed, worker count and docs;
- the worker -> coordinator histogram shipping (wire round trip and a
  lossless merge), across the two packages as well;
- scoped presence on the port's fanout plane;
- one real smoke: ``run_loadgen(..., device="cpu")``, two worker OS
  processes over real TCP through the port's netserver and fleet
  processes, every phase barrier, the byte-identity verdict; the fleets'
  final texts and trees equal the REFERENCE's ``oracle_text`` /
  ``oracle_tree`` replays of the same sequenced logs (read back from the
  run's ``logs/`` directory), and no worker initialised CUDA.

The 3-seed matrix rides behind ``-m slow``, as in the reference.
"""

from __future__ import annotations

import json
import os

import pytest

from fluidframework_tpu.loadgen import coordinator as ref_coordinator
from fluidframework_tpu.loadgen.schedule import DocSpec as RefDocSpec
from fluidframework_tpu.loadgen.schedule import make_load_schedule as ref_make_load_schedule
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.utils.telemetry import Histogram as RefHistogram
from fluidframework_tpu_torch.fanout.plane import FanoutPlane
from fluidframework_tpu_torch.loadgen.coordinator import run_loadgen
from fluidframework_tpu_torch.loadgen.schedule import (
    DocSpec,
    LoadSchedule,
    make_load_schedule,
)
from fluidframework_tpu_torch.utils.telemetry import Histogram

_DOCS = (("string0", "string", 0), ("tree0", "tree", 0), ("map0", "map", 0))


def _docs(cls=DocSpec):
    return [cls(doc_id=d, family=f, shard=s) for d, f, s in _DOCS]


# ---------------------------------------------------------------- schedule
def test_schedule_same_seed_is_bit_identical():
    a = make_load_schedule(42, 4, _docs())
    b = make_load_schedule(42, 4, _docs())
    assert a.to_json() == b.to_json()
    c = make_load_schedule(43, 4, _docs())
    assert a.to_json() != c.to_json()


@pytest.mark.parametrize("seed,n_workers", [(42, 4), (7, 3), (11, 8), (17, 6)])
def test_schedule_json_equals_the_references(seed, n_workers):
    got = make_load_schedule(seed, n_workers, _docs(), ramp_ops=8, steady_ops=24, boots=6)
    want = ref_make_load_schedule(seed, n_workers, _docs(RefDocSpec), ramp_ops=8,
                                  steady_ops=24, boots=6)
    assert got.to_json() == want.to_json()


def test_schedule_json_roundtrip():
    sched = make_load_schedule(7, 3, _docs())
    back = LoadSchedule.from_json(sched.to_json())
    assert back.to_json() == sched.to_json()
    assert [w.seed for w in back.workers] == [w.seed for w in sched.workers]
    assert [d.doc_id for d in back.docs] == [d.doc_id for d in sched.docs]


def test_schedule_interests_are_strict_subsets():
    sched = make_load_schedule(11, 8, _docs())
    universe = set(sched.scopes)
    for w in sched.workers:
        interests = set(w.interests)
        assert interests, f"worker {w.worker_id} has no interests"
        assert interests < universe, f"worker {w.worker_id} subscribed to the whole universe"


# -------------------------------------------------------- histogram wire
def _parts():
    union = Histogram()
    parts = []
    for k in range(3):
        h = Histogram()
        for i in range(50):
            v = (k * 50 + i + 1) * 1e-4
            h.record(v)
            union.record(v)
        parts.append(h)
    return union, parts


def test_histogram_wire_roundtrip_and_merge_is_lossless():
    union, parts = _parts()
    merged = None
    for h in parts:
        wire = json.loads(json.dumps(h.to_wire()))  # the control socket
        got = Histogram.from_wire(wire)
        assert got.snapshot() == h.snapshot()
        merged = got if merged is None else merged.merge(got)
    assert merged.count == union.count == 150
    got, want = merged.snapshot(), union.snapshot()
    assert got.pop("sum") == pytest.approx(want.pop("sum"))
    assert got == want


def test_histogram_wire_is_the_references():
    """A port worker's wire form reads back in the reference's histogram
    (and the other way) to the same snapshot: the two packages bucket
    alike."""
    _union, parts = _parts()
    for h in parts:
        wire = json.loads(json.dumps(h.to_wire()))
        ref = RefHistogram.from_wire(wire)
        assert ref.snapshot() == h.snapshot()
        assert ref.to_wire() == h.to_wire()
        assert Histogram.from_wire(json.loads(json.dumps(ref.to_wire()))).snapshot() == h.snapshot()


def test_histogram_empty_wire_roundtrip():
    h = Histogram.from_wire(json.loads(json.dumps(Histogram().to_wire())))
    assert h.count == 0
    assert h.percentile(0.5) is None


# ------------------------------------------------------- scoped presence
def _signal_sink(plane):
    chunks = []
    peer = plane.new_peer(sink=chunks.append)
    return peer, chunks


def _drain_signals(plane, peer, chunks):
    plane.drain_virtual(peer)
    out = []
    for chunk in chunks:
        for line in bytes(chunk).splitlines():
            msg = json.loads(line)
            if msg.get("t") == "signal":
                out.append(msg["contents"])
    chunks.clear()
    return out


def test_scoped_presence_filters_by_interest_set():
    plane = FanoutPlane()
    cursor_peer, cursor_chunks = _signal_sink(plane)
    editor_peer, editor_chunks = _signal_sink(plane)
    firehose_peer, firehose_chunks = _signal_sink(plane)
    plane.add_signal_peer("d", cursor_peer, interests=["cursor"])
    plane.add_signal_peer("d", editor_peer, interests=["editor"])
    plane.add_signal_peer("d", firehose_peer)  # legacy unscoped firehose

    plane.publish_signal("d", "c1", {"scope": "cursor", "n": 1}, scope="cursor")
    assert _drain_signals(plane, cursor_peer, cursor_chunks) == [{"scope": "cursor", "n": 1}]
    assert _drain_signals(plane, editor_peer, editor_chunks) == []
    assert _drain_signals(plane, firehose_peer, firehose_chunks) == [{"scope": "cursor", "n": 1}]
    assert plane.stats()["presence_scope_drops"] == 1

    plane.publish_signal("d", "c1", {"n": 2})
    for peer, chunks in ((cursor_peer, cursor_chunks), (editor_peer, editor_chunks),
                         (firehose_peer, firehose_chunks)):
        assert _drain_signals(plane, peer, chunks) == [{"n": 2}]
    assert plane.stats()["presence_scope_drops"] == 1


def test_scoped_presence_interests_replace_in_place():
    plane = FanoutPlane()
    peer, chunks = _signal_sink(plane)
    plane.add_signal_peer("d", peer, interests=["cursor"])
    plane.publish_signal("d", "c1", {"n": 1}, scope="editor")
    assert _drain_signals(plane, peer, chunks) == []
    plane.add_signal_peer("d", peer, interests=["editor"])  # re-subscribe
    plane.publish_signal("d", "c1", {"n": 2}, scope="editor")
    assert _drain_signals(plane, peer, chunks) == [{"n": 2}]
    plane.publish_signal("d", "c1", {"n": 3}, scope="cursor")
    assert _drain_signals(plane, peer, chunks) == []
    assert plane.stats()["presence_scope_drops"] == 2


# --------------------------------------------------------------- the plant
def _assert_report_shape(report, n_workers):
    assert report["workers"] == n_workers and report["device"] == "cpu"
    for phase in ("ramp", "steady"):
        assert report["phases"][phase]["count"] > 0, report["phases"]
    assert report["convergence"]["verdict"] == "byte-identical"
    assert report["scribe"]["double_acks"] == 0
    assert report["client"]["ops_sequenced"] > 0
    assert report["presence"]["foreign"] == 0
    assert report["workers_cuda_initialized"] == {str(w): False for w in range(n_workers)}
    for fleet in report["server"]["fleets"]:
        assert fleet["device"] == "cpu", fleet


def _ref_log(workdir, doc_id):
    with open(os.path.join(workdir, "logs", f"{doc_id}.jsonl")) as f:
        return [RefMsg.from_json(line) for line in f]


def test_loadgen_smoke_two_workers_real_tcp(tmp_path):
    """2 worker processes over real TCP through the port's netserver and
    fleets on the CPU: every phase barrier, non-empty merged histograms,
    both fleet families byte-converged — against the port's oracles in the
    verdict and against the reference's oracle replays here."""
    workdir = str(tmp_path)
    report = run_loadgen(
        workdir, seed=1117, n_workers=2, n_shards=1,
        doc_matrix={"string": 1, "tree": 1, "map": 1},
        ramp_ops=3, steady_ops=8, boots=2, deadline_s=240.0, device="cpu",
    )
    _assert_report_shape(report, 2)
    conv = report["convergence"]["converged_docs"]
    assert conv["string"] == 1 and conv["tree"] == 1 and conv["map"] == 1
    assert report["boot_storm"]["cold"]["count"] > 0
    assert report["boot_storm"]["not_modified"]["count"] > 0
    assert report["boot_storm"]["historian"]["not_modified_304"] > 0
    assert report["presence"]["fanout_scope_drops"] > 0

    fleets = {f["family"]: f for f in report["server"]["fleets"]}
    assert set(fleets) == {"string", "tree"}
    log = _ref_log(workdir, "string0")
    assert any(m.type == "op" for m in log)
    assert fleets["string"]["states"] == {"string0": ref_coordinator.oracle_text(log)}
    want_tree = ref_coordinator.oracle_tree(_ref_log(workdir, "tree0"))
    assert json.dumps(fleets["tree"]["states"]["tree0"], sort_keys=True) == json.dumps(
        ref_coordinator._norm(want_tree), sort_keys=True)
    from fluidframework_tpu.loadgen.worker import oracle_map

    assert oracle_map(_ref_log(workdir, "map0"))  # the map doc took ops too


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3, 5])
def test_loadgen_matrix_three_seeds(tmp_path, seed):
    """Longer seeded matrix: 4 workers, 2 shards, every channel family."""
    report = run_loadgen(
        str(tmp_path), seed=seed, n_workers=4, n_shards=2,
        ramp_ops=6, steady_ops=18, boots=4, deadline_s=480.0, device="cpu",
    )
    _assert_report_shape(report, 4)
    conv = report["convergence"]["converged_docs"]
    for family in ("string", "tree", "map", "matrix", "chan_string"):
        assert conv[family] >= 1, f"{family} missing from convergence: {conv}"
