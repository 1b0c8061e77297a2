"""The slice as a whole: network writers, launcher shards and fleet
consumers, in both packages, exact.

Each package brings up its own two launcher shards (its own netserver
processes).  Eight documents get four network writers each
(``SharedString`` over ``NetworkDeltaConnection``) that run four rounds of
``chip_smoke.py`` phase 2's mix (Zipf(1.1) over the docs, inserts and
removes of 2 characters), every submit waiting for its connection's sync
echo, so each shard sequences the ops in the order they were made.  One
``FleetConsumer`` a shard drains the firehose into that package's
``DocBatchEngine`` (the reference's on JAX's CPU, without a mesh; the
port's with ``device="cpu"``), stepping and compacting after each round.
The driver is phase 18's own code (``chip_smoke.net_fleet_run``), once as
it stands and once with its package imports pointed at the JAX package.

- The sequenced streams, read back over each shard's HTTP delta storage,
  are equal message by message as wire JSON, except the sequencer's
  ``timestamp``, which each shard process reads from its own clock.
- Every raw state column of every document, padding included, every
  error latch, text, annotation and health counter are equal
  (``test_torch_recovery.assert_engines_equal``).
- A second run promotes the busiest document onto a 2-shard segment lane
  of the port's engine after round 1 and demotes it at the end; its rows
  equal the port's own engine without lanes fed the same streams
  (``chip_smoke.net_fleet_replay``, which re-packs the demoted row), as
  phase 15's ``_sharded_hot`` holds its lane.  ``tests/
  test_torch_segment_lane.py`` holds the lane itself against the
  reference.
- Phase 18's client script (``_NetStringClients`` under
  ``_string_client_run``, four ``RefMergeTree`` clients at the 1,000
  edits the phase runs and at the leg's own 2,000) over each package's
  loader and netserver shards: the same actions, sequenced stream, text
  and channel summaries.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine  # noqa: E402
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine  # noqa: E402
from fluidframework_tpu_torch.native import ingest_native  # noqa: E402

import torch_twins as twins  # noqa: E402
from test_torch_recovery import assert_engines_equal  # noqa: E402

GEOM = dict(max_segments=64, text_capacity=512, max_insert_len=8, ops_per_step=8,
            remove_slots=2, prop_slots=2, ob_slots=2)
DOCS = [f"nd{d}" for d in range(8)]
WRITERS, ROUNDS, INS_LEN = 4, 4, 4


@pytest.fixture(scope="module", autouse=True)
def _native_encoder():
    ingest_native.warm()
    if not (ingest_native.loaded() and twins.reference_encoder_loaded()):
        pytest.skip("the native ingest encoder did not build (no g++)")


def _reference_smoke() -> types.ModuleType:
    """``chip_smoke.py`` with every port import pointed at the JAX package."""
    path = ROOT / "chip_smoke.py"
    src = re.sub(r"\bfluidframework_tpu_torch\b", "fluidframework_tpu", path.read_text())
    mod = types.ModuleType("chip_smoke_on_reference")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _counts():
    return chip_smoke.zipf_counts(len(DOCS), 4, 1.1)


def _run(smoke, root: str, make_engine, promote=None) -> tuple:
    """Phase 18's fleet driver on package ``root``'s own two launcher
    shards; returns the run, the engines and every doc's stream (wire JSON
    without the timestamp)."""
    launcher = importlib.import_module(f"{root}.server.launcher")
    dep = launcher.launch({"shards": [{"name": "s0"}, {"name": "s1"}]})
    try:
        by_shard = {s: [d for d in DOCS if launcher.shard_index(d, 2) == s] for s in range(2)}
        assert all(by_shard.values()), by_shard
        engines = {s: make_engine(s, docs) for s, docs in by_shard.items()}
        run = smoke.net_fleet_run(dep, DOCS, engines, WRITERS, ROUNDS, _counts(), INS_LEN,
                                  seed=5, promote=promote)
        streams = {d: smoke._net_stream(dep, d) for d in DOCS}
    finally:
        dep.stop()
    wire = {d: [{k: v for k, v in json.loads(m.to_json()).items() if k != "timestamp"}
                for m in msgs] for d, msgs in streams.items()}
    return run, engines, streams, wire


def test_network_fleet_matches_reference():
    ref_run, ref_engines, _, ref_wire = _run(
        _reference_smoke(), "fluidframework_tpu",
        lambda s, docs: RefEngine(len(docs), use_mesh=False, doc_keys=docs, **GEOM))
    run, engines, _, wire = _run(
        chip_smoke, "fluidframework_tpu_torch",
        lambda s, docs: DocBatchEngine(len(docs), device="cpu", doc_keys=docs, **GEOM))
    assert wire == ref_wire
    assert run["bounds"] == ref_run["bounds"] and run["ops"] == ref_run["ops"]
    assert run["rows"] == ref_run["rows"] and run["by_shard"] == ref_run["by_shard"]
    for d in DOCS:
        texts = run["writer_texts"][d]
        assert texts == ref_run["writer_texts"][d] and len(set(texts)) == 1
        assert run["texts"][d] == texts[0]
    for s, docs in run["by_shard"].items():
        assert_engines_equal(ref_engines[s], engines[s], len(docs))
    # Every doc took ops, and the head doc a round's worth each round.
    assert all(len(w) > WRITERS for w in wire.values())
    assert sum(run["rows"].values()) == ROUNDS * int(_counts().sum())


def test_segment_lane_matches_the_port_without_lanes():
    hot = DOCS[0]  # the Zipf head
    run, engines, streams, _ = _run(
        chip_smoke, "fluidframework_tpu_torch",
        lambda s, docs: DocBatchEngine(len(docs), device="cpu", doc_keys=docs,
                                       seg_shards=2 if hot in docs else 0, **GEOM),
        promote=(1, hot))
    (s,) = [s for s, docs in run["by_shard"].items() if hot in docs]
    docs, eng = run["by_shard"][s], engines[s]
    row = docs.index(hot)
    assert row in eng.seg_lanes and eng.health()["seg_promotions"] == 1
    assert eng.seg_lanes[row].n_shards == 2
    assert eng.disable_segment_sharding(row)
    plain = DocBatchEngine(len(docs), device="cpu", doc_keys=docs, **GEOM)
    chip_smoke.net_fleet_replay(plain, docs, list(range(len(docs))), streams, run["bounds"],
                                demote_at_end=[row])
    rows = list(range(len(docs)))
    assert chip_smoke._doc_rows_differ(eng, rows, plain, rows) == []
    assert [eng.text(r) for r in rows] == [plain.text(r) for r in rows]
    assert eng.text(row) == run["writer_texts"][hot][0]
    assert not np.asarray(eng.errors()).any()


def _net_client_script(smoke, root: str, n_edits: int, monkeypatch) -> dict:
    """Phase 18's client script (``chip_smoke._NetStringClients`` under
    ``_string_client_run``) with four ``RefMergeTree`` clients, on package
    ``root``'s own launcher shards."""
    monkeypatch.setattr(smoke, "STRING_CLIENT_KINDS", "oooo")
    launcher = importlib.import_module(f"{root}.server.launcher")
    dep = launcher.launch({"shards": [{"name": "s0"}, {"name": "s1"}]})
    taken: list = []
    try:
        fleet = smoke._NetStringClients("cpu", smoke.STRING_CLIENT_GEOM, dep,
                                        smoke.NET_CLIENT_DOC, summary_ops=100)
        try:
            run = smoke._string_client_run("cpu", smoke.STRING_CLIENT_GEOM, 0, n_edits, 6,
                                           sink=taken.append, fleet=fleet)
            summaries = fleet.summaries()
            acked = sum(m.acked for m in fleet.managers.values())
        finally:
            fleet.close()
    finally:
        dep.stop()
    return {"actions": json.dumps(taken), "stream": run["stream"], "text": run["text"],
            "summaries": summaries, "acked": acked, "reconnects": run["reconnects"],
            "rehydrated": run["rehydrated"]}


def test_network_client_script_runs_alike_in_both_packages(monkeypatch):
    """The client leg's script at the size the phase runs and at the leg's
    own 2,000 edits, over each package's loader, drivers and netserver
    shards: the same actions, the same sequenced stream (wire JSON,
    timestamps zeroed by the script), texts and channel summaries.  Unlike
    phase 16's script at some sizes, it meets no fault of the reference."""
    for n_edits in sorted({chip_smoke.NET_CLIENTS["n_edits"], 2000}):
        port = _net_client_script(chip_smoke, "fluidframework_tpu_torch", n_edits, monkeypatch)
        ref = _net_client_script(_reference_smoke(), "fluidframework_tpu", n_edits, monkeypatch)
        assert port == ref, n_edits
        assert port["acked"] > 0 and port["rehydrated"] == 1 and port["reconnects"] > 0
        assert len(set(port["summaries"])) == 1
