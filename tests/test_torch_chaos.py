"""The port's chaos controller and soak (``testing/chaos.py``) against the
JAX package's.

Arrival order over real sockets decides the sequencing, so the two
packages cannot be run to one identical log; the port is held to the
reference's invariants and to the reference's oracle instead:

- ``make_schedule`` writes the same JSON in both packages for several
  seeds, sizes and fault palettes, and the JSON round-trips;
- the port runs the reference's two tier-1 chaos smokes
  (``tests/test_chaos.py``: the string fleet under a nack storm, torn
  sockets and a fleet kill; the mixed string and tree fleet with warm
  standbys, a fleet kill and two live migrations) with their own
  schedules and assertions, on ``device="cpu"`` — ``n_shards == 8`` and a
  real ``doc_migrations`` included;
- the reference's fault-free oracles (``RefMergeTree`` for string docs, the
  EditManager + ``Forest`` replay for tree docs, run through the reference
  ``ChaosStack``'s own methods) replayed over the port's sequenced log
  (its wire JSON read back as reference messages) equal the port's fleet
  texts and tree JSON after a mixed chaos run on the native deli;
- the headline soak (seed 10, 240 ticks, 6 string and 3 tree docs, every
  fault kind twice, warm standbys, bounded-staleness checkpoints, the
  native deli) holds every invariant on the CPU; the reference's
  multi-seed soak runs too, marked ``slow`` as the reference marks it.

Tolerance: exact (texts, tree JSON, schedule JSON).
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import torch_twins as twins
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.testing import chaos as ref_chaos
from fluidframework_tpu_torch.testing import chaos as port_chaos

PORT_TESTS = twins.port_twin("test_chaos.py", subs=(
    ("churn_rate=0.1)", 'churn_rate=0.1, device="cpu")'),
    ("ckpt_stale_seconds=0.25)", 'ckpt_stale_seconds=0.25, device="cpu")'),
    ("events_per_kind=1)", 'events_per_kind=1, device="cpu")'),
))


@pytest.mark.parametrize("seed,ticks,per_kind", [(7, 40, 1), (10, 240, 2), (11, 40, 1),
                                                (16, 30, 1), (33, 120, 3)])
def test_schedule_json_matches_reference(seed, ticks, per_kind):
    docs = [f"cd{i}" for i in range(5)] + [f"td{i}" for i in range(3)]
    got = port_chaos.make_schedule(seed, ticks, docs, events_per_kind=per_kind)
    want = ref_chaos.make_schedule(seed, ticks, docs, events_per_kind=per_kind)
    assert got.to_json() == want.to_json()
    assert port_chaos.ChaosSchedule.from_json(want.to_json()).events == got.events
    kinds = port_chaos.EVENT_KINDS[:3]
    assert (port_chaos.make_schedule(seed, ticks, docs, kinds=kinds).to_json()
            == ref_chaos.make_schedule(seed, ticks, docs, kinds=kinds).to_json())


def test_reference_schedule_case_holds_in_the_port():
    PORT_TESTS.test_schedule_seeded_deterministic_and_round_trips()


def test_chaos_smoke_converges_byte_identical():
    PORT_TESTS.test_chaos_smoke_converges_byte_identical()


def test_chaos_mixed_fleet_converges_both_families():
    PORT_TESTS.test_chaos_mixed_fleet_converges_both_families()


def _ref_oracles(stack) -> tuple[dict, dict]:
    """The reference ``ChaosStack``'s oracles over the port stack's logs:
    each document's sequenced messages as wire JSON, read back as the
    reference's messages."""
    with stack.plane.nexus.lock:
        logs = {d: [RefMsg.from_json(m.to_json())
                    for m in stack.plane.service.document(d).sequencer.log]
                for d in stack.all_doc_ids}
    docs = {d: SimpleNamespace(sequencer=SimpleNamespace(log=log)) for d, log in logs.items()}
    shim = SimpleNamespace(plane=SimpleNamespace(
        nexus=stack.plane.nexus, service=SimpleNamespace(document=docs.__getitem__)))
    texts = {d: ref_chaos.ChaosStack.oracle_text(shim, d) for d in stack.doc_ids}
    trees = {d: ref_chaos.ChaosStack.oracle_tree_json(shim, d) for d in stack.tree_doc_ids}
    return texts, trees


def test_reference_oracle_over_the_ports_log(tmp_path):
    schedule = port_chaos.ChaosSchedule(seed=5, events=[
        port_chaos.ChaosEvent(4, "nack_storm", "cd1", 4),
        port_chaos.ChaosEvent(7, "migrate", "td0"),
        port_chaos.ChaosEvent(9, "torn_socket", "cd0"),
        port_chaos.ChaosEvent(12, "fleet_kill"),
        port_chaos.ChaosEvent(15, "scribe_crash", "", 3),
        port_chaos.ChaosEvent(18, "migrate", "td1"),
        port_chaos.ChaosEvent(20, "scribe_kill"),
    ])
    stack = port_chaos.ChaosStack(
        5, ["cd0", "cd1", "cd2"], str(tmp_path), tree_doc_ids=["td0", "td1"],
        standby=True, ckpt_stale_seconds=0.25, churn_rate=0.1, device="cpu",
        native_sequencer=True)
    try:
        for t in range(26):
            stack.tick(t, schedule)
        stack.quiesce()
        inv = stack.check_invariants()
        texts, trees = _ref_oracles(stack)
        assert {type(stack.plane.service.document(d).sequencer).__name__
                for d in stack.all_doc_ids} == {"NativeSequencer"}
        assert stack.counters["doc_migrations"] >= 1
        assert stack.counters["fleet_restarts"] == 1
        assert inv["converged_docs"] == 3 and inv["tree_converged_docs"] == 2
        assert sum(len(t) for t in texts.values()) > 0 and any(trees.values())
        for i, d in enumerate(stack.doc_ids):
            assert stack.engine.text(i) == texts[d], d
        for i, d in enumerate(stack.tree_doc_ids):
            assert stack.tree_engine.tree_json(i) == trees[d], d
    finally:
        stack.close()


def test_headline_soak_holds_on_the_cpu():
    """The soak ``chip_smoke.py`` phase 19 runs on the card, here on the
    CPU: the reference's ``bench.py --config soak`` size."""
    out = port_chaos.run_soak(
        seed=10, ticks=240, n_docs=6, n_tree_docs=3, events_per_kind=2,
        standby=True, ckpt_stale_seconds=0.25, churn_rate=0.08, device="cpu",
        native_sequencer=True)
    inv, c = out["invariants"], out["counters"]
    assert inv["converged_docs"] == 6 and inv["tree_converged_docs"] == 3
    assert inv["double_acks"] == 0
    assert inv["max_queue_depth"] <= inv["queue_depth_bound"]
    assert inv["max_tree_queue_depth"] <= inv["tree_queue_depth_bound"]
    assert set(out["events_by_kind"]) == set(port_chaos.EVENT_KINDS) | {"fsync_clear"}
    assert c["fleet_restarts"] == 2 and c["standby_promotions"] == 4
    assert c["scribe_kills"] == 2 and c["scribe_crashes"] >= 1
    assert c["doc_migrations"] + c["migrations_skipped"] == 2
    assert 0 < out["recovery_p99_ms"] <= inv["recovery_bound_ms"]
    assert 0 < out["tree_recovery_p99_ms"] <= inv["recovery_bound_ms"]
    assert out["devices"] == {"string": "cpu", "tree": "cpu"}
    assert out["sequencer"] == ["NativeSequencer"]
    assert out["max_rss_mb"] < out["rss_bound_mb"]
    assert 0 <= out["soak_rss_mb"] < out["rss_bound_mb"]
    json.dumps(out)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [10, 21, 33])
def test_soak_full_schedule_multi_seed(seed):
    PORT_TESTS.test_soak_full_schedule_multi_seed(seed)


def test_entry_points_refuse_a_silent_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    for call in (lambda: port_chaos.run_chaos(ticks=1),
                 lambda: port_chaos.run_soak(ticks=1),
                 lambda: port_chaos.ChaosStack(0, ["cd0"], str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
