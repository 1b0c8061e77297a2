"""The port's capacity recovery against the JAX engine on the same streams.

The same SequencedMessage streams go into ``DocBatchEngine`` of both
packages at ``recovery="grow"`` (the default) or ``"oracle"``: the four
capacity-overflow sessions of tests/test_overflow_recovery.py (``CASES``),
a lane that overflows again, growth exhaustion, and ``recovery="off"``.
After every run the error vectors, texts, annotations, lane membership,
every raw state column of every batch row and overflow lane, the host
oracles' summaries and the health counters the port keeps must be equal
(tolerance 0: all int32).  The helpers here (``engines``, ``feed``,
``assert_engines_equal``) serve tests/test_torch_quarantine.py and
tests/test_torch_checkpoint.py too.

The reference engine runs without a mesh (``use_mesh=False``, as in
tests/test_torch_engine.py).  Every test runs two docs at one small
geometry (``BASE``) plus its case's capacity, so the reference programs
compile once per geometry and are shared across the tests of a file.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.ops import mergetree_kernel as rmk
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.ops import mergetree_kernel as tk

from test_engine_checkpoint import _ins, _join
from test_overflow_recovery import CASES, _healthy_session, _seg_overflow_session
from test_torch_mergetree_kernel import assert_states_equal

# Health names both engines keep, with the same meaning.
HEALTH_NAMES = (
    "quarantines", "poison_ops_dropped", "quarantine_replay_len",
    "capacity_recoveries", "oracle_routes", "recovery_replay_len",
    "readmissions", "auto_readmissions", "poison_routed_docs",
    "watchdog_checks", "watchdog_mismatches", "watchdog_prefiltered",
    "checkpoints_written", "checkpointed_ops_skipped", "docs_restored",
    "boot_replay_len", "quarantined_docs", "overflow_docs", "oracle_docs",
    "checkpoint_age_seqs", "retained_log_msgs", "quarantine_flaps",
    "readmits_scheduled", "dirty_docs", "recovery_incidents",
    "recovery_pending",
)


# The geometry every test starts from (a case overrides one axis).
BASE = dict(
    max_insert_len=8, ops_per_step=4, max_segments=32, text_capacity=256,
    remove_slots=2, prop_slots=2, ob_slots=2,
)


def engines(n_docs: int = 2, **kw) -> tuple[RefEngine, DocBatchEngine]:
    """The reference engine and the port's, with the same options."""
    kw = {**BASE, **kw}
    return RefEngine(n_docs, use_mesh=False, **kw), DocBatchEngine(n_docs, device="cpu", **kw)


def feed(engs, d: int, msgs) -> None:
    for eng in engs:
        for msg in msgs:
            eng.ingest(d, msg)


def assert_engines_equal(ref: RefEngine, port: DocBatchEngine, n_docs: int) -> None:
    """Everything observable, column by column."""
    np.testing.assert_array_equal(ref.errors()[:n_docs], port.errors())
    for lanes in ("overflow", "oracles", "quarantine"):
        assert sorted(getattr(port, lanes)) == sorted(getattr(ref, lanes)), lanes
    assert port.quarantine_reason == ref.quarantine_reason
    for d in range(n_docs):
        assert port.text(d) == ref.text(d), f"doc {d}"
        assert port.annotations(d) == ref.annotations(d), f"doc {d}"
        slot = int(ref._slot[d])
        assert_states_equal(
            jax.tree.map(lambda x: x[slot], ref.state), tk.doc_row(port.state, d),
            f"batch row {d}",
        )
        if d in ref.overflow:
            lane, got = ref.overflow[d], port.overflow[d]
            assert (got.geometry, got.growths) == (lane.geometry, lane.growths)
            assert_states_equal(lane.state, port.doc_state(d), f"lane {d}")
        for lanes in ("oracles", "quarantine"):
            if d in getattr(ref, lanes):
                assert (
                    getattr(port, lanes)[d].export_summary()
                    == getattr(ref, lanes)[d].export_summary()
                ), f"{lanes} {d}"
    assert_health_equal(ref, port)


def assert_health_equal(ref: RefEngine, port: DocBatchEngine) -> None:
    want, got = ref.health(), port.health()
    for name in HEALTH_NAMES:
        assert got.get(name) == want.get(name), name


def _overflow_pair(session, recovery, **geom):
    """The overflow session on doc 0 and a healthy session on doc 1, both
    engines, one step (recovery runs inside it)."""
    log, expected = session()
    h_log, h_text = _healthy_session()
    ref, port = engines(2, recovery=recovery, **geom)
    feed((ref, port), 0, log)
    feed((ref, port), 1, h_log)
    for eng in (ref, port):
        eng.step()
    return ref, port, expected, h_text


@pytest.mark.parametrize("recovery", ["grow", "oracle"])
@pytest.mark.parametrize("name,session,geom,bit", CASES, ids=[c[0] for c in CASES])
def test_overflow_recovers_like_reference(name, session, geom, bit, recovery):
    ref, port, expected, h_text = _overflow_pair(session, recovery, **geom)
    assert_engines_equal(ref, port, 2)
    assert not port.errors().any()
    assert (port.text(0), port.text(1)) == (expected, h_text)
    assert 0 in (port.overflow if recovery == "grow" else port.oracles)
    if recovery == "grow":
        assert port.health()["capacity_recoveries"] == 1


def test_growth_exhaustion_falls_back_to_oracle():
    ref, port, expected, _ = _overflow_pair(
        _seg_overflow_session, "grow", max_segments=4, max_growths=0
    )
    assert_engines_equal(ref, port, 2)
    assert 0 in port.oracles and port.text(0) == expected


def test_repeated_overflow_grows_the_lane_again():
    """A lane that overflows its grown geometry doubles again (growths 2),
    and keeps serving after it."""
    ref, port = engines(max_segments=4)
    feed((ref, port), 0, [_join("w0", 0)] + [_ins(s, 0, "ab") for s in range(1, 7)])
    for eng in (ref, port):
        eng.step()
    assert port.overflow[0].geometry["max_segments"] == 8
    feed((ref, port), 0, [_ins(s, 0, "cd") for s in range(7, 12)])
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, 2)
    lane = port.overflow[0]
    assert lane.growths == 2 and lane.geometry["max_segments"] == 16
    assert port.text(0) == "cd" * 5 + "ab" * 6


def test_recovery_off_latches_and_default_is_grow():
    assert DocBatchEngine(1, device="cpu").recovery == "grow"
    with pytest.raises(ValueError):
        DocBatchEngine(1, recovery="bogus", device="cpu")
    ref, port = engines(recovery="off", max_segments=4)
    log, _ = _seg_overflow_session()
    feed((ref, port), 0, log)
    for eng in (ref, port):
        eng.step()
        assert eng.watchdog() == []
    assert_engines_equal(ref, port, 2)
    assert port.errors()[0] & tk.ERR_SEG_OVERFLOW and not port.overflow


@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8, 16, 8 | 1, 8 | 16, 31])
def test_error_class_predicates_match_reference(bits):
    assert tk.ERR_CAPACITY_MASK == rmk.ERR_CAPACITY_MASK
    assert tk.is_capacity_error(bits) == rmk.is_capacity_error(bits)
    assert tk.is_poison_error(bits) == rmk.is_poison_error(bits)
