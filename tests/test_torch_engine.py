"""The port's DocBatchEngine end to end against the JAX engine.

The same SequencedMessage streams go into ``DocBatchEngine(recovery=
"off")`` of both packages — messages minted by the JAX package's
``LocalService`` sequencer (multi-client SharedString sessions) and the
single-writer schedule of tests/test_megastep.py (obliterates included) —
through ingest -> staging ring -> megastep -> compact.  Texts,
annotations, the error vector and every raw state row must be equal.

The reference engine runs without a mesh (``use_mesh=False``): under
host load its CPU mesh path intermittently corrupts texts, latches
spurious ERR_POS_RANGE bits or aborts the process, while the mesh-less
path does not (see ROADMAP.md queue 3).  The geometries here are used by
no other test file, so these reference programs are never shared through
the persistent compile cache.
"""

from __future__ import annotations

import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.staging import OverloadGate, RowQueue

from test_doc_batch_engine import drive_docs
from test_engine_checkpoint import _join
from test_megastep import _schedule
from test_torch_mergetree_kernel import assert_states_equal


def _assert_engines_equal(ref: RefEngine, port: DocBatchEngine, n_docs: int) -> None:
    np.testing.assert_array_equal(ref.errors()[:n_docs], port.errors())
    for d in range(n_docs):
        assert port.text(d) == ref.text(d), f"doc {d}"
        assert port.annotations(d) == ref.annotations(d), f"doc {d}"
        assert_states_equal(ref.doc_state(d), port.doc_state(d), f"doc {d}")


def _run_schedule(cls, n_docs, sched, step_every=17, **kw):
    eng = cls(
        n_docs, remove_slots=4, max_insert_len=8, ops_per_step=4, megastep_k=4,
        max_segments=96, text_capacity=768, recovery="off", **kw,
    )
    for d in range(n_docs):
        eng.ingest(d, _join("w0", 0))
    for i, (d, msg) in enumerate(sched):
        eng.ingest(d, msg)
        if (i + 1) % step_every == 0:
            eng.step()
            if (i + 1) % (3 * step_every) == 0:
                eng.compact()
    eng.step()
    eng.compact()
    return eng


def test_engine_matches_reference_on_schedule():
    D = 8
    sched = _schedule(D, 16, seed=11, obliterate=True)
    ref = _run_schedule(RefEngine, D, sched, use_mesh=False)
    port = _run_schedule(DocBatchEngine, D, sched, device="cpu")
    _assert_engines_equal(ref, port, D)
    health = port.health()
    assert health["megastep_slices"] >= health["megastep_dispatches"] > 0
    # At most one device read of the obliterate gate per slice.
    assert 0 < health["ob_gate_syncs"] <= health["megastep_slices"]
    assert port.error_count() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_reference_on_local_service_stream(seed):
    D = 8
    svc, expected = drive_docs(D, seed)

    def run(cls, **kw):
        eng = cls(D, max_segments=192, text_capacity=3072, max_insert_len=8,
                  ops_per_step=4, recovery="off", **kw)
        for d in range(D):
            for msg in svc.document(f"doc{d}").sequencer.log:
                eng.ingest(d, msg)
        eng.step()
        eng.compact()
        return eng

    ref = run(RefEngine, use_mesh=False)
    port = run(DocBatchEngine, device="cpu")
    _assert_engines_equal(ref, port, D)
    assert [port.text(d) for d in range(D)] == [expected[d] for d in range(D)]


def test_engine_latches_errors_like_reference():
    """A capacity-busting insert and a poison insert latch the same bits
    (recovery is off in both: nothing is replayed)."""
    D = 4
    sched = _schedule(D, 6, seed=3, poison=(1, 2), big=(2, 3))
    ref = _run_schedule(RefEngine, D, sched, step_every=5, use_mesh=False)
    port = _run_schedule(DocBatchEngine, D, sched, step_every=5, device="cpu")
    _assert_engines_equal(ref, port, D)
    assert port.errors()[1] and port.error_count() >= 1


def test_unported_features_raise():
    """The options and methods this test once pinned as refused are ported:
    multi-shard segment lanes, spare slots, lane re-blocking, migration and
    engine-promoted segment lanes each take effect as the reference's do
    (their parity tests: tests/test_torch_placement.py,
    tests/test_torch_sharded_engine.py).  Boot-snapshot adoption is ported
    (tests/test_torch_failover.py): a record without a seq is refused as
    the reference refuses it."""
    for option, check in (
        ({"seg_shards": 2}, lambda e: (e.n_shards, e.seg_shards) == (2, 2)),
        ({"spare_slots": 4}, lambda e: (e.capacity, e.free_slots(0)) == (6, 4)),
        ({"seg_lane_segments": 64}, lambda e: e.seg_lane_segments == 64),
        ({"seg_rebalance_every": 8}, lambda e: e.seg_rebalance_every == 8),
    ):
        assert check(DocBatchEngine(2, device="cpu", **option)), option
    eng = DocBatchEngine(2, device="cpu", seg_shards=1)
    # One shard: a move to the doc's own shard is a quiet no-op, and an
    # engine without a segs axis promotes nothing.
    for method, args in (("migrate_doc", (0, 0)), ("enable_segment_sharding", (0,))):
        assert getattr(eng, method)(*args) is False
    with pytest.raises(KeyError):
        eng.adopt_boot_snapshot(0, {})


def test_engine_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DocBatchEngine(2)


def test_row_queue_and_overload_gate():
    q = RowQueue(8, 4)
    rows = [(np.full(8, i, np.int32), np.full(4, i, np.int32)) for i in range(40)]
    q.extend_rows(rows[:20])
    ops, _ = q.take(15)
    assert ops[:, 0].tolist() == list(range(15))
    q.extend_rows(rows[20:])  # reclaims the drained prefix or grows
    ops, pays = q.take(len(q))
    assert ops[:, 0].tolist() == list(range(15, 40)) and pays[-1, 0] == 39
    assert not q
    gate = OverloadGate(high=10, low=2)
    depth = {0: 12, 1: 3}
    assert gate.update([0, 1], depth.get) == ([0], [])
    depth[0] = 2
    assert gate.update([0, 1], depth.get) == ([], [0])
    with pytest.raises(ValueError):
        OverloadGate(high=2, low=2)
