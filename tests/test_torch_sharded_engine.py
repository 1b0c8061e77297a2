"""The port's engine-promoted segment lanes and cohort steps against the JAX
package, exact.

- Segment lanes (``seg_shards > 1``): a doc promoted mid-stream, served on
  its lane (K6 over the stacked shards, K1 inside), compacted, re-blocked
  (``rebalance_segments`` and ``seg_rebalance_every``) and demoted stays
  identical to the reference engine serving it in the batch (the lane's
  gathered document equals the reference row's live content, and after
  demotion its summary does); every other doc's raw row equals the
  reference's; the lane's n replicas agree after every step.  A lane doc
  refuses migration with ``PlacementError``; ``rebalance_hot_shards``
  promotes a doc that is itself the hotspot (a move to ``-1``).
- Cohort steps (``use_mesh=False``): Zipf traffic through the port and the
  reference engine, both bucketing: equal ``full_steps``, ``cohort_steps``
  and ``cohort_lanes``, equal rows; the gather/scatter pair equals the
  reference's jitted pair, pad lanes dropped.

Reference engines run with ``use_mesh=False``: the shard count changes no
byte, and the reference's multi-device CPU mesh is load-sensitive under
tier-1's ``-n 6``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.dds import kernel_backend as rkb
from fluidframework_tpu.models import doc_batch_engine as rdbe
from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.protocol.messages import MessageType, SequencedMessage
from fluidframework_tpu_torch.dds import kernel_backend as tkb
from fluidframework_tpu_torch.models import doc_batch_engine as tdbe
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.placement import PlacementError
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh

from test_engine_checkpoint import _ins, _join
from test_megastep import _schedule
from test_torch_mergetree_kernel import _fleets, assert_states_equal

GEOM = dict(max_insert_len=8, ops_per_step=4, megastep_k=4, max_segments=128,
            text_capacity=1024, remove_slots=4, prop_slots=2, ob_slots=8)


def _feed(engines, msgs):
    for eng in engines:
        for d, m in msgs:
            eng.ingest(d, m)


def _canonical_equal(ref_row, port_doc, tag):
    a = tk.canonical_doc(tk.from_numpy(jax.tree.map(np.asarray, ref_row), device="cpu"))
    b = tk.canonical_doc(port_doc)
    assert a.keys() == b.keys()
    assert [k for k in a if not np.array_equal(a[k], b[k])] == [], tag


def _assert_fleet(ref, port, D, tag):
    """Texts and annotations of every doc equal; batch docs' raw rows equal
    at their slots; a lane doc's gathered document equals the reference
    row's live content, its n replicas agreeing."""
    assert not port.errors().any() and not np.asarray(ref.errors()).any(), tag
    for d in range(D):
        assert port.text(d) == ref.text(d), (tag, d)
        assert port.annotations(d) == ref.annotations(d), (tag, d)
        if d in port.seg_lanes:
            assert tk.seg_replica_mismatch(port.seg_lanes[d].state) == [], (tag, d)
            _canonical_equal(ref.doc_state(d), port.doc_state(d), f"{tag} lane {d}")
        else:
            assert_states_equal(ref.doc_state(d), port.doc_state(d), f"{tag} doc {d}")


@pytest.mark.parametrize("n_seg", [2, 4])
def test_segment_lane_lifecycle_matches_reference(n_seg):
    D = 4
    sched = _schedule(D, 24, seed=n_seg, obliterate=True)
    thirds = [sched[: len(sched) // 3], sched[len(sched) // 3 : 2 * len(sched) // 3],
              sched[2 * len(sched) // 3 :]]
    ref = RefEngine(D, use_mesh=False, **GEOM)
    port = DocBatchEngine(D, device="cpu", seg_shards=n_seg, seg_rebalance_every=4, **GEOM)
    assert (port.n_shards, port.seg_shards) == (n_seg, n_seg)
    for eng in (ref, port):
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
    _feed((ref, port), thirds[0])
    ref.step()
    port.step()
    _assert_fleet(ref, port, D, "before promotion")
    # Promote mid-stream, with doc 0's next rows already staged.
    _feed((ref, port), thirds[1][:8])
    assert port.enable_segment_sharding(0)
    assert not port.enable_segment_sharding(0)  # already on its lane
    assert port.segment_sharded() == {"0": n_seg}
    slot = int(port._slot[0])
    assert_states_equal(jax.tree.map(np.asarray, port._proto), tk.doc_row(port.state, slot),
                        "reserved slot")
    _feed((ref, port), thirds[1][8:])
    for eng in (ref, port):
        eng.step()
        eng.compact()
    _assert_fleet(ref, port, D, "on the lane")
    h = port.health()
    assert h["segment_shards"] == n_seg and h["segment_sharded_docs"] == 1
    assert len(h["seg_occupancy"]) == n_seg
    assert sum(h["seg_occupancy"]) == int(port.doc_state(0).nseg)
    assert h["seg_rebalances"] >= 1 and h["seg_lane_rebalances"] == h["seg_rebalances"]
    assert port.rebalance_segments(0)
    assert port.watchdog(sample=D) == []
    _feed((ref, port), thirds[2][: len(thirds[2]) // 2])
    for eng in (ref, port):
        eng.step()
    _assert_fleet(ref, port, D, "after re-blocking")
    assert port.disable_segment_sharding(0)
    assert port.segment_sharded() == {}
    assert port.health()["seg_occupancy"] == [0] * n_seg
    _feed((ref, port), thirds[2][len(thirds[2]) // 2 :])
    for eng in (ref, port):
        eng.step()
        eng.compact()
    for d in range(D):
        assert port.text(d) == ref.text(d), d
        want = rkb.state_to_summary(jax.tree.map(np.asarray, ref.doc_state(d)))
        assert tkb.state_to_summary(tk.to_numpy(port.doc_state(d))) == want, d
        if d:
            assert_states_equal(ref.doc_state(d), port.doc_state(d), f"demoted doc {d}")
    assert port.health()["seg_demotions"] == 1


def test_segment_lane_checkpoints_as_a_batch_record(tmp_path):
    """A lane doc checkpoints through the codec as the reference's batch
    row does (same record) and restores into the batch."""
    from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    D = 2
    sched = _schedule(D, 16, seed=9)
    ref = RefEngine(D, use_mesh=False, checkpoint_store=RefStore(str(tmp_path / "r")), **GEOM)
    port = DocBatchEngine(D, device="cpu", seg_shards=2,
                          checkpoint_store=CheckpointStore(str(tmp_path / "p")), **GEOM)
    for eng in (ref, port):
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
    _feed((ref, port), sched[:20])
    for eng in (ref, port):
        eng.step()
    assert port.enable_segment_sharding(1)
    _feed((ref, port), sched[20:])
    for eng in (ref, port):
        eng.step()
        eng.maybe_checkpoint(force=True)
    for k in ("0", "1"):
        assert port.checkpoint_store.load(k) == ref.checkpoint_store.load(k), k
    fresh = DocBatchEngine(D, device="cpu", checkpoint_store=port.checkpoint_store, **GEOM)
    assert fresh.restore_from_checkpoints() == [0, 1]
    assert [fresh.text(d) for d in range(D)] == [ref.text(d) for d in range(D)]


def _viral(eng, doc: int, n: int) -> None:
    msgs = [
        SequencedMessage(
            seq=i + 1, min_seq=0, ref_seq=i, client_id="w0", client_seq=i,
            type=MessageType.OP, contents={"type": 0, "pos1": 0, "seg": "ab"},
        )
        for i in range(n)
    ]
    eng.ingest_batch([doc] * n, msgs)


def test_hot_doc_auto_promotes_like_reference():
    """``rebalance_hot_shards`` promotes a doc whose own queue is the
    hotspot (one doc a shard: no cold doc to migrate off its shard)."""
    D = 4
    mesh = docs_segs_mesh(["cpu"] * 8, seg_shards=4)
    port = DocBatchEngine(D, mesh=mesh, max_segments=256, text_capacity=8192,
                          max_insert_len=8, ops_per_step=8)
    ref = RefEngine(D, use_mesh=False, max_segments=256, text_capacity=8192,
                    max_insert_len=8, ops_per_step=8)
    assert port.n_shards == 8 and port.seg_shards == 4
    for eng in (ref, port):
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
        _viral(eng, 0, 64)
    moves = port.rebalance_hot_shards(factor=2.0)
    assert moves == [(0, 0, -1)]
    assert 0 in port.seg_lanes and port.health()["hot_shard_moves_skipped"] == 1
    for eng in (ref, port):
        eng.step()
    assert port.text(0) == ref.text(0) == "ab" * 64
    _assert_fleet(ref, port, D, "auto-promoted")


def test_lane_doc_refuses_migration():
    port = DocBatchEngine(4, device="cpu", seg_shards=2, spare_slots=4, **GEOM)
    port.ingest(0, _join("w0", 0))
    port.ingest(0, _ins(1, 0, "hello"))
    port.step()
    assert port.enable_segment_sharding(0)
    with pytest.raises(PlacementError, match="segment"):
        port.migrate_doc(0, 1)
    assert port.disable_segment_sharding(0)
    assert port.migrate_doc(0, 1) and port.shard_of(0) == 1
    assert port.text(0) == "hello"


# ------------------------------------------------------------------ cohorts

def _zipf_stream(D: int, rounds: int, seed: int):
    """Per round, doc d gets about 24 / (d + 1) single-writer appends (doc 0
    the head, the tail one op): a busy set that shrinks into cohorts."""
    rng = np.random.default_rng(seed)
    seqs, lengths = [0] * D, [0] * D
    out = []
    for _r in range(rounds):
        for d in range(D):
            for _k in range(max(1, round(24 / (d + 1) ** 1.1))):
                seqs[d] += 1
                pos = int(rng.integers(0, lengths[d] + 1))
                out.append((d, _ins(seqs[d], pos, "xy")))
                lengths[d] += 2
    return out


@pytest.mark.parametrize("megastep_k", [1, 4])
def test_cohort_steps_match_reference(megastep_k):
    D = 16
    geom = dict(GEOM, megastep_k=megastep_k, max_segments=256, text_capacity=2048)
    ref = RefEngine(D, use_mesh=False, **geom)
    port = DocBatchEngine(D, device="cpu", use_mesh=False, **geom)
    meshed = DocBatchEngine(D, device="cpu", **geom)  # the default: no buckets
    assert port.bucketing and port.mesh is None and not meshed.bucketing
    for eng in (ref, port, meshed):
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
    stream = _zipf_stream(D, 3, seed=megastep_k)
    for r in range(3):
        chunk = stream[r * len(stream) // 3 : (r + 1) * len(stream) // 3]
        _feed((ref, port, meshed), chunk)
        for eng in (ref, port, meshed):
            eng.step()
    assert port.cohort_steps > 0 and meshed.cohort_steps == 0
    assert (port.full_steps, port.cohort_steps, port.cohort_lanes) == (
        ref.full_steps, ref.cohort_steps, ref.cohort_lanes)
    hp, hr = port.health(), ref.health()
    for k in ("megastep_dispatches", "megastep_slices"):
        assert hp[k] == hr[k], k
    _assert_fleet(ref, port, D, "cohort")
    _assert_fleet(ref, meshed, D, "fleet-wide")


def test_cohort_gather_scatter_match_reference():
    """The pair on a small fleet: the gathered rows equal the reference's
    ``_gather_cohort_jit``; a scatter with pad lanes equals its
    ``_scatter_cohort_jit`` (``mode="drop"``): each slot written once."""
    ref, port = _fleets(8, 16, 2, 2, 64, 2)
    rng = np.random.default_rng(5)
    ref = jax.tree.map(lambda x: jnp.asarray(rng.integers(-5, 50, x.shape, dtype=np.int32)), ref)
    port = tk.from_numpy(jax.tree.map(np.asarray, ref), device="cpu")
    idx = np.array([6, 1, 3, 3, 3, 3, 3, 3], np.int64)  # 3 busy, 5 pad lanes
    valid = np.array([1, 1, 1, 0, 0, 0, 0, 0], bool)
    sub_ref = rdbe._gather_cohort_jit(ref, jnp.asarray(idx, jnp.int32))
    sub_port = tdbe.gather_cohort(port, idx)
    assert_states_equal(sub_ref, sub_port, "gather")
    sub_ref = jax.tree.map(lambda x: x + 1000, sub_ref)
    sub_port = tk.tree_map(lambda x: x + 1000, sub_port)
    out_ref = rdbe._scatter_cohort_jit(ref, sub_ref, jnp.asarray(idx, jnp.int32),
                                       jnp.asarray(valid))
    out_port = tdbe.scatter_cohort(port, sub_port, idx, valid)
    assert_states_equal(out_ref, out_port, "scatter")
