"""The port's placement plane, hot-shard rebalancing and live migration
against the JAX package, exact.

- ``PlacementPlane``: slots, capacity, ``docs_per_shard``, the per-shard
  free pools and a seeded run of ``reserve``/``commit``/``release`` equal
  the reference plane's over a grid of (docs, shards, spare slots).
- ``shard_load``/``hot_shards``/``rebalance_hot_shards`` on the port's
  engines over a 4-shard CPU mesh make the moves the reference's
  ``placement.rebalance_hot_shards`` makes on the same loads with a
  reference plane.
- String migration on a 4-shard CPU mesh: mid-stream (after a step, and
  with ops still staged) the fleet stays identical to a never-migrated
  control and to the reference engine; the migrated row equals the
  reference codec round trip (``state_to_summary`` -> ``summary_to_state``
  at batch geometry) of the reference's row; checkpoint records across a
  migration equal the reference's and restore.
- Tree migration: the same, through the trunk fold and re-materialization.

Reference engines run without a mesh (``use_mesh=False`` for strings): the
shard count changes no byte (``tests/test_multidevice.py``), and the
reference's multi-device CPU mesh is load-sensitive under tier-1's ``-n 6``.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from fluidframework_tpu.dds import kernel_backend as rkb
from fluidframework_tpu.models import placement as rplacement
from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefTreeEngine
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.dds import kernel_backend as tkb
from fluidframework_tpu_torch.models import placement
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.ops import tree_kernel as ttk
from fluidframework_tpu_torch.parallel.mesh import doc_mesh
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_engine_checkpoint import _ins, _join, _schedule
from test_torch_mergetree_kernel import assert_states_equal
from test_tree_batch_engine import drive_tree_docs

GEOM = dict(max_insert_len=8, ops_per_step=4, megastep_k=4, max_segments=64,
            text_capacity=512, remove_slots=4, prop_slots=2, ob_slots=4)


def _mesh4():
    return doc_mesh(["cpu"] * 4)


# ------------------------------------------------------------------ the plane

def _plane_view(plane) -> tuple:
    return (
        plane.capacity, plane.docs_per_shard, plane.slots.tolist(),
        {s: list(v) for s, v in plane._free_slots.items()},
    )


@pytest.mark.parametrize("n_docs,n_shards,spare", [
    (1, 1, 0), (5, 1, 3), (8, 4, 0), (6, 4, 3), (10, 4, 8), (13, 8, 5), (16, 8, 0),
])
def test_plane_matches_reference(n_docs, n_shards, spare):
    ref = rplacement.PlacementPlane(n_docs, n_shards, spare)
    port = placement.PlacementPlane(n_docs, n_shards, spare)
    assert _plane_view(port) == _plane_view(ref)
    rng = np.random.default_rng(n_docs * 31 + n_shards * 7 + spare)
    for _ in range(40):
        d = int(rng.integers(0, n_docs))
        dst = int(rng.integers(0, n_shards))
        got, want = port.reserve(d, dst), ref.reserve(d, dst)
        assert got == want
        if got is not None:
            if rng.random() < 0.7:
                port.commit(d, *got)
                ref.commit(d, *want)
            else:
                port.release(got[1])
                ref.release(want[1])
        assert _plane_view(port) == _plane_view(ref)
        assert [port.shard_of(i) for i in range(n_docs)] == [
            ref.shard_of(i) for i in range(n_docs)
        ]
        assert [port.free_slots(s) for s in range(n_shards)] == [
            ref.free_slots(s) for s in range(n_shards)
        ]
    keys = [f"k{i}" for i in range(n_docs)]
    assert port.placement(keys) == ref.placement(keys)
    for bad in ((0, n_shards), (n_docs, 0), (-1, 0)):
        with pytest.raises(ValueError):
            port.validate(*bad)
        with pytest.raises(ValueError):
            ref.validate(*bad)
    with pytest.raises(placement.PlacementError, match="segment"):
        port.require_migratable(0, "segment")
    port.require_migratable(0, None)
    for args in ((4, 0, 0), (4, 2, -1)):
        with pytest.raises(ValueError):
            placement.PlacementPlane(*args)


class _RefMirror:
    """The reference's ``rebalance_hot_shards`` skeleton driven on a port
    engine's loads: queue depths and applied-op counters copied from the
    engine, placement on a reference ``PlacementPlane``, and a
    ``migrate_doc`` that only moves the reference plane's slot."""

    def __init__(self, eng, spare_slots):
        self.n_docs, self.n_shards = eng.n_docs, eng.n_shards
        self.plane = rplacement.PlacementPlane(eng.n_docs, eng.n_shards, spare_slots)
        self.hosts = [SimpleNamespace(queue=[0] * len(h.queue)) for h in eng.hosts]
        self._shard_ops = eng._shard_ops.copy()
        self.counters = SimpleNamespace(bump=lambda name, n=1: None)

    def shard_of(self, d):
        return self.plane.shard_of(d)

    def shard_load(self):
        return rplacement.shard_load(self)

    def hot_shards(self, factor=2.0, reset=False, load=None):
        return rplacement.hot_shards(self, factor, reset, load)

    def migrate_doc(self, d, dst):
        res = self.plane.reserve(d, dst)
        if res is None:
            return False
        self.plane.commit(d, *res)
        return True


def _skewed_rows(eng, seed: int, n_rounds: int = 3):
    """Stage a skewed stream (no step): doc 0 the heaviest, doc 1 next,
    the rest a trickle."""
    rng = np.random.default_rng(seed)
    for d in range(eng.n_docs):
        eng.ingest(d, _join("w0", 0))
    seqs = [0] * eng.n_docs
    for _ in range(n_rounds):
        for d in range(eng.n_docs):
            n = 12 if d == 0 else 6 if d == 1 else int(rng.integers(1, 3))
            for _k in range(n):
                seqs[d] += 1
                eng.ingest(d, _ins(seqs[d], 0, "ab"))


@pytest.mark.parametrize("factor,max_moves", [(2.0, 1), (1.5, 2), (1.1, 3)])
def test_rebalance_moves_match_reference_plane(factor, max_moves):
    eng = DocBatchEngine(8, mesh=_mesh4(), spare_slots=4, **GEOM)
    _skewed_rows(eng, seed=int(factor * 10))
    for rnd in range(3):
        mirror = _RefMirror(eng, 4)
        mirror.plane._slot[:] = eng._slot
        mirror.plane._free_slots = {s: list(v) for s, v in eng.placement_plane._free_slots.items()}
        ops, depth = eng.shard_load()
        want_ops, want_depth = rplacement.shard_load(mirror)
        assert ops.tolist() == want_ops.tolist() and depth.tolist() == want_depth.tolist()
        assert eng.hot_shards(factor) == rplacement.hot_shards(mirror, factor)
        want = rplacement.rebalance_hot_shards(
            mirror, mirror.plane, factor, max_moves, in_lane=lambda _d: False
        )
        got = eng.rebalance_hot_shards(factor, max_moves)
        assert got == want, rnd
        assert eng._slot.tolist() == mirror.plane.slots.tolist()
        eng.step()
        _skewed_rows_more(eng, rnd)
    assert eng.counters.get("hot_shard_rebalances") >= 1
    assert not eng.errors().any()


def _skewed_rows_more(eng, rnd):
    for d in (0, 1):
        h = eng.hosts[d]
        for k in range(8 if d == 0 else 4):
            eng.ingest(d, _ins(h.last_seq + 1, 0, "cd"))


def test_tree_rebalance_moves_match_reference_plane():
    svc, expected = drive_tree_docs(8, seed=3, steps=24)
    eng = TreeBatchEngine(8, mesh=_mesh4(), spare_slots=4, megastep_k=4)
    logs = [svc.document(f"doc{d}").sequencer.log for d in range(8)]
    # Shard 0 holds docs 0 and 1: the hot shard; doc 0 is the hotspot,
    # doc 1 the move.
    for msg in logs[0]:
        eng.ingest(0, msg)
    for msg in logs[1][: len(logs[1]) // 3]:
        eng.ingest(1, msg)
    for d in range(2, 8):
        for msg in logs[d][:3]:
            eng.ingest(d, msg)
    mirror = _RefMirror(eng, 4)
    want = rplacement.rebalance_hot_shards(
        mirror, mirror.plane, 1.5, 2, in_lane=lambda d: d in eng.fallbacks
    )
    got = eng.rebalance_hot_shards(1.5, 2)
    assert got == want and got, got
    assert eng._slot.tolist() == mirror.plane.slots.tolist()
    for msg in logs[1][len(logs[1]) // 3:]:
        eng.ingest(1, msg)
    for d in range(2, 8):
        for msg in logs[d][3:]:
            eng.ingest(d, msg)
    eng.step()
    for d in range(8):
        if d not in eng.fallbacks:
            assert eng.values(d) == expected[d], d


# ------------------------------------------------------------ string migration

def _port_rows_equal(a, b, d, tag):
    """Doc d's raw row in two port engines, each read at its own slot."""
    for x, y in zip(tk.leaves(a.doc_state(d)), tk.leaves(b.doc_state(d))):
        assert np.array_equal(np.asarray(x), np.asarray(y)), tag


def _ref_codec_round_trip(ref: RefEngine, d: int):
    """The reference engine's row of doc d through the checkpoint codec,
    re-packed at the batch geometry (its migrate_doc handoff)."""
    h = ref.hosts[d]
    row = jax.tree.map(np.asarray, ref.doc_state(d))
    summary = rkb.state_to_summary(row, {v: k for k, v in h.prop_slot.items()})
    return rkb.summary_to_state(
        summary, ref.geometry, lambda p: ref._prop_slot_for_geom(h, p, ref.geometry)
    )


def test_string_midstream_migration_matches_control_and_reference():
    D = 8
    sched = _schedule(D, 12, seed=3)
    half = len(sched) // 2
    a = DocBatchEngine(D, mesh=_mesh4(), spare_slots=8, **GEOM)   # migrating
    b = DocBatchEngine(D, mesh=_mesh4(), spare_slots=8, **GEOM)   # control
    r = RefEngine(D, use_mesh=False, **GEOM)
    engines = (a, b, r)
    for eng in engines:
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
        for d, m, _p in sched[:half]:
            eng.ingest(d, m)
        eng.step()
    moved, staged = 2, 5
    dst = (a.shard_of(moved) + 3) % a.n_shards
    assert a.migrate_doc(moved, dst), "migration refused"
    assert a.shard_of(moved) == dst != b.shard_of(moved)
    assert_states_equal(_ref_codec_round_trip(r, moved), a.doc_state(moved), "migrated row")
    # The second half staged, then a move with the doc's rows still queued.
    for eng in engines:
        for d, m, _p in sched[half:]:
            eng.ingest(d, m)
    assert a.hosts[staged].queue
    assert a.migrate_doc(staged, (a.shard_of(staged) + 1) % a.n_shards)
    assert a.health()["doc_migrations"] == 2
    for eng in engines:
        eng.step()
        eng.compact()
        eng.step()
    assert not a.errors().any()
    for d in range(D):
        for other in (b, r):
            assert a.text(d) == other.text(d), d
            assert a.annotations(d) == other.annotations(d), d
        if d in (moved, staged):
            continue
        _port_rows_equal(a, b, d, f"doc {d} vs control")
        assert_states_equal(r.doc_state(d), a.doc_state(d), f"doc {d} vs reference")
    for d in (moved, staged):
        want = rkb.state_to_summary(jax.tree.map(np.asarray, r.doc_state(d)))
        assert tkb.state_to_summary(tk.to_numpy(a.doc_state(d))) == want, d
    # The vacated slots are pristine rows again, the landing slots left the
    # free pools.
    assert sum(a.free_slots(s) for s in range(4)) == a.capacity - D


def test_string_migration_checkpoints_continue(tmp_path):
    """Checkpoint records written before and after a migration equal the
    reference engine's, record for record, and restore into a fresh
    engine at another placement (no mesh) with the migrated doc intact."""
    D = 8
    keys = [f"doc{d}" for d in range(D)]
    sched = _schedule(D, 10, seed=11)
    half = len(sched) // 2
    a = DocBatchEngine(D, mesh=_mesh4(), spare_slots=4, doc_keys=keys,
                       checkpoint_store=CheckpointStore(str(tmp_path / "a")), **GEOM)
    r = RefEngine(D, use_mesh=False, doc_keys=keys,
                  checkpoint_store=RefStore(str(tmp_path / "r")), **GEOM)

    def records():
        out = []
        for k in keys:
            want, got = r.checkpoint_store.load(k), a.checkpoint_store.load(k)
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), k
            out.append(got["seq"])
        return out

    for eng in (a, r):
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
        for d, m, _p in sched[:half]:
            eng.ingest(d, m)
        eng.step()
        eng.maybe_checkpoint(force=True)
    first = records()
    moved = 3
    assert a.migrate_doc(moved, (a.shard_of(moved) + 2) % 4)
    for eng in (a, r):
        for d, m, _p in sched[half:]:
            eng.ingest(d, m)
        eng.step()
        eng.maybe_checkpoint(force=True)
    second = records()
    assert all(s2 > s1 for s1, s2 in zip(first, second))
    fresh = DocBatchEngine(D, doc_keys=keys, device="cpu",
                           checkpoint_store=CheckpointStore(str(tmp_path / "a")), **GEOM)
    rfresh = RefEngine(D, use_mesh=False, doc_keys=keys,
                       checkpoint_store=RefStore(str(tmp_path / "r")), **GEOM)
    assert fresh.restore_from_checkpoints() == rfresh.restore_from_checkpoints() == list(range(D))
    for d in range(D):
        assert fresh.text(d) == a.text(d) == r.text(d), d
        assert_states_equal(rfresh.doc_state(d), fresh.doc_state(d), f"restored doc {d}")


# ------------------------------------------------------------- tree migration

def _tree_rows_equal(a, b, d: int, tag: str) -> None:
    """Doc d's raw tree row in port engine a equals engine b's, at slots."""
    sa = int(a._slot[d])
    sb = int(b._slot[d])
    for name in ttk.NestedForestState._fields:
        x = getattr(a.state, name)[sa].numpy()
        y = np.asarray(getattr(b.state, name))[sb]
        if not isinstance(b, RefTreeEngine):
            y = getattr(b.state, name)[sb].numpy()
        assert np.array_equal(x, y), (tag, name)


def test_tree_midstream_migration_matches_control_and_reference():
    D = 6
    svc, expected = drive_tree_docs(D, seed=5, steps=24)
    logs = {d: list(svc.document(f"doc{d}").sequencer.log) for d in range(D)}
    a = TreeBatchEngine(D, mesh=_mesh4(), megastep_k=4, spare_slots=8)
    b = TreeBatchEngine(D, mesh=_mesh4(), megastep_k=4, spare_slots=8)
    r = RefTreeEngine(D, megastep_k=4)
    for eng in (a, b, r):
        for d in range(D):
            for msg in logs[d][: len(logs[d]) // 2]:
                eng.ingest(d, msg)
        eng.step()
    moved = next(d for d in range(D) if d not in a.fallbacks)
    src = a.shard_of(moved)
    dst = next(s for s in range(a.n_shards) if s != src and a.free_slots(s))
    assert a.migrate_doc(moved, dst), "migration refused"
    assert a.shard_of(moved) == dst != b.shard_of(moved)
    assert a.counters.get("doc_migrations") == 1
    for d in sorted(a.fallbacks)[:1]:
        with pytest.raises(placement.PlacementError):
            a.migrate_doc(d, (a.shard_of(d) + 1) % a.n_shards)
    for eng in (a, b, r):
        for d in range(D):
            for msg in logs[d][len(logs[d]) // 2:]:
                eng.ingest(d, msg)
        eng.step()
    assert not a.errors().any()
    assert a.errors().tolist() == np.asarray(r.errors()).tolist()
    for d in range(D):
        assert a.values(d) == expected[d], d
        assert json.dumps(a.tree_json(d), sort_keys=True) == json.dumps(
            b.tree_json(d), sort_keys=True) == json.dumps(r.tree_json(d), sort_keys=True), d
        if d == moved or d in a.fallbacks:
            continue
        _tree_rows_equal(a, b, d, "control")
        _tree_rows_equal(a, r, d, "reference")


def test_tree_migration_checkpoints_continue(tmp_path):
    D = 4
    keys = [f"doc{d}" for d in range(D)]
    svc, expected = drive_tree_docs(D, seed=1, steps=30)
    logs = {d: list(svc.document(keys[d]).sequencer.log) for d in range(D)}
    a = TreeBatchEngine(D, mesh=_mesh4(), spare_slots=8, doc_keys=keys,
                        checkpoint_store=CheckpointStore(str(tmp_path / "a")))
    r = RefTreeEngine(D, doc_keys=keys, checkpoint_store=RefStore(str(tmp_path / "r")))

    def records():
        for k in keys:
            got, want = a.checkpoint_store.load(k), r.checkpoint_store.load(k)
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), k

    for eng in (a, r):
        for d in range(D):
            for msg in logs[d][: len(logs[d]) // 2]:
                eng.ingest(d, msg)
        eng.step()
        eng.maybe_checkpoint(force=True)
    records()
    moved = next(d for d in range(D) if d not in a.fallbacks)
    assert a.migrate_doc(moved, (a.shard_of(moved) + 1) % 4)
    for eng in (a, r):
        for d in range(D):
            for msg in logs[d][len(logs[d]) // 2:]:
                eng.ingest(d, msg)
        eng.step()
        eng.maybe_checkpoint(force=True)
    records()
    fresh = TreeBatchEngine(D, doc_keys=keys, device="cpu",
                            checkpoint_store=CheckpointStore(str(tmp_path / "a")))
    assert fresh.restore_from_checkpoints() == list(range(D))
    fresh.step()
    for d in range(D):
        assert fresh.values(d) == a.values(d) == expected[d], d
