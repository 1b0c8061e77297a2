"""The port's TreeBatchEngine against the JAX package's, exact.

The reference engine tests' seeded SharedTree sessions (``drive_tree_docs``,
``drive_nested_docs`` — flat, nested, deep-path and mixed-value streams —
and the optional-field stream) are ingested message for message by both
engines on the CPU; after ``step`` they must agree on every raw device
column of every doc (int32, padding remnants included), ``tree_json``
(type-strict), ``values``, ``device_fraction``, the fallback set and the
health counters both keep.  Compaction under churn, checkpoint store
directories (byte-identical after each step) and restore across the two
packages in both directions are held the same way.  The per-row emit
translation (``plan_cache=False``) is held to the reference's, and to the
port's own plan cache byte for byte, through ingest, restore and a
migration on a 2-shard CPU mesh.  The reference engines run without a
mesh unless a test migrates.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import pytest

from fluidframework_tpu.dds.channels import default_registry
from fluidframework_tpu.dds.tree.changeset import (
    NodeChange,
    make_insert,
    make_optional_edit,
    make_optional_set,
    make_remove,
    make_set_value,
)
from fluidframework_tpu.dds.tree.forest import Node
from fluidframework_tpu.dds.tree.schema import leaf
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefEngine
from fluidframework_tpu.runtime import ContainerRuntime
from fluidframework_tpu.server.local_service import LocalService
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_tree_batch_engine import drive_nested_docs, drive_tree_docs

# Gauges whose values are timing- or implementation-dependent: the staging
# ring's overlap count, the age of the oldest dirty doc and the recovery
# clock's times.
_HEALTH_SKIP = {"staging_overlap_packs", "checkpoint_age_s", "recovery_p50_ms",
                "recovery_p99_ms", "last_recovery_ms"}


def _logs(svc, n_docs):
    return [svc.document(f"doc{d}").sequencer.log for d in range(n_docs)]


def _feed(eng, logs, step=True):
    for d, log in enumerate(logs):
        for msg in log:
            eng.ingest(d, msg)
    if step:
        eng.step()
    return eng


def _pair(logs, **kw):
    n = len(logs)
    return _feed(RefEngine(n, **kw), logs), _feed(TreeBatchEngine(n, device="cpu", **kw), logs)


def _json(x) -> str:
    return json.dumps(x, sort_keys=True)


def assert_engines_equal(ref: RefEngine, port: TreeBatchEngine, raw: bool = True) -> None:
    n = ref.n_docs
    for d in range(n):
        if raw:
            slot, port_slot = int(ref._slot[d]), int(port._slot[d])
            for name in tk.NestedForestState._fields:
                a = np.asarray(getattr(ref.state, name))[slot]
                b = getattr(port.state, name)[port_slot].numpy()
                assert a.dtype == b.dtype == np.int32, (d, name)
                assert np.array_equal(a, b), (d, name)
        assert _json(port.tree_json(d)) == _json(ref.tree_json(d)), d
        assert _json(port.values(d)) == _json(ref.values(d)), d
        assert _json(port.hosts[d].em.summarize()) == _json(ref.hosts[d].em.summarize()), d
    assert sorted(port.fallbacks) == sorted(ref.fallbacks)
    assert port.device_fraction() == ref.device_fraction()
    assert port.errors().tolist() == np.asarray(ref.errors()).tolist()
    hr, hp = ref.health(), port.health()
    common = (set(hr) & set(hp)) - _HEALTH_SKIP
    assert {k: hp[k] for k in common} == {k: hr[k] for k in common}


STREAMS = {
    "flat": lambda: drive_tree_docs(4, seed=1),
    "flat_nested": lambda: drive_tree_docs(4, seed=7, nested_prob=2.0),
    "nested": lambda: drive_nested_docs(4, seed=11, steps=30),
    "deep": lambda: drive_nested_docs(4, seed=23, steps=30, deep_prob=0.6),
    "mixed": lambda: drive_nested_docs(4, seed=19, steps=30, mixed=True),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_engine_matches_reference(stream):
    svc, expected = STREAMS[stream]()
    ref, port = _pair(_logs(svc, 4))
    assert_engines_equal(ref, port)
    for d in range(4):
        if stream.startswith("flat"):
            assert port.values(d) == expected[d]
        else:
            assert port.tree_json(d) == expected[d]


@pytest.mark.parametrize("option", [
    {"megastep_k": 4, "ops_per_step": 8}, {"pool_capacity": 24}, {"mark_pool": False},
    {"capacity": 8}, {"device_rebase": True}, {"plan_cache": False},
], ids=["megastep", "pool_overflow", "object_marks", "overflow", "device_rebase",
        "legacy_emit"])
def test_engine_options_match_reference(option):
    svc, _ = drive_nested_docs(4, seed=29, steps=30, mixed=True)
    ref, port = _pair(_logs(svc, 4), **option)
    assert_engines_equal(ref, port)
    if "capacity" in option or "pool_capacity" in option:
        assert port.fallbacks and not port.errors().any()
        assert port.health()["fallback_routes"] == len(port.fallbacks)
    if "plan_cache" in option:
        # The legacy path bumps neither plan counter: the same keys (the
        # counters absent, the gauges 0) as the reference's health.
        plan_keys = ("translation_plan_hits", "translation_plan_misses",
                     "translation_plan_hit_rate", "translation_plans")
        hr, hp = ref.health(), port.health()
        assert {k: hp.get(k) for k in plan_keys} == {k: hr.get(k) for k in plan_keys}
        assert hp.get("translation_plan_hits", 0) == hp["translation_plans"] == 0


def _raw_equal(a: TreeBatchEngine, b: TreeBatchEngine, d: int, tag: str) -> None:
    """Doc d's raw row (every column, padding remnants included) in two
    port engines, each read at its own slot."""
    for name in tk.NestedForestState._fields:
        x = getattr(a.state, name)[int(a._slot[d])].numpy()
        y = getattr(b.state, name)[int(b._slot[d])].numpy()
        assert np.array_equal(x, y), (tag, d, name)


@pytest.mark.parametrize("seed", [0, 3])
def test_plan_cache_byte_identity(seed):
    """The plan cache is invisible: the reference's identity sessions
    (inserts, removes, sets, moves, transactions) and a mixed nested
    stream through ``plan_cache=True`` and the per-row emit give
    byte-identical state, the cache hits, and the legacy engine counts no
    plan."""
    for svc, expected, key in (
        (*drive_tree_docs(4, seed=seed), "values"),
        (*drive_nested_docs(4, seed=seed, steps=30, mixed=True), "tree_json"),
    ):
        logs = _logs(svc, 4)
        legacy = _feed(TreeBatchEngine(4, device="cpu", plan_cache=False), logs)
        cached = _feed(TreeBatchEngine(4, device="cpu"), logs)
        assert not legacy.errors().any() and not cached.errors().any()
        for d in range(4):
            _raw_equal(cached, legacy, d, f"seed {seed}")
            assert getattr(cached, key)(d) == getattr(legacy, key)(d) == expected[d], d
        assert sorted(cached.fallbacks) == sorted(legacy.fallbacks)
        h, hl = cached.health(), legacy.health()
        assert h["translation_plan_hits"] > 0
        assert 0.0 < h["translation_plan_hit_rate"] <= 1.0
        assert hl.get("translation_plan_hits", 0) == hl.get("translation_plan_misses", 0) == 0
        assert hl["translation_plan_hit_rate"] == 0.0 and hl["translation_plans"] == 0


def _optional_field_stream(n_docs=3, seed=17):
    """The reference test's optional-field session: whole-field replaces
    (int, string, subtree, clear) and nested edits under an optional field
    beside plain inserts, two writers per doc."""
    rng = random.Random(seed)
    svc = LocalService()
    for d in range(n_docs):
        doc = svc.document(f"doc{d}")
        rts = []
        for i in range(2):
            rt = ContainerRuntime(default_registry(), container_id=f"d{d}c{i}")
            rt.create_datastore("root").create_channel("sharedTree", "t")
            rt.connect(doc, f"d{d}c{i}")
            rts.append(rt)
        doc.process_all()
        t0 = rts[0].datastore("root").get_channel("t")
        t0.submit_change(make_insert([], "", 0, [Node(type="obj")]))
        rts[0].flush()
        doc.process_all()
        for _step in range(25):
            rt = rts[rng.randrange(2)]
            t = rt.datastore("root").get_channel("t")
            k = rng.random()
            if k < 0.4:
                v = rng.choice([
                    leaf(rng.randrange(100)),
                    leaf("s" * rng.randint(1, 6)),
                    Node(type="obj", fields={"kid": [leaf(rng.randrange(9))]}),
                ])
                t.submit_change(make_optional_set([("", 0)], "meta", v))
            elif k < 0.55:
                t.submit_change(make_optional_set([("", 0)], "meta", None))
            elif k < 0.8:
                n = t.forest.root_field[0]
                if n.fields.get("meta"):
                    t.submit_change(make_optional_edit(
                        [("", 0)], "meta", NodeChange(value=(rng.randrange(100),)),
                    ))
            else:
                t.submit_change(make_insert(
                    [], "", rng.randint(0, len(t.forest.root_field)),
                    [leaf(rng.randrange(100))],
                ))
            if rng.random() < 0.6:
                rt.flush()
            if rng.random() < 0.4:
                doc.process_some(rng.randint(0, doc.pending_count))
        for rt in rts:
            rt.flush()
        doc.process_all()
    return svc


def test_optional_field_sets_match_reference():
    ref, port = _pair(_logs(_optional_field_stream(), 3))
    assert_engines_equal(ref, port)
    assert not port.fallbacks and port.device_fraction() == 1.0


def _one_writer(edits):
    """One client's session; ``edits(t, i)`` submits the i-th change."""
    svc = LocalService()
    doc = svc.document("doc0")
    rt = ContainerRuntime(default_registry(), container_id="c0")
    rt.create_datastore("root").create_channel("sharedTree", "t")
    rt.connect(doc, "c0")
    doc.process_all()
    t = rt.datastore("root").get_channel("t")
    edits(t, rt, doc)
    rt.flush()
    doc.process_all()
    return [doc.sequencer.log], [nd.value for nd in t.forest.root_field]


def _unsupported_values(t, rt, doc):
    t.submit_change(make_insert([], "", 0, [leaf(7), leaf("ok")]))
    rt.flush()
    doc.process_all()
    t.submit_change(make_insert([], "", 1, [leaf("x" * 100)]))  # wider than a payload row
    t.submit_change(make_insert([], "", 0, [leaf(2**40)]))      # outside int32
    t.submit_change(make_set_value([("", 1)], 5))


def test_unsupported_values_route_to_fallback():
    logs, values = _one_writer(_unsupported_values)
    ref, port = _pair(logs)
    assert_engines_equal(ref, port)
    assert sorted(port.fallbacks) == [0] and port.values(0) == values
    assert port.device_fraction() < 1.0


def _churn(t, rt, doc):
    rng = random.Random(5)
    for i in range(120):
        n = len(t.forest.root_field)
        if n < 4 or rng.random() < 0.55:
            t.submit_change(make_insert([], "", rng.randint(0, n), [leaf(i)]))
        else:
            t.submit_change(make_remove([], "", rng.randrange(n - 1), 1))
        rt.flush()
        doc.process_all()


def _long_queue(t, rt, doc):
    for i in range(100):  # live size stays 1; dead rows pile up
        t.submit_change(make_insert([], "", 0, [leaf(i)]))
        if len(t.forest.root_field) > 1:
            t.submit_change(make_remove([], "", 1, 1))
        rt.flush()
        doc.process_all()


def _string_churn(t, rt, doc):
    rng = random.Random(13)
    for i in range(4):
        t.submit_change(make_insert([], "", i, [leaf(f"s{i}")]))
    for _ in range(120):
        t.submit_change(make_set_value(
            [("", rng.randrange(4))], "".join(rng.choices("abcdefgh", k=8))))
        rt.flush()
        doc.process_all()


@pytest.mark.parametrize("case", ["churn", "long_queue", "string_churn"])
def test_compaction_matches_reference(case):
    """The reference engine tests' compaction shapes: insert/remove churn
    far beyond capacity in dead rows, a churn queue that must re-trigger
    compaction inside one step, and value overwrites far beyond the pool."""
    session, kw = {
        "churn": (_churn, dict(capacity=64)),
        "long_queue": (_long_queue, dict(capacity=64, ops_per_step=8)),
        "string_churn": (_string_churn, dict(capacity=64, pool_capacity=256, ops_per_step=8)),
    }[case]
    logs, values = _one_writer(session)
    ref, port = _pair(logs, **kw)
    assert_engines_equal(ref, port)
    assert not port.fallbacks and not port.errors().any()
    assert port.values(0) == values
    # Dead rows were reclaimed: the allocation watermark is the live count.
    assert int(port.state.nrow[0]) < kw["capacity"]


def _files(directory: str) -> dict[str, bytes]:
    root = os.path.join(directory, "checkpoints")
    if not os.path.isdir(root):
        return {}
    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


def _chunks(logs, n_chunks):
    """Each doc's log cut into ``n_chunks`` consecutive pieces."""
    out = []
    for c in range(n_chunks):
        out.append([log[len(log) * c // n_chunks: len(log) * (c + 1) // n_chunks] for log in logs])
    return out


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """Both engines over a mixed nested session in four chunks, a store
    each with cadence checkpoints and a small capacity (so a doc routes to
    its host fallback): the store bytes after every step, the stores'
    directories, and the logs."""
    svc, _ = drive_nested_docs(3, seed=43, steps=30, mixed=True)
    logs = _logs(svc, 3)
    dirs = tuple(str(tmp_path_factory.mktemp(name)) for name in ("ref", "port"))
    kw = dict(capacity=24, checkpoint_every=5)
    ref = RefEngine(3, checkpoint_store=RefStore(dirs[0]), **kw)
    port = TreeBatchEngine(3, device="cpu", checkpoint_store=CheckpointStore(dirs[1]), **kw)
    snaps = []
    for chunk in _chunks(logs, 4)[:3]:
        for eng in (ref, port):
            _feed(eng, chunk)
        snaps.append((_files(dirs[0]), _files(dirs[1])))
    for eng in (ref, port):
        eng.maybe_checkpoint(force=True)
    snaps.append((_files(dirs[0]), _files(dirs[1])))
    return {"ref": ref, "port": port, "dirs": dirs, "snaps": snaps, "logs": logs, "kw": kw}


def test_checkpoint_files_byte_identical(checkpointed):
    snaps = checkpointed["snaps"]
    assert snaps[-1][0], "no checkpoint was written"
    for i, (a, b) in enumerate(snaps):
        assert a == b, f"store bytes differ after step {i}"
    files = b"".join(snaps[-1][1].values())
    assert b'"lane": "fallback"' in files and b'"lane": "device"' in files
    assert_engines_equal(checkpointed["ref"], checkpointed["port"])


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_restore_across_packages(checkpointed, direction):
    """Either package restores the other's store: the restored engines of
    both packages agree (raw columns included), then the re-fed full logs
    skip what the records cover and apply the rest identically."""
    src = checkpointed["dirs"][0 if direction == "ref_to_port" else 1]
    kw = dict(checkpointed["kw"], checkpoint_every=0)
    ref = RefEngine(3, checkpoint_store=RefStore(src), **kw)
    port = TreeBatchEngine(3, device="cpu", checkpoint_store=CheckpointStore(src), **kw)
    assert ref.restore_from_checkpoints() == port.restore_from_checkpoints() == [0, 1, 2]
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port)
    assert sorted(port.fallbacks) == sorted(checkpointed["port"].fallbacks)
    for eng in (ref, port):
        _feed(eng, checkpointed["logs"])
    assert_engines_equal(ref, port)
    assert port.health()["checkpointed_ops_skipped"] > 0
    fresh = _feed(TreeBatchEngine(3, device="cpu", **kw), checkpointed["logs"])
    for d in range(3):
        assert _json(port.tree_json(d)) == _json(fresh.tree_json(d))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_legacy_restore_across_packages(checkpointed, direction):
    """Restore's re-flatten through the per-row emit: legacy engines of
    both packages restore either store alike, and equal a plan-cache port
    engine restored from the same store, raw columns included."""
    src = checkpointed["dirs"][0 if direction == "ref_to_port" else 1]
    kw = dict(checkpointed["kw"], checkpoint_every=0)
    ref = RefEngine(3, checkpoint_store=RefStore(src), plan_cache=False, **kw)
    port = TreeBatchEngine(3, device="cpu", checkpoint_store=CheckpointStore(src),
                           plan_cache=False, **kw)
    cached = TreeBatchEngine(3, device="cpu", checkpoint_store=CheckpointStore(src), **kw)
    for eng in (ref, port, cached):
        assert eng.restore_from_checkpoints() == [0, 1, 2]
        eng.step()
    assert_engines_equal(ref, port)
    for eng in (ref, port, cached):
        _feed(eng, checkpointed["logs"])
    assert_engines_equal(ref, port)
    assert port.health()["checkpointed_ops_skipped"] > 0
    assert port.health().get("translation_plan_misses", 0) == 0
    assert cached.health()["translation_plan_misses"] > 0
    for d in range(3):
        _raw_equal(port, cached, d, "plan cache")


def test_legacy_migration_matches_reference():
    """``migrate_doc`` on a 2-shard CPU mesh re-packs the folded forest
    through the per-row emit: mid-stream, the port's legacy engine and the
    reference's legacy engine on a 2-device mesh move the same doc to the
    same slot and agree on every raw row, view and counter afterwards, and
    a plan-cache twin moved alike is byte-identical."""
    import jax

    from fluidframework_tpu.parallel.mesh import doc_mesh as ref_doc_mesh
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    D = 4
    svc, expected = drive_tree_docs(D, seed=5, steps=24)
    logs = _logs(svc, D)
    ref = RefEngine(D, mesh=ref_doc_mesh(jax.devices("cpu")[:2]), spare_slots=4,
                    megastep_k=4, plan_cache=False)
    port = TreeBatchEngine(D, mesh=doc_mesh(["cpu"] * 2), spare_slots=4, megastep_k=4,
                           plan_cache=False)
    cached = TreeBatchEngine(D, mesh=doc_mesh(["cpu"] * 2), spare_slots=4, megastep_k=4)
    engines = (ref, port, cached)
    for eng in engines:
        _feed(eng, [log[: len(log) // 2] for log in logs])
    moved = next(d for d in range(D) if d not in port.fallbacks)
    dst = 1 - port.shard_of(moved)
    for eng in engines:
        assert eng.migrate_doc(moved, dst), "migration refused"
        assert eng.shard_of(moved) == dst
    assert port._slot.tolist() == np.asarray(ref._slot).tolist()
    for eng in engines:
        _feed(eng, [log[len(log) // 2:] for log in logs])
    assert_engines_equal(ref, port)
    assert port.health()["doc_migrations"] == 1
    for d in range(D):
        _raw_equal(port, cached, d, "plan cache")
        if d not in port.fallbacks:
            assert port.values(d) == expected[d], d


def test_refresh_restore_and_stale_sweep(tmp_path):
    """A trailing engine re-seeds in place from strictly newer records
    (``refresh=True``), and ``checkpoint_stale`` writes the same records,
    in both packages alike."""
    svc, _ = drive_tree_docs(2, seed=2, steps=20)
    logs = _logs(svc, 2)
    first, second = _chunks(logs, 2)
    dirs = [str(tmp_path / n) for n in ("ref", "port")]
    ref = RefEngine(2, checkpoint_store=RefStore(dirs[0]))
    port = TreeBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(dirs[1]))
    for eng in (ref, port):
        _feed(eng, first)
    assert ref.checkpoint_stale(max_ops_behind=1) == port.checkpoint_stale(max_ops_behind=1)
    assert _files(dirs[0]) == _files(dirs[1])
    trail_ref = RefEngine(2, checkpoint_store=RefStore(dirs[0]))
    trail = TreeBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(dirs[1]))
    assert trail_ref.restore_from_checkpoints(refresh=True) == trail.restore_from_checkpoints(refresh=True)
    assert_engines_equal(trail_ref, trail)
    for eng in (ref, port):
        _feed(eng, second)
        eng.maybe_checkpoint(force=True)
    assert _files(dirs[0]) == _files(dirs[1])
    assert trail_ref.restore_from_checkpoints(refresh=True) == trail.restore_from_checkpoints(refresh=True)
    assert_engines_equal(trail_ref, trail)
    assert trail.health()["checkpoint_refreshes"] == 2
    for d in range(2):
        assert _json(trail.tree_json(d)) == _json(port.tree_json(d))


def test_ingest_batch_and_watermarks_match_reference():
    svc, _ = drive_tree_docs(2, seed=6, steps=20)
    logs = _logs(svc, 2)
    docs = [d for d, log in enumerate(logs) for _ in log]
    msgs = [m for log in logs for m in log]
    kw = dict(ops_per_step=2, megastep_k=2, overload_high_watermark=6, overload_low_watermark=2)
    ref, port = RefEngine(2, **kw), TreeBatchEngine(2, device="cpu", **kw)
    for eng in (ref, port):
        eng.ingest_batch(docs, msgs)
    assert port.update_overload() == ref.update_overload()
    assert port.overloaded == ref.overloaded and port.pending_ops() == ref.pending_ops()
    assert port.ingest_watermarks() == ref.ingest_watermarks()
    for eng in (ref, port):
        eng.step()
    assert port.update_overload() == ref.update_overload()
    assert_engines_equal(ref, port)


def test_engine_options_take_effect():
    """The mesh, spare slots, migration and hot-shard rebalancing this test
    once pinned as refused take effect (their parity tests:
    tests/test_torch_placement.py); an unknown option is refused."""
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    assert TreeBatchEngine(2, mesh=doc_mesh(["cpu"] * 2)).n_shards == 2
    assert TreeBatchEngine(2, device="cpu", spare_slots=2).fleet_capacity == 4
    with pytest.raises(TypeError):
        TreeBatchEngine(2, device="cpu", no_such_option=1)
    eng = TreeBatchEngine(2, device="cpu", mesh=None, spare_slots=0, device_rebase=False,
                          native_wire=False, plan_cache=True)
    # One shard: a move to the doc's own shard is a quiet no-op, and no
    # shard can be hot.
    assert eng.migrate_doc(0, 0) is False
    assert eng.rebalance_hot_shards() == []
    # Boot adoption is ported (tests/test_torch_failover.py): a record
    # without a seq is refused as the reference refuses it.
    with pytest.raises(KeyError):
        eng.adopt_boot_snapshot(0, {})


def test_engine_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TreeBatchEngine(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.init_nested_forest(8, 8)
