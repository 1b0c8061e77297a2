"""The port's failover plane, checkpoint writer, warmup and boot adoption
against the JAX package's.

- ``LeaseFile`` expiry and epoch fencing, and ``LeaseHeartbeat``'s renew
  then loss-once behaviour, run in both packages (the reference's
  tests/test_recovery_plane.py contracts).
- A string ``WarmStandby`` and a tree ``WarmStandby`` of each package share
  one checkpoint directory that a port primary writes; after ``prepare``,
  each ``trail`` and ``promote`` (and the replay after it) the port's
  standby engine equals the reference's on every raw state column, view,
  latch and shared health gauge.
- ``BackgroundCheckpointWriter`` sweeps a live engine from its own thread
  while the test thread serves (ingest and step, tree docs too: the writer
  folds the EditManager under ``ckpt_lock``); the records it leaves equal
  the reference engine's for the same stream, byte for byte.
- ``warmup`` leaves every state byte unchanged and sets the reference's
  ``warmup_dispatches``.
- ``adopt_boot_snapshot``: a stale record is refused with the floor, a
  newer one re-seeds the doc, an unloadable one raises ``ValueError``; the
  engines stay equal to the reference's through each case and the tail.

The reference engines run without a mesh, as the port does.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefDocEngine
from fluidframework_tpu.models.recovery import BackgroundCheckpointWriter as RefWriter
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefTreeEngine
from fluidframework_tpu.server import failover as ref_failover
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.placement import AdoptResult
from fluidframework_tpu_torch.models.recovery import BackgroundCheckpointWriter, RecoveryTracker
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.server import failover as port_failover
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_engine_checkpoint import _ins, _join, _schedule
from test_torch_recovery import BASE
from test_torch_recovery import assert_engines_equal as assert_docs_equal
from test_torch_tree_engine import assert_engines_equal as assert_trees_equal
from test_tree_batch_engine import drive_tree_docs

FAILOVER = {"ref": ref_failover, "port": port_failover}


def _wait_until(cond, timeout_s: float = 5.0, every_s: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every_s)
    return cond()


def _dir_bytes(root) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


# ------------------------------------------------------------ lease, heartbeat

@pytest.mark.parametrize("pkg", sorted(FAILOVER))
def test_lease_file_expiry_and_epoch_fencing(pkg, tmp_path):
    LeaseFile = FAILOVER[pkg].LeaseFile
    path = str(tmp_path / "lease.json")
    a = LeaseFile(path, "a", ttl_s=0.15)
    b = LeaseFile(path, "b", ttl_s=0.15)
    assert a.acquire()
    assert not b.acquire(), "live lease must not hand over"
    assert a.renew()
    assert b.held_by_other()
    time.sleep(0.2)
    assert b.acquire(), "expired lease must hand over"
    assert not a.renew()
    assert not a.acquire()
    assert b.read()["epoch"] > 0
    b.release()
    assert a.acquire()
    assert sorted(a.read()) == ["epoch", "expires", "holder", "ttl_s"]


@pytest.mark.parametrize("pkg", sorted(FAILOVER))
def test_lease_heartbeat_renews_then_detects_loss_once(pkg, tmp_path):
    fo = FAILOVER[pkg]
    path = str(tmp_path / "lease.json")
    holder = fo.LeaseFile(path, "primary", ttl_s=0.3)
    assert holder.acquire()
    losses = []
    hb = fo.LeaseHeartbeat(holder, on_lost=lambda: losses.append(1)).start()
    try:
        assert _wait_until(lambda: hb.stats()["lease_renewals"] >= 2)
        assert not hb.lost and holder.holder_alive()
        thief = fo.LeaseFile(path, "standby", ttl_s=0.3)
        assert thief.acquire(force=True)
        assert _wait_until(lambda: hb.lost)
        time.sleep(0.25)
        assert losses == [1]
        assert hb.stats()["lease_lost"] is True
    finally:
        hb.stop()


def test_heartbeat_files_match_reference(tmp_path):
    for pkg, fo in FAILOVER.items():
        fo.write_heartbeat(str(tmp_path / pkg), {"pid": 7})
        rec, fresh = fo.read_heartbeat(str(tmp_path / pkg), stale_after_s=60)
        assert fresh and rec["pid"] == 7 and sorted(rec) == ["pid", "ts"]
        assert fo.read_heartbeat(str(tmp_path / "absent"), 60) == (None, False)


def test_recovery_tracker_cancel_and_started_at():
    t = RecoveryTracker()
    assert t.started_at is None
    t.begin(100.0)
    t.begin(200.0)  # a later begin never shrinks the window
    assert t.started_at == 100.0 and t.active
    t.cancel()
    assert not t.active and t.complete() is None and t.incidents == 0


# -------------------------------------------------------------- warm standby

def _doc_pair(tmp):
    ref = RefDocEngine(2, use_mesh=False, checkpoint_store=RefStore(tmp), **BASE)
    port = DocBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(tmp), **BASE)
    return ref, port


def test_string_warm_standby_matches_reference(tmp_path):
    tmp = str(tmp_path / "ckpt")
    primary = DocBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(tmp),
                             checkpoint_every=4, **BASE)
    stream = {d: [_join("w0", 0)] for d in range(2)}
    for d in range(2):
        primary.ingest(d, _join("w0", 0))
    sched = _schedule(2, 6, seed=21)
    half = len(sched) // 2
    for d, m, _p in sched[:half]:
        primary.ingest(d, m)
        stream[d].append(m)
    primary.step()
    primary.maybe_checkpoint(force=True)

    ref_eng, port_eng = _doc_pair(tmp)
    standbys = {}
    for name, fo, eng in (("ref", ref_failover, ref_eng), ("port", port_failover, port_eng)):
        lease_path = str(tmp_path / f"lease-{name}.json")
        prim_lease = fo.LeaseFile(lease_path, "primary", ttl_s=30.0)
        assert prim_lease.acquire()
        standbys[name] = (fo.WarmStandby(
            eng, CheckpointStore(tmp) if name == "port" else RefStore(tmp),
            lease=fo.LeaseFile(lease_path, "standby", ttl_s=30.0),
        ).prepare(), prim_lease)
    ref_sb, port_sb = standbys["ref"][0], standbys["port"][0]
    assert port_eng.health()["warmup_dispatches"] == ref_eng.health()["warmup_dispatches"] > 0
    assert not port_sb.should_promote() and not ref_sb.should_promote()
    assert_docs_equal(ref_eng, port_eng, 2)
    assert [port_eng.text(d) for d in range(2)] == [primary.text(d) for d in range(2)]

    for d, m, _p in sched[half:]:
        primary.ingest(d, m)
        stream[d].append(m)
    primary.step()
    primary.maybe_checkpoint(force=True)
    assert port_sb.trail() == ref_sb.trail() == 2
    assert port_sb.adoptions == ref_sb.adoptions
    assert_docs_equal(ref_eng, port_eng, 2)

    # A clean primary shutdown releases the lease: both standbys promote.
    t_kill = time.monotonic()
    for name in ("ref", "port"):
        standbys[name][1].release()
    assert port_sb.should_promote() and ref_sb.should_promote()
    for sb in (ref_sb, port_sb):
        eng = sb.promote(incident_started_at=t_kill)
        assert sb.lease.epoch >= 0 and eng.recovery_tracker.active
        for d in range(2):
            for m in stream[d]:
                eng.ingest(d, m)
            eng.ingest(d, _ins(99, 0, "!!"))
        eng.step()
    assert_docs_equal(ref_eng, port_eng, 2)
    h = port_eng.health()
    assert h["recovery_incidents"] == 1 and h["standby_promotions"] == 1
    assert h["checkpointed_ops_skipped"] == ref_eng.health()["checkpointed_ops_skipped"] > 0
    assert port_eng.latency_histograms()["recovery_time"].count == 1
    for d in range(2):
        assert port_eng.text(d).startswith("!!")


def test_tree_warm_standby_matches_reference(tmp_path):
    svc, expected = drive_tree_docs(4, seed=3, steps=24)
    logs = {d: list(svc.document(f"doc{d}").sequencer.log) for d in range(4)}
    tmp = str(tmp_path / "ckpt")
    primary = TreeBatchEngine(4, checkpoint_store=CheckpointStore(tmp), checkpoint_every=8,
                              device="cpu")
    for d in range(4):
        for msg in logs[d][: len(logs[d]) // 2]:
            primary.ingest(d, msg)
    primary.step()
    primary.maybe_checkpoint(force=True)

    ref_sb = ref_failover.WarmStandby(
        RefTreeEngine(4, checkpoint_store=RefStore(tmp)), RefStore(tmp), lease=None).prepare()
    port_sb = port_failover.WarmStandby(
        TreeBatchEngine(4, checkpoint_store=CheckpointStore(tmp), device="cpu"),
        CheckpointStore(tmp), lease=None).prepare()
    assert port_sb.engine.health()["warmup_dispatches"] > 0
    assert_trees_equal(ref_sb.engine, port_sb.engine)
    assert [port_sb.engine.values(d) for d in range(4)] == [primary.values(d) for d in range(4)]

    for d in range(4):
        for msg in logs[d][len(logs[d]) // 2:]:
            primary.ingest(d, msg)
    primary.step()
    primary.maybe_checkpoint(force=True)
    assert port_sb.trail() == ref_sb.trail() == 4
    assert_trees_equal(ref_sb.engine, port_sb.engine)

    t_kill = time.monotonic()
    for sb in (ref_sb, port_sb):
        eng = sb.promote(incident_started_at=t_kill)
        assert eng is sb.engine and eng.recovery_tracker.active
    assert_trees_equal(ref_sb.engine, port_sb.engine)
    assert port_sb.engine.health()["standby_promotions"] == 1
    assert [port_sb.engine.values(d) for d in range(4)] == [expected[d] for d in range(4)]


# ------------------------------------------------------ background writer

def test_background_checkpoint_writer_records_match_reference(tmp_path):
    """The writer thread sweeps a live string engine within its staleness
    bound while this thread ingests and steps; after it stops, one final
    stale sweep leaves records equal to the reference engine's (same
    stream, same writer) byte for byte, and they restore the state."""
    sched = _schedule(2, 12, seed=5)
    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    engines = {
        "ref": RefDocEngine(2, use_mesh=False, checkpoint_store=RefStore(dirs["ref"]),
                            checkpoint_every=10**6, **BASE),
        "port": DocBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(dirs["port"]),
                               checkpoint_every=10**6, **BASE),
    }
    stats = {}
    for name, Writer in (("ref", RefWriter), ("port", BackgroundCheckpointWriter)):
        eng = engines[name]
        for d in range(2):
            eng.ingest(d, _join("w0", 0))
        writer = Writer(eng, max_seconds_behind=0.02, interval_s=0.005).start()
        try:
            for i, (d, m, _p) in enumerate(sched):
                eng.ingest(d, m)
                if i % 3 == 2:
                    eng.step()
                    time.sleep(0.004)
            eng.step()
            assert _wait_until(lambda: writer.stats()["ckpt_writer_records"] >= 1)
        finally:
            writer.stop()
        stats[name] = writer.stats()
        assert eng.checkpoint_stale(max_ops_behind=1) is not None
    assert stats["port"]["ckpt_writer_sweeps"] > 0 and stats["port"]["ckpt_writer_errors"] == 0
    assert {k: v for k, v in stats["port"].items() if k.startswith("max_")} == \
        {k: v for k, v in stats["ref"].items() if k.startswith("max_")}
    assert _dir_bytes(os.path.join(dirs["port"], "checkpoints")) == \
        _dir_bytes(os.path.join(dirs["ref"], "checkpoints"))
    fresh = DocBatchEngine(2, device="cpu", checkpoint_store=CheckpointStore(dirs["port"]), **BASE)
    assert fresh.restore_from_checkpoints() == [0, 1]
    assert [fresh.text(d) for d in range(2)] == [engines["port"].text(d) for d in range(2)]


def test_background_writer_on_a_live_tree_engine(tmp_path):
    """Tree engine: the writer's sweeps (trunk fold, ``em.summarize()`` on
    the shared MarkPool) interleave with this thread's pooled ingest; the
    final records equal the reference engine's and restore its trees."""
    svc, expected = drive_tree_docs(3, seed=9, steps=30)
    logs = [list(svc.document(f"doc{d}").sequencer.log) for d in range(3)]
    port = TreeBatchEngine(3, checkpoint_store=CheckpointStore(str(tmp_path / "port")),
                           device="cpu")
    writer = BackgroundCheckpointWriter(port, max_seconds_behind=0.001, interval_s=0.002).start()
    errors = []
    try:
        for i in range(max(map(len, logs))):
            for d in range(3):
                if i < len(logs[d]):
                    port.ingest(d, logs[d][i])
            if i % 4 == 3:
                port.step()
            time.sleep(0.002)
        port.step()
        assert _wait_until(lambda: writer.stats()["ckpt_writer_records"] >= 3)
    except Exception as e:  # pragma: no cover - surfaced below
        errors.append(e)
    finally:
        writer.stop()
    assert not errors and writer.stats()["ckpt_writer_errors"] == 0
    port.checkpoint_stale(max_ops_behind=1)
    ref = RefTreeEngine(3, checkpoint_store=RefStore(str(tmp_path / "ref")))
    for d in range(3):
        for m in logs[d]:
            ref.ingest(d, m)
    ref.step()
    ref.maybe_checkpoint(force=True)
    want = {n: json.loads(b) for n, b in _dir_bytes(str(tmp_path / "ref" / "checkpoints")).items()}
    got = {n: json.loads(b) for n, b in _dir_bytes(str(tmp_path / "port" / "checkpoints")).items()}
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    fresh = TreeBatchEngine(3, checkpoint_store=CheckpointStore(str(tmp_path / "port")),
                            device="cpu")
    assert fresh.restore_from_checkpoints() == [0, 1, 2]
    fresh.step()
    assert [fresh.values(d) for d in range(3)] == [expected[d] for d in range(3)]


# ------------------------------------------------------------------- warmup

def _doc_state_bytes(eng) -> list[np.ndarray]:
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    return [x.clone().numpy() for x in mk.leaves(eng.state)]


def _tree_state_bytes(eng) -> list[np.ndarray]:
    return [x.clone().numpy() for x in eng.state]


@pytest.mark.parametrize("family,megastep_k", [("string", 1), ("string", 6), ("tree", 4),
                                               ("tree", 6)])
def test_warmup_leaves_state_unchanged(family, megastep_k):
    """Warmup on a serving engine (state, queues drained, compacted) and on
    a fresh one: every state byte unchanged, the serving path still equal
    to an unwarmed twin afterwards, the reference's dispatch count."""
    if family == "string":
        def make():
            return DocBatchEngine(2, device="cpu", megastep_k=megastep_k, **BASE)

        def feed(eng, part):
            sched = _schedule(2, 8, seed=4)
            if part == 0:
                for d in range(2):
                    eng.ingest(d, _join("w0", 0))
            for d, m, _p in sched[:8] if part == 0 else sched[8:]:
                eng.ingest(d, m)
            eng.step()
            eng.compact()

        snap, views = _doc_state_bytes, lambda e: [e.text(d) for d in range(2)]
    else:
        svc, _expected = drive_tree_docs(2, seed=6, steps=16)
        logs = [list(svc.document(f"doc{d}").sequencer.log) for d in range(2)]

        def make():
            return TreeBatchEngine(2, device="cpu", megastep_k=megastep_k)

        def feed(eng, part):
            for d in range(2):
                half = len(logs[d]) // 2
                for m in logs[d][:half] if part == 0 else logs[d][half:]:
                    eng.ingest(d, m)
            eng.step()

        snap, views = _tree_state_bytes, lambda e: [e.tree_json(d) for d in range(2)]
    fresh = make()
    before = snap(fresh)
    n = fresh.warmup()
    depths = len({1 << i for i in range(megastep_k.bit_length()) if 1 << i <= megastep_k}
                 | {megastep_k})
    assert n == depths + 1 == fresh.health()["warmup_dispatches"]
    assert all(np.array_equal(a, b) for a, b in zip(before, snap(fresh)))
    warm, cold = make(), make()
    feed(warm, 0)
    feed(cold, 0)
    before = snap(warm)
    assert warm.warmup() == n
    assert all(np.array_equal(a, b) for a, b in zip(before, snap(warm)))
    feed(warm, 1)
    feed(cold, 1)
    assert all(np.array_equal(a, b) for a, b in zip(snap(cold), snap(warm)))
    assert views(warm) == views(cold)


def test_warmup_dispatch_count_matches_reference():
    """The gauge equals the reference's: one dispatch per megastep depth
    (K=1, the powers of two, a non-power-of-two ``megastep_k``) plus the
    compact; the reference counts its K=1 step program and the port its
    K=1 megastep, the same dispatch."""
    for k in (1, 6):
        ref = RefDocEngine(1, use_mesh=False, megastep_k=k, **BASE)
        port = DocBatchEngine(1, device="cpu", megastep_k=k, **BASE)
        assert port.warmup() == ref.warmup()
        assert port.health()["warmup_dispatches"] == ref.health()["warmup_dispatches"]
    ref_t = RefTreeEngine(1, megastep_k=6)
    port_t = TreeBatchEngine(1, device="cpu", megastep_k=6)
    assert port_t.warmup() == ref_t.warmup() == 5


# ---------------------------------------------------------- boot adoption

def _doc_record(tmp, stream):
    """A doc_batch record of ``stream`` written by a port engine (records
    are byte-identical to the reference's)."""
    eng = DocBatchEngine(1, device="cpu", checkpoint_store=CheckpointStore(tmp),
                         doc_keys=["0"], **BASE)
    for m in stream:
        eng.ingest(0, m)
    eng.step()
    eng.maybe_checkpoint(force=True)
    return CheckpointStore(tmp).load("0")


def test_doc_adopt_boot_snapshot_matches_reference(tmp_path):
    sched = [m for d, m, _p in _schedule(2, 10, seed=8)]
    by_doc = {0: [_join("w0", 0)], 1: [_join("w0", 0)]}
    for d, m, _p in _schedule(2, 10, seed=8):
        by_doc[d].append(m)
    ref, port = _doc_pair(str(tmp_path / "unused"))
    for eng in (ref, port):
        for d in range(2):
            for m in by_doc[d][:5]:
                eng.ingest(d, m)
        eng.step()
    # Staged pre-gap work (seq 5, not stepped) is dropped by the adoption.
    for eng in (ref, port):
        eng.ingest(0, by_doc[0][5])
    floor = port.hosts[0].last_seq
    stale = _doc_record(str(tmp_path / "a"), by_doc[0][:5])
    newer = _doc_record(str(tmp_path / "b"), by_doc[0][:9])
    assert stale["seq"] < floor < newer["seq"]
    results = {}
    for name, eng in (("ref", ref), ("port", port)):
        got = [eng.adopt_boot_snapshot(0, dict(stale)), eng.adopt_boot_snapshot(0, dict(newer))]
        assert name == "ref" or all(isinstance(r, AdoptResult) for r in got)
        results[name] = [tuple(r) for r in got]
        with pytest.raises(ValueError, match="not adoptable"):
            eng.adopt_boot_snapshot(1, {**newer, "engine": "tree_batch", "seq": 10**6})
    assert results["port"] == results["ref"] == [(False, floor), (True, newer["seq"])]
    for eng in (ref, port):
        eng.step()
    assert_docs_equal(ref, port, 2)
    for name in ("boot_snapshots_stale", "boot_snapshots_adopted"):
        assert port.counters.get(name) == ref.counters.get(name), name
    # The tail past the adopted floor converges with a full replay.
    for eng in (ref, port):
        for m in by_doc[0][9:]:
            eng.ingest(0, m)
        for m in by_doc[1][5:]:
            eng.ingest(1, m)
        eng.step()
    assert_docs_equal(ref, port, 2)
    full = DocBatchEngine(2, device="cpu", **BASE)
    for d in range(2):
        for m in by_doc[d]:
            full.ingest(d, m)
    full.step()
    assert [port.text(d) for d in range(2)] == [full.text(d) for d in range(2)]
    assert len(sched) == 20


def test_tree_adopt_boot_snapshot_matches_reference(tmp_path):
    svc, expected = drive_tree_docs(2, seed=12, steps=20)
    logs = [list(svc.document(f"doc{d}").sequencer.log) for d in range(2)]
    ref, port = RefTreeEngine(2), TreeBatchEngine(2, device="cpu")
    third = len(logs[0]) // 3
    for eng in (ref, port):
        for d in range(2):
            for m in logs[d][:third]:
                eng.ingest(d, m)
        eng.step()
    rec_eng = TreeBatchEngine(1, device="cpu", doc_keys=["0"],
                              checkpoint_store=CheckpointStore(str(tmp_path)))
    for m in logs[0][: 2 * third]:
        rec_eng.ingest(0, m)
    rec_eng.step()
    rec_eng.maybe_checkpoint(force=True)
    newer = CheckpointStore(str(tmp_path)).load("0")
    floor = port.hosts[0].last_seq
    stale = {**newer, "seq": floor}
    results = {}
    for name, eng in (("ref", ref), ("port", port)):
        results[name] = [tuple(eng.adopt_boot_snapshot(0, dict(stale))),
                         tuple(eng.adopt_boot_snapshot(0, dict(newer)))]
        with pytest.raises(ValueError, match="not adoptable"):
            eng.adopt_boot_snapshot(1, {**newer, "engine": "doc_batch", "seq": 10**6})
    assert results["port"] == results["ref"] == [(False, floor), (True, newer["seq"])]
    assert_trees_equal(ref, port)
    for eng in (ref, port):
        for m in logs[0]:
            eng.ingest(0, m)  # the adopted prefix skips by seq floor
        for m in logs[1][third:]:
            eng.ingest(1, m)
        eng.step()
    assert_trees_equal(ref, port)
    assert [port.values(d) for d in range(2)] == [expected[d] for d in range(2)]


def test_checkpoint_writer_thread_stops_and_counts_errors(tmp_path):
    """A sweep that raises is counted, not fatal to the thread."""
    class Failing:
        def __init__(self):
            self.calls = 0

        def checkpoint_stale(self, **_kw):
            self.calls += 1
            raise OSError("disk full")

    eng = Failing()
    w = BackgroundCheckpointWriter(eng, max_ops_behind=1, interval_s=0.01).start()
    assert _wait_until(lambda: w.stats()["ckpt_writer_errors"] >= 2)
    w.stop()
    s = w.stats()
    assert s["ckpt_writer_sweeps"] == s["ckpt_writer_errors"] == eng.calls
    assert s["ckpt_writer_records"] == 0
    assert threading.active_count() >= 1
