"""The port's checkpoint and restore path against the JAX package.

- The summary codec (``dds/kernel_backend.py``): ``state_to_summary``,
  ``summary_to_state_host``, ``state_geometry``, ``pull_segments`` and
  ``pull_obliterates`` on reference engine states carried across with
  ``mk.from_numpy`` give the reference's results, and the same JSON bytes.
- ``CheckpointStore`` (``server/ordered_log.py``): file names, torn
  writes, legacy and escaped names and ``load_many`` agree with the
  reference's store on the same directory.
- The engines: the same stream into both packages with a store each
  writes byte-identical checkpoint files at every step, for records of the
  batch, overflow, oracle and quarantine lanes; a store either package
  wrote restores in the other to equal states; the parallel restore
  equals the sequential one; a record that outgrew the restoring
  engine's geometry restores into a fitted lane; ``checkpoint_stale``
  honours its ops and seconds bounds.  Tolerance 0 throughout.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest

from fluidframework_tpu.dds import kernel_backend as ref_kb
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.dds import kernel_backend as kb
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_doc_batch_engine import drive_docs
from test_engine_checkpoint import _ins, _join, _op, _schedule
from test_torch_mergetree_kernel import assert_states_equal
from test_torch_recovery import assert_engines_equal, engines, feed


# ---------------------------------------------------------------- the codec

@pytest.fixture(scope="module")
def ref_states():
    """One-document states of the reference engine after LocalService
    sessions (inserts, removes, annotates, plain and sided obliterates)."""
    svc, _ = drive_docs(3, seed=5, rounds=5)
    ref, _port = engines(3, recovery="off", max_segments=64, remove_slots=4, ob_slots=8)
    for d in range(3):
        feed((ref,), d, svc.document(f"doc{d}").sequencer.log)
    ref.step()
    assert not ref.errors().any()
    return [
        (ref.doc_state(d), {v: k for k, v in ref.hosts[d].prop_slot.items()})
        for d in range(3)
    ]


def _slot_interner():
    table: dict[int, int] = {}
    return lambda p: table.setdefault(p, len(table))


def test_codec_matches_reference(ref_states):
    for ref_state, names in ref_states:
        port_state = tk.from_numpy(jax.tree.map(np.asarray, ref_state), device="cpu")
        want = ref_kb.state_to_summary(ref_state, names)
        got = kb.state_to_summary(port_state, names)
        assert got == want and json.dumps(got) == json.dumps(want)
        assert kb.state_geometry(port_state) == ref_kb.state_geometry(ref_state)
        for pull in ("pull_segments", "pull_obliterates"):
            kw = {"with_text": True} if pull == "pull_segments" else {}
            a = [dataclasses.asdict(x) for x in getattr(ref_kb, pull)(ref_state, **kw)]
            b = [dataclasses.asdict(x) for x in getattr(kb, pull)(port_state, **kw)]
            assert b == a, pull
        geom = ref_kb.state_geometry(ref_state)
        want_row = ref_kb.summary_to_state_host(want, geom, _slot_interner())
        got_row = kb.summary_to_state_host(got, geom, _slot_interner())
        assert_states_equal(want_row, got_row, "summary_to_state_host")
        assert_states_equal(
            want_row, kb.summary_to_state(got, geom, _slot_interner(), device="cpu"),
            "summary_to_state",
        )
    assert any(s["obliterates"] for s in (kb.state_to_summary(
        tk.from_numpy(jax.tree.map(np.asarray, st), device="cpu")) for st, _ in ref_states))


def test_summary_that_does_not_fit_raises(ref_states):
    summary = kb.state_to_summary(
        tk.from_numpy(jax.tree.map(np.asarray, ref_states[0][0]), device="cpu")
    )
    geom = dict(max_segments=1, text_capacity=8, remove_slots=1, prop_slots=1, ob_slots=1)
    for mod in (ref_kb, kb):
        with pytest.raises(ValueError):
            mod.summary_to_state_host(summary, geom, _slot_interner())


# ---------------------------------------------------------- the store

def _stores(directory):
    return CheckpointStore(str(directory)), RefStore(str(directory))


def test_store_names_and_cross_reads(tmp_path):
    port, ref = _stores(tmp_path)
    ids = ["plain-doc_1.x", "a b", "sl/ash", "pc%t", "dØc", "%25", "doc-€"]
    for i, doc in enumerate(ids):
        port.save(doc, i, {"engine": "doc_batch", "x": [i]})
    assert sorted(ref.docs()) == sorted(port.docs()) == sorted(ids)
    for i, doc in enumerate(ids):
        assert ref.load(doc) == port.load(doc) == {"doc": doc, "seq": i, "engine": "doc_batch", "x": [i]}
        assert port._path(doc) == ref._path(doc)
        assert port.mtime(doc) == ref.mtime(doc) is not None
    assert port.load_many(ids + ["missing"], max_workers=3) == {
        d: ref.load(d) for d in ids + ["missing"]
    }


def test_store_torn_write_and_legacy_names(tmp_path):
    port, ref = _stores(tmp_path)
    port.save("doc0", 7, {"engine": "doc_batch"})
    with open(port._path("doc0"), "w") as f:
        f.write('{"truncated')
    assert port.load("doc0") is None and ref.load("doc0") is None
    # A record of the old per-codepoint escaper: read, then migrated.
    legacy = os.path.join(port._dir, "doc-%20ac.json")
    with open(legacy, "w") as f:
        json.dump({"doc": "doc-€", "seq": 7, "engine": "doc_batch"}, f)
    assert port.load("doc-€")["seq"] == 7 and port.mtime("doc-€") is not None
    port.save("doc-€", 9, {"engine": "doc_batch"})
    assert not os.path.exists(legacy) and ref.load("doc-€")["seq"] == 9
    # Undecodable names list through their ``doc`` field, or not at all.
    with open(os.path.join(port._dir, "weird name.json"), "w") as f:
        json.dump({"doc": "legacy-a", "seq": 2}, f)
    with open(os.path.join(port._dir, "torn %.json"), "w") as f:
        f.write('{"trunc')
    assert sorted(port.docs()) == sorted(ref.docs()) == ["doc-€", "doc0", "legacy-a"]


# -------------------------------------------------------- engine records

GEOM = dict(max_segments=4, max_growths=1, checkpoint_every=2)


def _rounds():
    """Three rounds for three docs: doc 0 outgrows the batch once (an
    overflow lane), doc 1 twice in one step (growth exhausted: the
    oracle), doc 2 gets a poison op (quarantine); annotates intern prop
    slots.  Every doc checkpoints in the batch lane after round 0."""
    seq = [0, 0, 0]

    def nxt(d):
        seq[d] += 1
        return seq[d]

    r0 = {d: [_ins(nxt(d), 0, "ab"), _ins(nxt(d), 0, "cd")] for d in range(3)}
    r1 = {
        0: [_ins(nxt(0), 0, "ef") for _ in range(3)]
        + [_op(nxt(0), {"type": 2, "pos1": 0, "pos2": 3, "props": {"5": 9}})],
        1: [_ins(nxt(1), 0, "gh") for _ in range(8)],
        2: [_ins(nxt(2), 10**6, "XX"), _ins(nxt(2), 1, "q")],
    }
    r2 = {d: [_ins(nxt(d), 1, "z"), _op(nxt(d), {"type": 1, "pos1": 0, "pos2": 1})]
          for d in range(3)}
    return [r0, r1, r2]


def _files(directory: str) -> dict[str, bytes]:
    root = os.path.join(directory, "checkpoints")
    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """Both engines over ``_rounds`` with a store each; the file bytes of
    both stores after every step, and a copy of the round-0 store."""
    dirs = tuple(str(tmp_path_factory.mktemp(name)) for name in ("ref", "port"))
    ref, port = engines(
        3, checkpoint_store=None, doc_keys=["d0", "d/1", "dØ2"], **GEOM,
    )
    ref.checkpoint_store, port.checkpoint_store = RefStore(dirs[0]), CheckpointStore(dirs[1])
    feed((ref, port), 0, [_join("w0", 0)])
    feed((ref, port), 1, [_join("w0", 0)])
    feed((ref, port), 2, [_join("w0", 0)])
    snapshots = []
    round0 = str(tmp_path_factory.mktemp("round0"))
    for r, msgs in enumerate(_rounds()):
        for d, ms in msgs.items():
            feed((ref, port), d, ms)
        for eng in (ref, port):
            eng.step()
        snapshots.append((_files(dirs[0]), _files(dirs[1])))
        if r == 0:
            shutil.copytree(dirs[1], round0, dirs_exist_ok=True)
    return ref, port, dirs, snapshots, round0


def test_checkpoint_files_byte_identical_in_every_lane(checkpointed):
    ref, port, _dirs, snapshots, _ = checkpointed
    assert_engines_equal(ref, port, 3)
    assert (sorted(port.overflow), sorted(port.oracles), sorted(port.quarantine)) == ([0], [1], [2])
    lanes = set()
    for ref_files, port_files in snapshots:
        assert port_files == ref_files and port_files
        lanes |= {json.loads(b)["lane"] for b in port_files.values()}
    assert lanes == {"batch", "overflow", "oracle", "quarantine"}
    assert port.health()["checkpoints_written"] == ref.health()["checkpoints_written"] >= 9


@pytest.mark.parametrize("parallel", [True, False])
def test_cross_restore_gives_equal_states(checkpointed, parallel):
    """The reference restores the port's store and the port the
    reference's; both equal the engines that wrote them, before and after
    a round of new ops and a replay of already-checkpointed ones."""
    ref, port, dirs, _, _ = checkpointed
    kw = dict(doc_keys=ref.doc_keys, **GEOM)
    ref2, _ = engines(3, checkpoint_store=CheckpointStore(dirs[1]), **kw)
    _, port2 = engines(3, checkpoint_store=RefStore(dirs[0]), **kw)
    for eng in (ref2, port2):
        assert eng.restore_from_checkpoints(parallel=parallel) == [0, 1, 2]
    assert_engines_equal(ref2, port2, 3)
    for d in range(3):
        assert port2.text(d) == port.text(d)
    last = [m for r in _rounds() for d, ms in r.items() for m in ms]
    for d in range(3):
        feed((ref2, port2), d, [_join("w0", 0)] + [m for m in last if m.seq <= 3])
        feed((ref2, port2), d, [_ins(100, 0, "new")])
    for eng in (ref2, port2):
        eng.step()
    assert_engines_equal(ref2, port2, 3)
    assert port2.health()["checkpointed_ops_skipped"] > 0


def test_parallel_restore_equals_sequential(checkpointed):
    _, port, dirs, _, round0 = checkpointed
    for directory in (dirs[1], round0):
        pair = []
        for parallel in (True, False):
            _, eng = engines(3, checkpoint_store=CheckpointStore(directory),
                             doc_keys=port.doc_keys, **GEOM)
            eng.restore_from_checkpoints(parallel=parallel)
            pair.append(eng)
        a, b = pair
        for x, y in zip(tk.leaves(a.state), tk.leaves(b.state)):
            assert np.array_equal(x.numpy(), y.numpy())
        assert sorted(a.overflow) == sorted(b.overflow)
        for d in a.overflow:
            for x, y in zip(tk.leaves(a.overflow[d].state), tk.leaves(b.overflow[d].state)):
                assert np.array_equal(x.numpy(), y.numpy())
        assert [a.text(d) for d in range(3)] == [b.text(d) for d in range(3)]


def test_geometry_outgrown_record_restores_fitted(checkpointed):
    """Round-0 batch records (two segments each) restored into engines of
    one segment: every doc lands in a fitted overflow lane, in both
    packages alike."""
    _, port, _, _, round0 = checkpointed
    ref2, port2 = engines(3, checkpoint_store=None, doc_keys=port.doc_keys,
                          max_segments=1)
    for eng, store in ((ref2, RefStore(round0)), (port2, CheckpointStore(round0))):
        assert eng.restore_from_checkpoints(store) == [0, 1, 2]
    assert_engines_equal(ref2, port2, 3)
    assert sorted(port2.overflow) == [0, 1, 2]
    assert port2.overflow[0].geometry["max_segments"] == 2


def test_refresh_restore_adopts_newer_records_only(tmp_path):
    """A trailing engine (``refresh=True``) re-adopts a record strictly
    newer than its floor, and skips unchanged record files."""
    writers = engines()
    writers[0].checkpoint_store = RefStore(str(tmp_path / "ref"))
    writers[1].checkpoint_store = CheckpointStore(str(tmp_path / "port"))
    for d in range(2):
        feed(writers, d, [_join("w0", 0), _ins(1, 0, "ab"), _ins(2, 1, "cd")])
    for eng in writers:
        eng.step()
        eng.maybe_checkpoint(force=True)
    standby = (engines()[0], engines()[1])
    for eng, w in zip(standby, writers):
        assert eng.restore_from_checkpoints(w.checkpoint_store) == [0, 1]
    feed(writers, 0, [_ins(3, 0, "zz")])
    for eng, w in zip(standby, writers):
        w.step()
        w.maybe_checkpoint(force=True)
        assert eng.restore_from_checkpoints(w.checkpoint_store, refresh=True) == [0]
        assert eng.restore_from_checkpoints(w.checkpoint_store, refresh=True) == []
        assert [eng.text(d) for d in range(2)] == [w.text(d) for d in range(2)]
    assert_engines_equal(*standby, 2)
    assert standby[1].health()["checkpoint_refreshes"] == 1


def test_bounded_replay_after_checkpoint(tmp_path):
    """A poisoned doc's quarantine replay and a later overflow's grow
    replay cover the checkpoint tail, not the whole history."""
    D, ROUNDS, CKPT = 2, 10, 4
    sched = _schedule(D, ROUNDS, poison=(1, 7))
    ref, port = engines(D, checkpoint_every=CKPT)
    ref.checkpoint_store = RefStore(str(tmp_path / "ref"))
    port.checkpoint_store = CheckpointStore(str(tmp_path / "port"))
    for d in range(D):
        feed((ref, port), d, [_join("w0", 0)])
    seen = [0] * D
    for d, m, _p in sched:
        seen[d] += 1
        feed((ref, port), d, [m])
        if seen[d] % CKPT == 0:
            for eng in (ref, port):
                eng.step()
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, D)
    h = port.health()
    assert 1 in port.quarantine and 0 < h["quarantine_replay_len"] < ROUNDS
    assert h["checkpoints_written"] > 0


def test_checkpoint_stale_honors_ops_and_seconds_bounds(tmp_path):
    ref, port = engines(checkpoint_every=10**6)
    ref.checkpoint_store = RefStore(str(tmp_path / "ref"))
    port.checkpoint_store = CheckpointStore(str(tmp_path / "port"))
    for d in range(2):
        feed((ref, port), d, [_join("w0", 0)])
    feed((ref, port), 0, [_ins(1, 0, "aa"), _ins(2, 0, "bb")])
    feed((ref, port), 1, [_ins(1, 0, "cc")])
    for eng in (ref, port):
        eng.step()
        assert eng.maybe_checkpoint() == []  # cadence: nothing due
        assert eng.checkpoint_stale(max_ops_behind=2) == [0]
        assert eng.checkpoint_stale(max_seconds_behind=60.0) == []
    assert port.checkpoint_store.load("0")["seq"] == 2
    assert port.checkpoint_store.load("1") is None
    time.sleep(0.03)
    for eng in (ref, port):
        assert eng.checkpoint_stale(max_seconds_behind=0.02) == [1]
        assert eng.checkpoint_stale(max_ops_behind=1, max_seconds_behind=0.01) == []
    assert _files(port.checkpoint_store._dir[: -len("/checkpoints")]) == _files(
        ref.checkpoint_store._dir[: -len("/checkpoints")]
    )
    h = port.health()
    assert h["stale_checkpoints_written"] == 2
    assert h["dirty_docs"] == 0 and h["checkpoint_age_s"] == 0.0
