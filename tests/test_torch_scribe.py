"""The port's scribe, git store and ordered log against the JAX package's.

The same seeded topics (string, tree, map and matrix documents, made with
numpy and the reference's tree sessions) go through the reference
``ScribeLambda`` and the port's (``device="cpu"``).  Held equal byte for
byte: ``refs.json``, the git object log (so every commit SHA and object),
the consumer-group offsets, the topic's partition files with the acks the
scribes produced, and ``health()``.  The reference's ``tests/test_scribe.py``
scenarios then run in both packages as cases of one parametrised test: each
asserts the reference test's contract, and the two packages' acks and
summary records must agree.  Boot checks that need an engine use the port's
engines on the CPU (the reference engine's compiles stay out of tier-1).
"""

from __future__ import annotations

import functools
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.runtime import summary as ref_summary
from fluidframework_tpu.server import gitstore as ref_git
from fluidframework_tpu.server import ordered_log as ref_log
from fluidframework_tpu.server import scribe as ref_scribe
from fluidframework_tpu.server.partition_manager import ScribePool as RefPool
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.protocol.messages import SequencedMessage as PortMsg
from fluidframework_tpu_torch.runtime import summary as port_summary
from fluidframework_tpu_torch.server import gitstore as port_git
from fluidframework_tpu_torch.server import ordered_log as port_log
from fluidframework_tpu_torch.server import scribe as port_scribe
from fluidframework_tpu_torch.server.partition_manager import ScribePool as PortPool

from test_tree_batch_engine import drive_tree_docs


REF = SimpleNamespace(
    name="ref", Msg=RefMsg, log=ref_log, scribe=ref_scribe,
    parse_ack=ref_summary.parse_scribe_ack,
    make=lambda topic, d, **kw: ref_scribe.ScribeLambda(topic, d, **kw),
    pool=lambda topic, d, config: RefPool(topic, d, config=config),
    map_doc=lambda **kw: ref_scribe._MapDocScribe(**kw),
    matrix_doc=lambda **kw: ref_scribe._MatrixDocScribe(**kw),
)
PORT = SimpleNamespace(
    name="port", Msg=PortMsg, log=port_log, scribe=port_scribe,
    parse_ack=port_summary.parse_scribe_ack,
    make=lambda topic, d, **kw: port_scribe.ScribeLambda(topic, d, device="cpu", **kw),
    pool=lambda topic, d, config: PortPool(topic, d, config=config, device="cpu"),
    map_doc=lambda **kw: port_scribe._MapDocScribe(device="cpu", **kw),
    matrix_doc=lambda **kw: port_scribe._MatrixDocScribe(device="cpu", **kw),
)


# ------------------------------------------------------------------ traffic

def _msg(pkg, seq, contents, client="w0", ref=0, min_seq=0, type_=MessageType.OP):
    return pkg.Msg(seq=seq, min_seq=min_seq, ref_seq=ref, client_id=client,
                   client_seq=seq, type=type_, contents=contents)


def _join(pkg, doc, topic, client="w0", short=0):
    topic.produce(doc, _msg(pkg, 0, {"clientId": client, "short": short},
                            client=client, type_=MessageType.JOIN))


def _op(pkg, doc, topic, seq, contents, client="w0", ref=0, min_seq=0):
    m = _msg(pkg, seq, contents, client=client, ref=ref, min_seq=min_seq)
    topic.produce(doc, m)
    return m


def _string_stream(pkg, doc, topic, seqs, seed=0):
    """The reference test's single-writer string edits."""
    rng = np.random.default_rng(seed)
    length = 0
    out = []
    for s in seqs:
        if length >= 4 and rng.random() < 0.3:
            p = int(rng.integers(0, length - 1))
            out.append(_op(pkg, doc, topic, s, {"type": 1, "pos1": p, "pos2": p + 1}))
            length -= 1
        else:
            p = int(rng.integers(0, length + 1))
            out.append(_op(pkg, doc, topic, s, {"type": 0, "pos1": p, "seg": "ab"}))
            length += 2
    return out


def _multi_writer_string(pkg, rounds, seed):
    """Two alternating writers, each op seeing every earlier one, the MSN
    trailing: inserts, removes, annotates and obliterates (the string
    replica's whole op surface).  Returns the joins and ops as messages."""
    rng = np.random.default_rng(seed)
    out = [_msg(pkg, 0, {"clientId": f"w{w}", "short": w}, client=f"w{w}",
                type_=MessageType.JOIN) for w in range(2)]
    seq = length = 0
    for _r in range(rounds):
        for w in range(2):
            ref = seq
            seq += 1
            kind = rng.integers(0, 4) if length >= 6 else 0
            if kind == 0:
                c = {"type": 0, "pos1": int(rng.integers(0, length + 1)), "seg": "xyz"[: 1 + w]}
                length += 1 + w
            elif kind == 1:
                p = int(rng.integers(0, length - 2))
                c = {"type": 1, "pos1": p, "pos2": p + 1}
                length -= 1
            elif kind == 2:
                p = int(rng.integers(0, length - 2))
                c = {"type": 2, "pos1": p, "pos2": p + 2, "props": {"3": int(rng.integers(9))}}
            else:
                p = int(rng.integers(0, length - 2))
                c = {"type": 4, "pos1": p, "pos2": p + 1}
                length -= 1
            out.append(_msg(pkg, seq, c, client=f"w{w}", ref=ref, min_seq=ref // 2))
    return out


def _map_stream(pkg, doc, topic, seqs, rng):
    for s in seqs:
        r = rng.random()
        if r < 0.7:
            c = {"type": "set", "key": f"k{int(rng.integers(6))}",
                 "value": {"v": int(rng.integers(100))}}
        elif r < 0.9:
            c = {"type": "delete", "key": f"k{int(rng.integers(6))}"}
        else:
            c = {"type": "clear"}
        _op(pkg, doc, topic, s, c)


def _matrix_stream(pkg, doc, topic, seqs, rng, first=True):
    if first:
        _join(pkg, doc, topic)
        _op(pkg, doc, topic, 1, {"type": "insertRows", "pos": 0, "count": 4})
        _op(pkg, doc, topic, 2, {"type": "insertCols", "pos": 0, "count": 4}, ref=1)
    for s in seqs:
        _op(pkg, doc, topic, s, {
            "type": "set", "row": int(rng.integers(4)), "col": int(rng.integers(4)),
            "value": int(rng.integers(50)), **({"fwwMode": True} if s % 7 == 0 else {}),
        }, ref=2)


@functools.lru_cache(maxsize=None)
def _tree_logs(n_docs, seed, steps):
    """The reference's seeded tree sessions as wire lines, made once per
    process: the session ids inside are random, so both packages must see
    the same lines."""
    svc, _expected = drive_tree_docs(n_docs, seed=seed, steps=steps)
    return [[m.to_json() for m in svc.document(f"doc{d}").sequencer.log] for d in range(n_docs)]


def _durable_topic(pkg, path, n_partitions=1):
    return pkg.log.DurableTopic("deltas", n_partitions, str(path),
                                encode=lambda m: m.to_json(), decode=pkg.Msg.from_json)


def _acks(pkg, topic, doc=None):
    out = []
    for p in range(topic.n_partitions):
        for rec in topic.partition(p).read(0):
            ack = pkg.parse_ack(rec.payload)
            if ack is not None and (doc is None or ack[0] == doc):
                out.append(ack)
    return out


def _dir_bytes(root) -> dict[str, bytes]:
    out = {}
    for base, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


# ------------------------------------------- the mixed topic, byte for byte

def _mixed_traffic(pkg, topic, wave: int, tree_logs):
    """Wave 0 writes every family's first traffic; wave 1 appends a tail to
    each doc (the same numpy seeds per package)."""
    rng = np.random.default_rng(100 + wave)
    if wave == 0:
        _join(pkg, "s0", topic)
        _string_stream(pkg, "s0", topic, range(1, 21), seed=1)
        for m in _multi_writer_string(pkg, rounds=18, seed=2)[:26]:
            topic.produce("s1", m)
        _map_stream(pkg, "m0", topic, range(1, 41), rng)
        _matrix_stream(pkg, "x0", topic, range(3, 30), rng)
        for d, lines in enumerate(tree_logs):
            for line in lines[: (2 * len(lines)) // 3]:
                topic.produce(f"t{d}", pkg.Msg.from_json(line))
    else:
        _string_stream(pkg, "s0", topic, range(21, 33), seed=3)
        for m in _multi_writer_string(pkg, rounds=18, seed=2)[26:]:
            topic.produce("s1", m)
        _map_stream(pkg, "m0", topic, range(41, 53), rng)
        _matrix_stream(pkg, "x0", topic, range(30, 40), rng, first=False)
        for d, lines in enumerate(tree_logs):
            for line in lines[(2 * len(lines)) // 3:]:
                topic.produce(f"t{d}", pkg.Msg.from_json(line))


def test_scribe_matches_reference_byte_for_byte(tmp_path):
    tree_logs = _tree_logs(2, seed=7, steps=30)
    cfg = dict(max_ops=8, map_max_keys=4, matrix_shape=(8, 8), matrix_segments=16)
    out = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        topic = _durable_topic(pkg, root / "log", n_partitions=2)
        _mixed_traffic(pkg, topic, 0, tree_logs)
        sc = pkg.make(topic, str(root / "scribe"), config=pkg.scribe.ScribeConfig(**cfg))
        sc.pump()
        _mixed_traffic(pkg, topic, 1, tree_logs)
        sc.pump()
        sc.summarize_all()
        sc.pump()  # fold the acks summarize_all produced
        health = sc.health()
        compacted = sc.compact()
        sc.close()
        topic.close()
        store = pkg.scribe.SummaryRecordStore.open(str(root / "scribe"))
        out[pkg.name] = {
            "files": _dir_bytes(root),
            "health": health,
            "compacted": compacted,
            "records": {d: store.load(d) for d in store.docs()},
            "families": {d: store.family(d) for d in store.docs()},
        }
    ref, port = out["ref"], out["port"]
    assert sorted(ref["files"]) == sorted(port["files"])
    for name in ref["files"]:
        assert ref["files"][name] == port["files"][name], name
    assert port["health"] == ref["health"]
    assert port["compacted"] == ref["compacted"]
    assert json.dumps(port["records"], sort_keys=True) == json.dumps(ref["records"], sort_keys=True)
    assert port["families"] == ref["families"] == {
        "m0": "map_batch", "s0": "doc_batch", "s1": "doc_batch",
        "t0": "tree_batch", "t1": "tree_batch", "x0": "matrix_batch",
    }
    # Every doc cut two summaries (incremental commits, with handle reuse),
    # and the map replica grew its key capacity once.
    assert port["health"]["failed_docs"] == 0 and port["health"]["acked_docs"] == 6
    assert port["health"]["summaries_written"] == 12
    assert port["health"]["summary_handles_reused"] > 0
    assert port["records"]["m0"]["summary"]["max_keys"] == 8


def test_port_reads_the_reference_scribes_directory(tmp_path):
    """A topic and a scribe directory the reference wrote open in the port:
    the read-only record store loads the same records, and a port scribe
    restarted over them (refs, objects, offsets, the log with the
    reference's acks) cuts the same next commit as the reference scribe
    restarted over a copy of the same files."""
    cfg = dict(max_ops=5)
    log = tmp_path / "ref" / "log"
    topic = _durable_topic(REF, log)
    _join(REF, "d0", topic)
    _string_stream(REF, "d0", topic, range(1, 13))
    sdir = tmp_path / "ref" / "scribe"
    sc = REF.make(topic, str(sdir), config=REF.scribe.ScribeConfig(**cfg))
    sc.pump()
    sc.close()
    topic.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    before = ref_scribe.SummaryRecordStore.open(str(sdir))
    port_store = port_scribe.SummaryRecordStore.open(str(tmp_path / "port" / "scribe"))
    assert port_store.docs() == before.docs() == ["d0"]
    assert port_store.load("d0") == before.load("d0")
    acks = {}
    for pkg in (REF, PORT):
        topic = _durable_topic(pkg, tmp_path / pkg.name / "log")
        topic.open_all()
        sc = pkg.make(topic, str(tmp_path / pkg.name / "scribe"),
                      config=pkg.scribe.ScribeConfig(**cfg))
        assert sc.health()["docs_restored"] == 1
        _string_stream(pkg, "d0", topic, range(13, 19), seed=4)
        sc.pump()
        acks[pkg.name] = _acks(pkg, topic)
        sc.close()
        topic.close()
    assert acks["port"] == acks["ref"] and [s for _d, s, _c in acks["port"]] == [12, 18]
    assert _dir_bytes(tmp_path / "port") == _dir_bytes(tmp_path / "ref")


def test_gitstore_and_ordered_log_match_reference(tmp_path):
    """Content addressing (SHAs, the object log's lines, snapshot reads),
    partition truncation with its header line, and consumer-group offsets
    are the reference's, byte for byte."""
    out = {}
    for pkg, git in ((REF, ref_git), (PORT, port_git)):
        root = tmp_path / pkg.name
        store = git.GitStore(str(root / "objects"))
        chain = git.GitSnapshotStore(store)
        shas = [chain.save(3, {"a": {"b": [1, 2], "c": "x"}, "d": None}),
                chain.save(5, {"a": {"b": [1, 2], "c": "y"}, "d": True})]
        store.sync()
        read = chain.read_commit(shas[-1])
        topic = _durable_topic(pkg, root / "log", n_partitions=3)
        for i in range(12):
            topic.produce(f"doc{i % 4}", _msg(pkg, i + 1, {"type": 0, "pos1": 0, "seg": "a"}))
        group = pkg.log.ConsumerGroup(topic, "g", str(root))
        group.join("m0")
        group.join("m1")
        seen = [(p, r.offset, r.doc_id) for p, r in group.consume("m1")]
        for p, off, _doc in seen:
            group.commit(p, off + 1)
        cut = topic.partition(0).truncate_below(2)
        topic.close()
        reopened = _durable_topic(pkg, root / "log", n_partitions=3)
        reopened.open_all()
        out[pkg.name] = (shas, read, seen, cut, chain.sharing_ratio(),
                         [[r.offset for r in reopened.partition(p).read(0)] for p in range(3)],
                         _dir_bytes(root))
        reopened.close()
        store.close()
    assert out["port"] == out["ref"]


# -------------------------------------- the reference scenarios, both packages

def _engine(pkg_is_port, n, keys):
    return DocBatchEngine(n, max_insert_len=8, ops_per_step=4, device="cpu", doc_keys=keys)


def _sc_boot_string(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "d0", topic)
    msgs = list(_string_stream(pkg, "d0", topic, range(1, 25)))
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(max_ops=10))
    scribe.pump()
    assert scribe.health()["summaries_written"] >= 1
    (doc, seq, commit), = _acks(pkg, topic, "d0")[-1:]
    assert doc == "d0" and seq == 24 and commit in scribe.store
    msgs += _string_stream(pkg, "d0", topic, range(25, 31), seed=9)
    record = pkg.scribe.SummaryRecordStore.from_scribe(scribe).load("d0")
    if pkg is PORT:
        join = _msg(PORT, 0, {"clientId": "w0", "short": 0}, type_=MessageType.JOIN)
        full = _engine(True, 1, ["d0"])
        boot = _engine(True, 1, ["d0"])
        assert boot.restore_from_checkpoints(
            store=port_scribe.SummaryRecordStore.from_scribe(scribe)) == [0]
        for eng in (full, boot):
            eng.ingest(0, join)
            for m in msgs:
                eng.ingest(0, m)
            eng.step()
        assert boot.text(0) == full.text(0)
        assert boot.annotations(0) == full.annotations(0)
        h = boot.health()
        assert h["checkpointed_ops_skipped"] == 24 and h["boot_replay_len"] == 6
        assert not boot.errors().any()
    topic.close()
    scribe.close()
    return {"acks": _acks(pkg, topic), "record": record}


def _sc_boot_tree(pkg, tmp_path):
    logs = _tree_logs(2, seed=4, steps=16)
    topic = pkg.log.Topic("deltas", 1)
    streams = {d: [pkg.Msg.from_json(line) for line in lines] for d, lines in enumerate(logs)}
    cut = {d: (2 * len(streams[d])) // 3 for d in streams}
    for d, msgs in streams.items():
        for m in msgs[: cut[d]]:
            topic.produce(f"doc{d}", m)
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(max_ops=4))
    scribe.pump()
    assert scribe.health()["summaries_written"] >= 2
    store = pkg.scribe.SummaryRecordStore.from_scribe(scribe)
    records = {d: store.load(d) for d in store.docs()}
    if pkg is PORT:
        full = TreeBatchEngine(2, doc_keys=["doc0", "doc1"], device="cpu")
        for d, msgs in streams.items():
            for m in msgs:
                full.ingest(d, m)
        full.step()
        boot = TreeBatchEngine(2, doc_keys=["doc0", "doc1"], device="cpu")
        assert boot.restore_from_checkpoints(store=store) == [0, 1]
        boot.step()
        for d, msgs in streams.items():
            for m in msgs:
                boot.ingest(d, m)
        boot.step()
        for d in range(2):
            assert boot.values(d) == full.values(d), f"doc {d}"
        h = boot.health()
        assert h["checkpointed_ops_skipped"] > 0 and h["boot_replay_len"] > 0
    scribe.close()
    return {"acks": _acks(pkg, topic), "records": json.dumps(records, sort_keys=True)}


def _state_leaves(state) -> list[np.ndarray]:
    """Every array of a map or matrix state (either package), in field
    order, nested permutation merge-trees included."""
    out = []
    for x in state:
        if isinstance(x, tuple):
            out += _state_leaves(x)
        else:
            out.append(x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    return out


def _sc_boot_map_matrix(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    rng = np.random.default_rng(1)
    _map_stream(pkg, "dmap", topic, range(1, 31), rng)
    _matrix_stream(pkg, "dmx", topic, range(3, 27), rng)
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(
        max_ops=12, map_max_keys=16, matrix_shape=(8, 8), matrix_segments=16))
    scribe.pump()
    store = pkg.scribe.SummaryRecordStore.from_scribe(scribe)
    rec_map, rec_mx = store.load("dmap"), store.load("dmx")
    assert rec_map["engine"] == "map_batch" and rec_mx["engine"] == "matrix_batch"
    assert store.family("dmap") == "map_batch"
    all_msgs = {"dmap": [], "dmx": []}
    for rec in topic.partition(0).read(0):
        if rec.payload.type == MessageType.OP and rec.doc_id in all_msgs:
            all_msgs[rec.doc_id].append(rec.payload)
    _map_stream(pkg, "dmap", topic, range(31, 37), rng)
    _matrix_stream(pkg, "dmx", topic, range(27, 33), rng, first=False)
    for rec in topic.partition(0).read(0)[-12:]:
        all_msgs[rec.doc_id].append(rec.payload)
    views = {}
    for name, make, rec in (("map", lambda: pkg.map_doc(max_keys=16), rec_map),
                            ("matrix", lambda: pkg.matrix_doc(shape=(8, 8), segments=16), rec_mx)):
        full, boot = make(), make()
        if name == "matrix":
            full.quorum = {"w0": 0}
        boot.load(rec["seq"], rec)
        for m in all_msgs["dmap" if name == "map" else "dmx"]:
            full.apply(m)
            boot.apply(m)  # the covered prefix skips by seq floor
        full.flush()
        boot.flush()
        for a, b in zip(_state_leaves(full.state), _state_leaves(boot.state)):
            assert np.array_equal(a, b)
        views[name] = full.items() if name == "map" else full.grid()
        assert views[name] == (boot.items() if name == "map" else boot.grid())
        views[name + "_leaves"] = [a.tolist() for a in _state_leaves(full.state)]
    topic.close()
    scribe.close()
    return {"acks": _acks(pkg, topic), "records": json.dumps([rec_map, rec_mx], sort_keys=True),
            **views}


def _sc_compaction_floor(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "d0", topic)
    _string_stream(pkg, "d0", topic, range(1, 31))
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(max_ops=10))
    scribe.pump()
    fleet = pkg.log.ConsumerGroup(topic, "fleet", str(tmp_path / "scribe"))
    fleet.join("f0")
    lag_at = fleet.consume("f0")[14][1].offset + 1
    fleet.commit(0, lag_at)
    stats = scribe.compact(extra_groups=(fleet,))
    part = topic.partition(0)
    assert part.base == min(lag_at, scribe.refs["d0"]["offset"])
    assert stats["records"] == part.base and stats["bytes"] > 0
    tail = fleet.consume("f0")
    assert fleet.truncated_records_skipped == 0
    assert [r.offset for _p, r in tail] == list(range(lag_at, part.head))
    for _p, r in tail:
        fleet.commit(0, r.offset + 1)
    _string_stream(pkg, "d0", topic, range(31, 61), seed=7)
    scribe.pump()
    for p, r in fleet.consume("f0"):
        fleet.commit(p, r.offset + 1)
    base_before = part.base
    scribe.compact(extra_groups=(fleet,))
    assert part.base > base_before
    assert scribe.health()["log_bytes_reclaimed"] > 0
    out = {"base": part.base, "head": part.head, "health": scribe.health()}
    topic.close()
    topic2 = _durable_topic(pkg, tmp_path / "log")
    topic2.open_all()
    p2 = topic2.partition(0)
    assert p2.base == part.base and p2.head == part.head
    assert [r.offset for r in p2.read(0)] == list(range(p2.base, p2.head))
    topic2.close()
    scribe.close()
    return {**out, "acks": _acks(pkg, topic2)}


def _sc_below_floor(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "d0", topic)
    _string_stream(pkg, "d0", topic, range(1, 21))
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(max_ops=5))
    scribe.pump()
    scribe.compact()
    part = topic.partition(0)
    assert part.base > 0
    late = pkg.log.ConsumerGroup(topic, "late-fleet")
    late.join("m0")
    assert late.committed(0) == part.base
    recs = late.consume("m0")
    assert late.truncated_records_skipped == part.base
    assert [r.offset for _p, r in recs] == list(range(part.base, part.head))
    late.consume("m0")
    assert late.truncated_records_skipped == part.base
    topic.close()
    scribe.close()
    return {"base": part.base, "acks": _acks(pkg, topic)}


def _sc_no_double_ack(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "d0", topic)
    _string_stream(pkg, "d0", topic, range(1, 25))
    sdir = str(tmp_path / "scribe")
    scribe = pkg.make(topic, sdir, config=pkg.scribe.ScribeConfig(max_ops=10))
    scribe.pump()
    assert len(_acks(pkg, topic, "d0")) == 1
    refs_before = dict(scribe.refs)
    scribe.close()
    os.remove(os.path.join(sdir, "offsets-scribe.json"))
    scribe2 = pkg.make(topic, sdir, config=pkg.scribe.ScribeConfig(max_ops=10))
    assert scribe2.health()["docs_restored"] == 1
    scribe2.pump()
    assert len(_acks(pkg, topic, "d0")) == 1
    assert scribe2.health().get("summaries_written", 0) == 0
    assert scribe2.refs["d0"]["commit"] == refs_before["d0"]["commit"]
    _string_stream(pkg, "d0", topic, range(25, 41), seed=3)
    scribe2.pump()
    acks = _acks(pkg, topic, "d0")
    assert len(acks) == 2 and acks[-1][1] == 40
    _k, payload = scribe2.store.get(acks[-1][2])
    assert payload["parent"] == refs_before["d0"]["commit"]
    assert scribe2.health()["summary_handles_reused"] >= 1
    out = {"acks": acks, "health": scribe2.health()}
    topic.close()
    scribe2.close()
    return out


def _sc_crash_keeps_folded_ops(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "d0", topic)
    sdir = str(tmp_path / "scribe")
    scribe = pkg.make(topic, sdir, config=pkg.scribe.ScribeConfig(max_ops=10))
    _string_stream(pkg, "d0", topic, range(1, 11))
    scribe.pump()
    assert scribe.refs["d0"]["seq"] == 10
    tail = _string_stream(pkg, "d0", topic, range(11, 16), seed=5)
    scribe.pump()
    part = topic.partition(0)
    assert scribe.group.committed(0) == part.head - len(tail)
    scribe.close()
    scribe2 = pkg.make(topic, sdir, config=pkg.scribe.ScribeConfig(max_ops=10))
    _string_stream(pkg, "d0", topic, range(16, 21), seed=6)
    scribe2.pump()
    assert scribe2.refs["d0"]["seq"] == 20
    store = pkg.scribe.SummaryRecordStore.from_scribe(scribe2)
    if pkg is PORT:
        eng = _engine(True, 1, ["d0"])
        eng.restore_from_checkpoints(store=store)
        ctl = _engine(True, 1, ["d0"])
        for r in topic.partition(0).read(0):
            if isinstance(r.payload, PortMsg):
                ctl.ingest(0, r.payload)
        ctl.step()
        assert eng.text(0) == ctl.text(0)
    out = {"acks": _acks(pkg, topic), "record": store.load("d0")}
    topic.close()
    scribe2.close()
    return out


def _sc_failed_doc_isolated(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    _join(pkg, "good", topic)
    _string_stream(pkg, "good", topic, range(1, 13))
    _op(pkg, "bad", topic, 1, {"type": 0, "pos1": 0, "seg": "x"}, client="ghost")
    scribe = pkg.make(topic, str(tmp_path / "scribe"), config=pkg.scribe.ScribeConfig(max_ops=5))
    scribe.pump()
    h = scribe.health()
    assert h["failed_docs"] == 1 and h["docs_failed"] == 1
    assert "good" in scribe.refs and "bad" not in scribe.refs
    out = {"acks": _acks(pkg, topic), "health": h, "failed": scribe.docs["bad"].failed}
    topic.close()
    scribe.close()
    return out


def _sc_rebalance_kill(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log", n_partitions=4)
    docs = [f"d{i}" for i in range(4)]
    for d in docs:
        _join(pkg, d, topic)
    pool = pkg.pool(topic, str(tmp_path / "scribe"), pkg.scribe.ScribeConfig(max_ops=10))
    pool.add_member("a")
    b = pool.add_member("b")
    assert {p for m in ("a", "b") for p in pool.group.assignments(m)} == {0, 1, 2, 3}
    for i, d in enumerate(docs):
        _string_stream(pkg, d, topic, range(1, 15), seed=i)
    pool.pump()
    first = {}
    for d in docs:
        acks = _acks(pkg, topic, d)
        assert len(acks) == 1 and acks[0][1] == 14
        first[d] = acks[0][2]
    for i, d in enumerate(docs):
        _string_stream(pkg, d, topic, range(15, 20), seed=10 + i)
    pool.pump()
    killed = pool.group.assignments("a")
    pool.kill_member("a")
    assert pool.group.assignments("b") == [0, 1, 2, 3]
    for i, d in enumerate(docs):
        _string_stream(pkg, d, topic, range(20, 30), seed=20 + i)
    pool.pump()
    for d in docs:
        acks = _acks(pkg, topic, d)
        assert [s for _d, s, _c in acks] == [14, 29]
        _k, payload = pool.store.get(acks[-1][2])
        assert payload["parent"] == first[d]
    assert b.health()["summaries_adopted"] == len(killed)
    pool.pump()
    pool.pump()
    assert all(len(_acks(pkg, topic, d)) == 2 for d in docs)
    store = pkg.scribe.SummaryRecordStore.from_scribe(b)
    if pkg is PORT:
        eng = _engine(True, 4, docs)
        eng.restore_from_checkpoints(store=store)
        ctl = _engine(True, 4, docs)
        by_doc = {d: i for i, d in enumerate(docs)}
        for p in range(topic.n_partitions):
            for r in topic.partition(p).read(0):
                if isinstance(r.payload, PortMsg) and r.doc_id in by_doc:
                    ctl.ingest(by_doc[r.doc_id], r.payload)
        ctl.step()
        for i, d in enumerate(docs):
            assert eng.text(i) == ctl.text(i), d
    reclaimed = pool.compact()
    out = {"acks": _acks(pkg, topic), "reclaimed": reclaimed,
           "records": {d: store.load(d) for d in docs}}
    topic.close()
    pool.close()
    return out


def _sc_stale_replica(pkg, tmp_path):
    topic = _durable_topic(pkg, tmp_path / "log")
    pool = pkg.pool(topic, str(tmp_path / "scribe"), pkg.scribe.ScribeConfig(max_ops=10))
    a = pool.add_member("a")

    def seg(s):
        return chr(65 + s % 26) + chr(97 + s % 26)

    _join(pkg, "d0", topic, client="w0", short=0)
    for s in range(1, 15):
        _op(pkg, "d0", topic, s, {"type": 0, "pos1": 0, "seg": seg(s)})
    a.pump()
    b = pool.add_member("b")
    assert b.docs["d0"].last_seq == 14 and pool.group.assignments("b") == []
    _join(pkg, "d0", topic, client="w1", short=1)
    for s in range(15, 31):
        _op(pkg, "d0", topic, s, {"type": 0, "pos1": 0, "seg": seg(s)}, client="w1")
    pool.pump()
    assert [s for _d, s, _c in _acks(pkg, topic, "d0")] == [14, 30]
    assert b.docs["d0"].last_seq == 14
    pool.kill_member("a")
    for s in range(31, 36):
        _op(pkg, "d0", topic, s, {"type": 0, "pos1": 0, "seg": seg(s)}, client="w1")
    pool.pump()
    assert b.counters.get("stale_replicas_dropped") == 1
    ad = b.docs["d0"]
    assert ad.failed is None and ad.base_seq == 30 and ad.last_seq == 35
    text = ad.tree.visible_text()
    assert text == "".join(seg(s) for s in range(35, 0, -1))
    assert b.summarize("d0") is not None
    assert [s for _d, s, _c in _acks(pkg, topic, "d0")] == [14, 30, 35]
    out = {"acks": _acks(pkg, topic), "text": text}
    topic.close()
    pool.close()
    return out


def _sc_family_detection(pkg, _tmp_path):
    detect = pkg.scribe.detect_family
    cases = [
        ({"type": 0, "pos1": 0, "seg": "x"}, "doc_batch"),
        ({"type": "set", "key": "k", "value": 1}, "map_batch"),
        ({"type": "clear"}, "map_batch"),
        ({"type": "set", "row": 1, "col": 2, "value": 3}, "matrix_batch"),
        ({"type": "insertRows", "pos": 0, "count": 1}, "matrix_batch"),
        ({"type": "edit", "sid": "s", "rev": 1, "changes": []}, "tree_batch"),
        ({"address": "root", "contents": {}}, "tree_batch"),
        ({"type": "groupedBatch", "contents": []}, "tree_batch"),
        ("not a dict", "doc_batch"),
    ]
    for contents, family in cases:
        assert detect(contents) == family, contents
    return {"families": [detect(c) for c, _f in cases]}


SCENARIOS = {
    "boot_string": _sc_boot_string,
    "boot_tree": _sc_boot_tree,
    "boot_map_matrix": _sc_boot_map_matrix,
    "compaction_floor": _sc_compaction_floor,
    "consumer_below_floor": _sc_below_floor,
    "restart_no_double_ack": _sc_no_double_ack,
    "crash_keeps_folded_ops": _sc_crash_keeps_folded_ops,
    "failed_doc_isolated": _sc_failed_doc_isolated,
    "multi_scribe_rebalance_kill": _sc_rebalance_kill,
    "stale_replica_readopts": _sc_stale_replica,
    "family_detection": _sc_family_detection,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_reference_scribe_scenarios_on_the_port(scenario, tmp_path):
    """The reference test's contract holds for the port, and the port's
    acks (doc, seq, commit SHA), records and views equal the reference's."""
    got = {}
    for pkg in (REF, PORT):
        path = tmp_path / pkg.name
        path.mkdir()
        got[pkg.name] = SCENARIOS[scenario](pkg, path)
    assert json.dumps(got["port"], sort_keys=True, default=str) == \
        json.dumps(got["ref"], sort_keys=True, default=str)
