"""The port's wire-ingest paths against the JAX package's, exact.

- Columnar ``ingest_batch``: seeded multi-client sessions (inserts,
  removes, annotates, plain and sided obliterates), multi-chunk inserts,
  a malformed message in the middle of a batch, malformed and
  out-of-int32 scalars, a non-string insert seg: after ``step`` the port's
  raw state columns, error latches, pending queues, retained recovery logs
  and ``health()`` ingest counters equal the reference engine's
  ``ingest_batch`` and the port's per-message ``ingest`` (the cases of
  tests/test_columnar_ingest.py for the doc engine).
- Native ``ingest_lines``: the port's C++ encoder gives the reference
  encoder's rows on the same bytes; engines fed through it equal the
  reference's through overflow recovery, oracle routing, streamed chunks
  and escapes, and write byte-identical checkpoint files for native docs
  (real prop ids); the Python decode (library not built) lands the same
  rows; the two paths refuse to mix on one doc (tests/test_native_ingest.py).
- Flow control: ``update_overload`` / ``ingest_watermarks`` /
  ``pending_ops`` / ``overloaded`` follow the reference's.
- The tree engine's ``ingest_lines`` with ``native_wire`` on and off gives
  the reference's summaries, trees and raw columns.

The reference engines run without a mesh (``use_mesh=False``), as in
tests/test_torch_engine.py.  Tolerance 0 throughout.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefTree
from fluidframework_tpu.native import ingest_native as ref_native
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.native import ingest_native
from fluidframework_tpu_torch.protocol.messages import SequencedMessage as PortMessage
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_columnar_ingest import _interleaved, _join, _op
from test_doc_batch_engine import drive_docs
from test_torch_mergetree_kernel import assert_states_equal
from test_tree_batch_engine import drive_tree_docs

pytestmark = pytest.mark.skipif(
    not (ingest_native.available() and ref_native.available()),
    reason="the native ingest library did not build (no g++)",
)

# One geometry for every doc-engine case here: each distinct reference
# geometry costs an XLA compile.
GEOM = dict(max_segments=256, text_capacity=4096, max_insert_len=8, ops_per_step=4)
_COUNTERS = ("ingest_batch_rows", "ingest_fallback_msgs", "checkpointed_ops_skipped",
             "quarantines", "poison_ops_dropped", "capacity_recoveries", "oracle_routes",
             "latency_samples")


def _pair(n_docs, **kw):
    kw = dict(GEOM, **kw)
    return RefEngine(n_docs, use_mesh=False, **kw), DocBatchEngine(n_docs, device="cpu", **kw)


def _pending(eng, d):
    return [a.copy() for a in eng.hosts[d].queue.pending()]


def assert_engines_equal(ref, port, n_docs, counters=_COUNTERS):
    np.testing.assert_array_equal(np.asarray(ref.errors())[:n_docs], port.errors())
    for d in range(n_docs):
        assert port.text(d) == ref.text(d), f"doc {d}"
        assert port.annotations(d) == ref.annotations(d), f"doc {d}"
        if d not in port.quarantine and d not in port.oracles:
            assert_states_equal(ref.doc_state(d), port.doc_state(d), f"doc {d}")
        for a, b in zip(_pending(ref, d), _pending(port, d)):
            np.testing.assert_array_equal(a, b, err_msg=f"doc {d} pending rows")
        assert [(m.seq, m.client_id, m.type) for m in port.hosts[d].log] == [
            (m.seq, m.client_id, m.type) for m in ref.hosts[d].log
        ], f"doc {d} recovery log"
    assert sorted(port.quarantine) == sorted(ref.quarantine)
    assert sorted(port.oracles) == sorted(ref.oracles)
    assert sorted(port.overflow) == sorted(ref.overflow)
    hr, hp = ref.health(), port.health()
    for name in counters:
        assert hp.get(name) == hr.get(name), name


def _batch(eng, feed):
    return eng.ingest_batch([d for d, _ in feed], [m for _, m in feed])


# ------------------------------------------------------------ ingest_batch

@pytest.mark.parametrize("seed", [0, 1])
def test_batch_matches_reference_and_per_message(seed):
    """Whole-trace and chunked batches (boundaries inside doc streams) land
    the reference's rows; after step every raw column equals the
    reference's and the port's own per-message walk."""
    n_docs = 6
    svc, expected = drive_docs(n_docs, seed)
    feed = _interleaved(svc, n_docs)
    ref, whole = _pair(n_docs)
    staged = _batch(ref, feed)
    assert _batch(whole, feed) == staged > 0
    assert_engines_equal(ref, whole, n_docs)  # pre-step: raw rows equal
    chunked = DocBatchEngine(n_docs, device="cpu", **GEOM)
    for i in range(0, len(feed), 7):
        _batch(chunked, feed[i : i + 7])
    per_msg = DocBatchEngine(n_docs, device="cpu", **GEOM)
    for d, m in feed:
        per_msg.ingest(d, m)
    for eng in (ref, whole, chunked, per_msg):
        eng.step()
    assert not whole.errors().any()
    assert_engines_equal(ref, whole, n_docs)
    assert_engines_equal(ref, chunked, n_docs, counters=("ingest_batch_rows",))
    for d in range(n_docs):
        assert_states_equal(ref.doc_state(d), per_msg.doc_state(d), f"doc {d} per message")
        assert whole.text(d) == expected[d]
    assert whole.health()["ingest_batch_rows"] == staged


def test_batch_multichunk_inserts_match():
    """Inserts longer than max_insert_len split back to front into several
    rows; removes interleave."""
    rng = random.Random(3)
    n_docs = 3
    feed, lengths, seqs = [], [0] * n_docs, [0] * n_docs
    for _ in range(40):
        d = rng.randrange(n_docs)
        seqs[d] += 1
        if lengths[d] >= 4 and rng.random() < 0.3:
            p = rng.randrange(lengths[d] - 1)
            feed.append((d, _op(seqs[d], {"type": 1, "pos1": p, "pos2": p + 1})))
            lengths[d] -= 1
        else:
            text = "".join(rng.choice("xyzw") for _ in range(rng.randint(1, 21)))
            p = rng.randrange(lengths[d] + 1)
            feed.append((d, _op(seqs[d], {"type": 0, "pos1": p, "seg": text})))
            lengths[d] += len(text)
    ref, port = _pair(n_docs)
    for eng in (ref, port):
        for d in range(n_docs):
            eng.ingest(d, _join("w0", 0))
        _batch(eng, feed)
    assert_engines_equal(ref, port, n_docs)
    ref.step()
    port.step()
    assert not port.errors().any()
    assert_engines_equal(ref, port, n_docs)


def test_midbatch_malformed_quarantines_only_offending_doc():
    """A decode failure in the middle of a batch quarantines exactly its
    doc: its earlier rows leave the scatter and replay from the log, its
    later message goes through the oracle, every other doc's rows land."""
    n_docs = 3
    feed = [(d, _op(s, {"type": 0, "pos1": 0, "seg": "ab"}))
            for d in range(n_docs) for s in range(1, 5)]
    feed.insert(8, (1, _op(5, {"type": 0, "pos1": 0, "seg": "XX"}, client="ghost")))
    feed.append((1, _op(6, {"type": 0, "pos1": 0, "seg": "cd"})))
    ref, port = _pair(n_docs)
    for eng in (ref, port):
        for d in range(n_docs):
            eng.ingest(d, _join("w0", 0))
        _batch(eng, feed)
        eng.step()
    assert sorted(port.quarantine) == [1]
    h = port.health()
    assert h["quarantines"] == 1 and h["poison_ops_dropped"] >= 1
    assert h["ingest_fallback_msgs"] >= 1
    assert port.text(0) == port.text(2) == "ab" * 4
    assert port.text(1) == "cd" + "ab" * 4
    assert_engines_equal(ref, port, n_docs)


@pytest.mark.parametrize("bad", [
    # A non-int annotate value: quarantines inside the walk.
    {"type": 2, "pos1": 0, "pos2": 2, "props": {1: "bold"}},
    # A dict position: must not misalign the columnar collectors.
    {"type": 0, "pos1": {"x": 1}, "seg": "world"},
])
def test_midbatch_malformed_scalar_quarantines_like_reference(bad):
    ref, port = _pair(2)
    feed = [
        (0, _op(1, {"type": 0, "pos1": 0, "seg": "hello"})),
        (1, _op(1, {"type": 0, "pos1": 0, "seg": "goodbye"})),
        (0, _op(2, bad)),
        (1, _op(2, {"type": 0, "pos1": 0, "seg": "cc"})),
        (1, _op(3, {"type": 2, "pos1": 0, "pos2": 2, "props": {1: 5}})),
    ]
    for eng in (ref, port):
        for d in range(2):
            eng.ingest(d, _join("w0", 0))
        _batch(eng, feed)
        eng.step()
    assert 0 in port.quarantine and 1 not in port.quarantine
    assert port.text(1) == "ccgoodbye" and port.text(0) == "hello"
    assert_engines_equal(ref, port, 2)


@pytest.mark.parametrize("contents", [
    {"type": 0, "pos1": 2**40, "seg": "xx"},
    {"type": 2, "pos1": 0, "pos2": 2, "props": {1: 2**40}},
])
def test_out_of_int32_scalar_raises_after_earlier_rows_land(contents):
    """OverflowError, as per-message ingest raises it, after the batch's
    earlier messages landed — never a silent int32 wrap."""
    ref, port = _pair(2)
    per_msg = DocBatchEngine(2, device="cpu", **GEOM)
    feed = [(0, _op(1, {"type": 0, "pos1": 0, "seg": "ok"})), (1, _op(1, contents))]
    for eng in (ref, port, per_msg):
        for d in range(2):
            eng.ingest(d, _join("w0", 0))
    for eng in (ref, port):
        with pytest.raises(OverflowError):
            _batch(eng, feed)
    per_msg.ingest(*feed[0])
    with pytest.raises(OverflowError):
        per_msg.ingest(*feed[1])
    for eng in (ref, port, per_msg):
        eng.step()
    assert port.text(0) == "ok"
    assert_engines_equal(ref, port, 2)
    assert_states_equal(ref.doc_state(0), per_msg.doc_state(0), "per message")


def test_non_string_seg_raises_and_unwinds_the_log():
    """A marker seg is a legal wire form the engine cannot encode: loud
    (NotImplementedError), and the message leaves the recovery log; the
    earlier rows land."""
    ref, port = _pair(1)
    feed = [(0, _op(1, {"type": 0, "pos1": 0, "seg": "ab"})),
            (0, _op(2, {"type": 0, "pos1": 0, "seg": {"marker": {"refType": 1}}}))]
    for eng in (ref, port):
        eng.ingest(0, _join("w0", 0))
        with pytest.raises(NotImplementedError):
            _batch(eng, feed)
        eng.step()
    assert [m.seq for m in port.hosts[0].log] == [1]
    assert port.hosts[0].ops_since_ckpt == 1
    assert_engines_equal(ref, port, 1)


def test_recovery_off_surfaces_decode_errors():
    """With recovery off there is no log to rebuild from: the batch raises
    the decode error after landing the earlier rows, as the reference."""
    ref, port = _pair(2, recovery="off")
    feed = [(0, _op(1, {"type": 0, "pos1": 0, "seg": "ab"})),
            (1, _op(1, {"type": 0, "pos1": 0, "seg": "XX"}, client="ghost"))]
    for eng in (ref, port):
        for d in range(2):
            eng.ingest(d, _join("w0", 0))
        with pytest.raises(KeyError):
            _batch(eng, feed)
        eng.step()
    assert_engines_equal(ref, port, 2)


def test_checkpoint_floor_dedupes_in_batch(tmp_path):
    """A restored doc skips re-fed messages its checkpoint covers; the
    batch path counts them as the reference does."""
    n_docs = 3
    svc, expected = drive_docs(n_docs, seed=4, rounds=2)
    feed = _interleaved(svc, n_docs)
    store = CheckpointStore(str(tmp_path))
    first = DocBatchEngine(n_docs, device="cpu", checkpoint_store=store, **GEOM)
    _batch(first, feed)
    first.step()
    assert first.maybe_checkpoint(force=True)
    ref = RefEngine(n_docs, use_mesh=False, checkpoint_store=RefStore(str(tmp_path)), **GEOM)
    port = DocBatchEngine(n_docs, device="cpu", checkpoint_store=store, **GEOM)
    for eng in (ref, port):
        assert eng.restore_from_checkpoints() == list(range(n_docs))
        _batch(eng, feed)
        eng.step()
    assert port.health()["checkpointed_ops_skipped"] > 0
    assert_engines_equal(ref, port, n_docs)
    assert [port.text(d) for d in range(n_docs)] == [expected[d] for d in range(n_docs)]


# ---------------------------------------------------------- ingest_lines

def _wire(svc, name) -> bytes:
    return b"".join(m.wire_line() for m in svc.document(name).sequencer.log)


def test_port_encoder_rows_equal_reference_encoder():
    """The same bytes through both packages' C++ encoders (and the port's
    per-message path) give the same rows, payloads and MSN."""
    svc, _ = drive_docs(4, seed=3, rounds=4)
    for d in range(4):
        data = _wire(svc, f"doc{d}")
        ref = ref_native.NativeIngestEncoder(max_insert_len=8, prop_slots=4)
        port = ingest_native.NativeIngestEncoder(max_insert_len=8, prop_slots=4)
        r_ops, r_pay = ref.encode(data)
        p_ops, p_pay = port.encode(data)
        np.testing.assert_array_equal(p_ops, r_ops, err_msg=f"doc {d} ops")
        np.testing.assert_array_equal(p_pay, r_pay, err_msg=f"doc {d} payloads")
        assert port.min_seq == ref.min_seq
        assert port.prop_table() == ref.prop_table()
        py = DocBatchEngine(1, device="cpu", recovery="off", **GEOM)
        for m in svc.document(f"doc{d}").sequencer.log:
            py.ingest(0, m)
        q_ops, q_pay = py.hosts[0].queue.pending()
        np.testing.assert_array_equal(p_ops, q_ops)
        np.testing.assert_array_equal(p_pay, q_pay)
    with pytest.raises(ValueError, match="native ingest"):
        ingest_native.NativeIngestEncoder(8, 4).encode(b'{"type": "op", "contents": \n')


def test_ingest_lines_matches_reference_engine():
    n_docs = 6
    svc, expected = drive_docs(n_docs, seed=9, rounds=4)
    ref, port = _pair(n_docs)
    for eng in (ref, port):
        for d in range(n_docs):
            eng.ingest_lines(d, _wire(svc, f"doc{d}"))
    assert {h.mode for h in port.hosts} == {"native"}
    assert_engines_equal(ref, port, n_docs)
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, n_docs)
    assert [port.text(d) for d in range(n_docs)] == [expected[d] for d in range(n_docs)]
    assert [len(port.hosts[d].raw_log) for d in range(n_docs)] == [1] * n_docs


def test_python_decode_when_the_library_is_not_loaded(monkeypatch):
    """Without a built library ``ingest_lines`` decodes in Python through
    ``ingest_batch``: the same rows, on the object path."""
    svc, _ = drive_docs(3, seed=9, rounds=3)
    native = DocBatchEngine(3, device="cpu", **GEOM)
    for d in range(3):
        native.ingest_lines(d, _wire(svc, f"doc{d}"))
    monkeypatch.setattr(ingest_native, "loaded", lambda: False)
    fallback = DocBatchEngine(3, device="cpu", **GEOM)
    for d in range(3):
        fallback.ingest_lines(d, _wire(svc, f"doc{d}"))
    assert {h.mode for h in fallback.hosts} == {"obj"}
    for d in range(3):
        for a, b in zip(_pending(native, d), _pending(fallback, d)):
            np.testing.assert_array_equal(a, b)
    native.step()
    fallback.step()
    for d in range(3):
        assert_states_equal_port(native, fallback, d)


def assert_states_equal_port(a, b, d):
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    for x, y in zip(mk.leaves(a.doc_state(d)), mk.leaves(b.doc_state(d))):
        assert np.array_equal(x.cpu().numpy(), y.cpu().numpy()), f"doc {d}"


@pytest.mark.parametrize("policy", ["grow", "oracle"])
def test_ingest_lines_through_overflow_recovery(policy):
    """An under-provisioned native doc recovers by grow-and-replay of its
    raw lines (or oracle routing) exactly as the reference's."""
    svc, expected = drive_docs(2, seed=5, rounds=4)
    ref, port = _pair(2, max_segments=8, recovery=policy, max_growths=6)
    for eng in (ref, port):
        for d in range(2):
            eng.ingest_lines(d, _wire(svc, f"doc{d}"))
        eng.step()
    assert port.overflow if policy == "grow" else port.oracles
    assert [port.text(d) for d in range(2)] == [expected[d] for d in range(2)]
    assert_engines_equal(ref, port, 2)
    # The recovered docs left the native path: their raw lines were
    # prepended to the parsed log.
    assert all(port.hosts[d].mode == "obj" for d in list(port.overflow) + list(port.oracles))


def test_native_doc_keeps_serving_after_oracle_route():
    """More bytes for a native doc that was oracle-routed flow through the
    lane (the Python decode), as in the reference."""
    from fluidframework_tpu.dds.shared_string import SharedString
    from fluidframework_tpu.server.local_service import LocalService

    svc = LocalService()
    doc = svc.document("d")
    a = SharedString(client_id="a")
    doc.connect(a.client_id, a.process)
    doc.process_all()
    for _ in range(10):
        a.insert_text(0, "ab")
    for m in a.take_outbox():
        doc.submit(m)
    doc.process_all()
    ref, port = _pair(1, max_segments=4, recovery="oracle")
    consumed = len(doc.sequencer.log)
    for eng in (ref, port):
        eng.ingest_lines(0, _wire(svc, "d"))
        eng.step()
    assert 0 in port.oracles
    a.remove_range(0, 4)
    for m in a.take_outbox():
        doc.submit(m)
    doc.process_all()
    tail = b"".join(m.wire_line() for m in doc.sequencer.log[consumed:])
    assert port.ingest_lines(0, tail) == ref.ingest_lines(0, tail) > 0
    for eng in (ref, port):
        eng.step()
    assert port.text(0) == ref.text(0) == a.text


def test_mixed_paths_are_refused():
    svc, _ = drive_docs(1, seed=1, rounds=1)
    log = svc.document("doc0").sequencer.log
    port = DocBatchEngine(1, device="cpu", **GEOM)
    port.ingest(0, log[0])
    with pytest.raises(AssertionError):
        port.ingest_lines(0, _wire(svc, "doc0"))
    port = DocBatchEngine(1, device="cpu", **GEOM)
    port.ingest_lines(0, _wire(svc, "doc0"))
    with pytest.raises(AssertionError):
        port.ingest(0, log[-1])


def test_streamed_chunks_and_escapes():
    """One chunk per line, unicode and escapes through the wire."""
    from fluidframework_tpu.dds.shared_string import SharedString
    from fluidframework_tpu.server.local_service import LocalService

    svc = LocalService()
    doc = svc.document("d")
    a = SharedString(client_id="a")
    doc.connect(a.client_id, a.process)
    doc.process_all()
    a.insert_text(0, 'héllo "wörld"\n\té✓')
    a.insert_text(3, "中文🎈")
    for m in a.take_outbox():
        doc.submit(m)
    doc.process_all()
    ref, port = _pair(1, max_insert_len=4)
    for eng in (ref, port):
        for m in doc.sequencer.log:
            eng.ingest_lines(0, m.wire_line())
        eng.step()
    assert port.text(0) == a.text
    assert_engines_equal(ref, port, 1)
    # The port's own wire codec writes the reference's bytes.
    for m in doc.sequencer.log:
        assert PortMessage.from_json(m.to_json()).wire_line() == m.wire_line()


def _tree_files(root) -> dict[str, bytes]:
    """Every file under ``root`` by relative path, with its bytes."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _native_prop_wire() -> bytes:
    def line(seq, ref, contents, typ="op"):
        return json.dumps({
            "type": typ, "sequenceNumber": seq, "minimumSequenceNumber": 0,
            "referenceSequenceNumber": ref, "clientId": "w0",
            "clientSequenceNumber": seq, "contents": contents,
        }).encode() + b"\n"

    return b"".join([
        line(0, 0, {"clientId": "w0", "short": 0}, typ="join"),
        line(1, 0, {"type": 0, "pos1": 0, "seg": "abcdef"}),
        line(2, 1, {"type": 2, "pos1": 0, "pos2": 4, "props": {"700": 5}}),
        line(3, 2, {"type": 2, "pos1": 2, "pos2": 6, "props": {"42": 9}}),
        line(4, 3, {"type": 1, "pos1": 5, "pos2": 6}),
    ])


def test_native_checkpoints_byte_identical_and_carry_prop_ids(tmp_path):
    """A native doc's checkpoint files equal the reference's byte for byte
    (its record names the real prop ids, 700 and 42), its raw log keeps
    only the join and the lines past the floor, and the record restores
    with the original ids in both packages."""
    wire = _native_prop_wire()
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    kw = dict(GEOM, checkpoint_every=1, doc_keys=["n0"])
    ref = RefEngine(1, use_mesh=False, checkpoint_store=RefStore(str(rdir)), **kw)
    port = DocBatchEngine(1, device="cpu", checkpoint_store=CheckpointStore(str(pdir)), **kw)
    lines = wire.splitlines(True)
    for chunk in (b"".join(lines[:3]), b"".join(lines[3:])):
        for eng in (ref, port):
            eng.ingest_lines(0, chunk)
            eng.step()
    assert _tree_files(pdir) == _tree_files(rdir)
    assert len(_tree_files(rdir)) >= 1
    rec = CheckpointStore(str(pdir)).load("n0")
    assert rec["prop_slot"] == {"700": 0, "42": 1} and rec["mode"] == "native"
    assert [b.count(b"\n") for b in port.hosts[0].raw_log] == [
        b.count(b"\n") for b in ref.hosts[0].raw_log
    ]
    assert port.hosts[0].raw_log == ref.hosts[0].raw_log
    for restored in (
        DocBatchEngine(1, device="cpu", checkpoint_store=CheckpointStore(str(rdir)), **kw),
        RefEngine(1, use_mesh=False, checkpoint_store=RefStore(str(pdir)), **kw),
    ):
        assert restored.restore_from_checkpoints() == [0]
        assert restored.text(0) == "abcde"
        ann = restored.annotations(0)
        assert ann[0] == {700: 5} and ann[2] == {700: 5, 42: 9} and ann[4] == {42: 9}


# ------------------------------------------------------------ flow control

def test_overload_gate_follows_the_reference():
    n_docs = 4
    svc, _ = drive_docs(n_docs, seed=6, rounds=4)
    feed = _interleaved(svc, n_docs)
    ref, port = _pair(n_docs, overload_high_watermark=6, overload_low_watermark=2,
                      megastep_k=2)
    assert port.ingest_watermarks() == ref.ingest_watermarks() == {
        "megastep_budget": 8, "high": 6, "low": 2}
    for i in range(0, len(feed), 9):
        for eng in (ref, port):
            _batch(eng, feed[i : i + 9])
        assert port.pending_ops() == ref.pending_ops()
        assert port.update_overload() == ref.update_overload()
        assert port.overloaded == ref.overloaded
    assert port.health()["overload_events"] > 0
    for eng in (ref, port):
        eng.step()
    assert port.update_overload() == ref.update_overload()
    assert port.pending_ops() == 0 and not port.overloaded
    hr, hp = ref.health(), port.health()
    for name in ("megastep_budget", "overload", "overloaded_docs", "overload_events",
                 "queue_depth_max", "latency_samples"):
        assert hp[name] == hr[name], name
    defaults = DocBatchEngine(1, device="cpu", ops_per_step=16, megastep_k=8)
    assert defaults.ingest_watermarks() == {"megastep_budget": 128, "high": 1024, "low": 128}


# ------------------------------------------------------------ tree engine

def _tree_json(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("native_wire", [True, False])
def test_tree_ingest_lines_matches_reference(native_wire):
    n_docs = 4
    svc, expected = drive_tree_docs(n_docs, seed=1, steps=20)
    ref = RefTree(n_docs, native_wire=native_wire)
    port = TreeBatchEngine(n_docs, device="cpu", native_wire=native_wire)
    for d in range(n_docs):
        data = b"".join(m.wire_line() for m in svc.document(f"doc{d}").sequencer.log)
        assert port.ingest_lines(d, data) == ref.ingest_lines(d, data)
    for eng in (ref, port):
        eng.step()
    for d in range(n_docs):
        assert port.values(d) == ref.values(d) == expected[d]
        assert _tree_json(port.tree_json(d)) == _tree_json(ref.tree_json(d))
        assert _tree_json(port.hosts[d].em.summarize()) == _tree_json(
            ref.hosts[d].em.summarize())
        for x, y in zip(port.state, ref.state):
            assert np.array_equal(x[d].numpy(), np.asarray(y)[d]), d
    hp, hr = port.health(), ref.health()
    assert hp.get("tree_native_batches", 0) == hr.get("tree_native_batches", 0)
    assert (hp.get("tree_native_batches", 0) > 0) == native_wire


def test_tree_native_malformed_line_lands_earlier_lines():
    """A malformed line: the native decode's error is counted, the Python
    decode lands every earlier line, then raises — as the reference."""
    svc, _ = drive_tree_docs(1, seed=2, steps=6)
    data = b"".join(m.wire_line() for m in svc.document("doc0").sequencer.log)
    bad = data + b'{"type": "op", "contents": {\n'
    outs = []
    for eng in (RefTree(1), TreeBatchEngine(1, device="cpu")):
        with pytest.raises(ValueError):
            eng.ingest_lines(0, bad)
        eng.step()
        outs.append((eng.health()["tree_native_decode_errors"], _tree_json(eng.tree_json(0))))
    assert outs[0] == outs[1] and outs[1][0] == 1
