"""The port's host oracle (``dds/mergetree_ref.RefMergeTree``) against the
JAX package's.

Three drives, each fed to one replica of either package:

- LocalService sessions in the shape of tests/test_doc_batch_engine.py
  ``drive_docs`` (two ``SharedString`` clients per doc, random inserts,
  removes, annotates and plain and sided obliterates, partial delivery),
  once with every client backed by the reference oracle and once by the
  port's: the clients' views and summaries must be equal;
- the sequencer logs of those sessions replayed into a fresh remote
  replica of each package, compared after every op;
- the single-writer schedule of tests/test_megastep.py with obliterates.

After every op the views must be equal — ``visible_text``,
``annotations`` and ``visible_length`` at several ``(ref_seq, client)``
perspectives — and at the end ``export_summary``; a summary of either
package imports into the other and exports back unchanged.
"""

from __future__ import annotations

import random

import pytest

from fluidframework_tpu.dds.mergetree_ref import RefMergeTree as RefTree
from fluidframework_tpu.dds.shared_string import SharedString
from fluidframework_tpu.protocol.messages import MessageType
from fluidframework_tpu.server.local_service import LocalService
from fluidframework_tpu_torch.dds.mergetree_ref import RefMergeTree as PortTree
from fluidframework_tpu_torch.dds.shared_string import validate_obliterate_places
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED

from test_engine_checkpoint import _join
from test_megastep import _schedule
from test_mergetree_oracle import draw_op, issue_op, pump


def _session(backend_cls, n_docs: int, seed: int, rounds: int = 5):
    """``drive_docs`` with a chosen oracle class behind every client;
    returns (service, clients per doc)."""
    rng = random.Random(seed)
    svc = LocalService()
    clients = {}
    for d in range(n_docs):
        doc = svc.document(f"doc{d}")
        clients[d] = []
        for i in range(2):
            c = SharedString(client_id=f"d{d}c{i}", backend=backend_cls())
            doc.connect(c.client_id, c.process)
            clients[d].append(c)
        doc.process_all()
    for _round in range(rounds):
        for d in range(n_docs):
            doc = svc.document(f"doc{d}")
            for c in clients[d]:
                for _ in range(rng.randint(0, 3)):
                    issue_op(c, draw_op(rng, len(c.text)))
                if rng.random() < 0.7:
                    for m in c.take_outbox():
                        doc.submit(m)
            doc.process_some(rng.randint(0, doc.pending_count))
    for d in range(n_docs):
        pump(svc.document(f"doc{d}"), clients[d])
    return svc, clients


def _views(tree, perspectives) -> list:
    return [
        (tree.visible_text(r, c), tree.annotations(r, c), tree.visible_length(r, c))
        for r, c in perspectives
    ]


def _assert_summaries_cross(ref: RefTree, port: PortTree) -> None:
    summary = port.export_summary()
    assert summary == ref.export_summary()
    for src, dst_cls in ((summary, RefTree), (ref.export_summary(), PortTree)):
        back = dst_cls()
        back.import_summary(src)
        assert back.export_summary() == src
        assert back.visible_text() == port.visible_text()


def _replay(msgs) -> tuple[RefTree, PortTree, int]:
    """Every OP message into a remote replica of each package, views
    compared after each; returns the replicas and the op count."""
    ref, port = RefTree(), PortTree()
    quorum: dict[str, int] = {}
    applied = 0
    for msg in msgs:
        if msg.type == MessageType.JOIN:
            quorum[msg.contents["clientId"]] = msg.contents["short"]
            continue
        if msg.type != MessageType.OP:
            continue
        client = quorum[msg.client_id]
        for tree in (ref, port):
            DocBatchEngine._oracle_apply(tree, _Host(quorum), msg)
        applied += 1
        views = [(ALL_ACKED, -3), (msg.ref_seq, client), (msg.seq - 1, -1),
                 (msg.seq, client + 1)]
        assert _views(port, views) == _views(ref, views), f"seq {msg.seq}"
        if applied % 5 == 0:
            for tree in (ref, port):
                tree.update_min_seq(msg.min_seq)
    return ref, port, applied


class _Host:
    """The quorum view ``DocBatchEngine._oracle_apply`` reads."""

    def __init__(self, quorum: dict[str, int]) -> None:
        self.quorum = quorum


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clients_on_either_oracle_converge_identically(seed):
    svc_ref, ref_clients = _session(RefTree, 3, seed)
    svc_port, port_clients = _session(PortTree, 3, seed)
    for d in range(3):
        log_ref = svc_ref.document(f"doc{d}").sequencer.log
        log_port = svc_port.document(f"doc{d}").sequencer.log
        assert [m.contents for m in log_port] == [m.contents for m in log_ref]
        for a, b in zip(ref_clients[d], port_clients[d]):
            assert b.text == a.text
            persp = [(ALL_ACKED, -3), (ALL_ACKED, b.short_client), (3, -1)]
            assert _views(b.backend, persp) == _views(a.backend, persp)
            _assert_summaries_cross(a.backend, b.backend)


@pytest.mark.parametrize("seed", [3, 4])
def test_sequenced_log_replays_identically(seed):
    svc, clients = _session(RefTree, 3, seed)
    for d in range(3):
        ref, port, applied = _replay(svc.document(f"doc{d}").sequencer.log)
        assert applied > 0 and port.visible_text() == clients[d][0].text
        _assert_summaries_cross(ref, port)


def test_megastep_schedule_with_obliterates_replays_identically():
    sched = _schedule(4, 24, seed=7, obliterate=True)
    for d in range(4):
        msgs = [_join("w0", 0)] + [m for dd, m in sched if dd == d]
        ref, port, applied = _replay(msgs)
        assert applied == 24
        _assert_summaries_cross(ref, port)
    assert any(m.contents["type"] == 4 for _, m in sched)


@pytest.mark.parametrize(
    "places,n,ok",
    [((0, 0, 2, 1), 3, True), ((2, 1, 2, 0), 3, False), ((0, 0, 3, 1), 3, False),
     ((1, 0, 1, 0), 2, True), ((-1, 0, 0, 0), 2, False)],
)
def test_validate_obliterate_places_matches_reference(places, n, ok):
    from fluidframework_tpu.dds.shared_string import (
        validate_obliterate_places as ref_validate,
    )

    outcomes = []
    for fn in (ref_validate, validate_obliterate_places):
        try:
            fn(*places, n)
            outcomes.append(True)
        except ValueError:
            outcomes.append(False)
    assert outcomes == [ok, ok]
