"""The port's SharedTree host algebra and EditManager fold against the JAX
package's, exact.

The same sequenced tree streams (the reference engine tests'
``drive_tree_docs`` / ``drive_nested_docs`` sessions: concurrent writers
with real ref_seq lag, nested paths, moves, transactions, mixed-type
leaves) fold through the reference's ``EditManager`` and the port's, with
the pooled mark store on and off: every trunk commit's wire JSON and the
final ``summarize()`` JSON must be equal, and a loaded summary must fold
on identically.  The changeset codec, forest JSON and leaf constructors of
the two packages agree on the same inputs.
"""

from __future__ import annotations

import json

import pytest

from fluidframework_tpu.dds.tree import changeset as rcs
from fluidframework_tpu.dds.tree import mark_pool as rmp
from fluidframework_tpu.dds.tree.editmanager import EditManager as RefEditManager
from fluidframework_tpu.dds.tree.forest import Forest as RefForest
from fluidframework_tpu.dds.tree.schema import build_node as ref_build_node
from fluidframework_tpu.dds.tree.schema import leaf as ref_leaf
from fluidframework_tpu.protocol import mark_schema as rms
from fluidframework_tpu_torch.dds.tree import changeset as cs
from fluidframework_tpu_torch.dds.tree import mark_pool as mp
from fluidframework_tpu_torch.dds.tree.editmanager import EditManager
from fluidframework_tpu_torch.dds.tree.forest import Forest
from fluidframework_tpu_torch.dds.tree.schema import build_node, leaf
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.protocol import mark_schema as ms

from test_tree_batch_engine import drive_nested_docs, drive_tree_docs

STREAMS = {
    "flat": lambda: drive_tree_docs(2, seed=4, steps=30)[0],
    "nested": lambda: drive_nested_docs(2, seed=11, steps=30)[0],
    "mixed": lambda: drive_nested_docs(2, seed=19, steps=30, mixed=True)[0],
}


def _edits(log):
    for msg in log:
        if msg.type != "op":
            continue
        for edit in TreeBatchEngine._unwrap(msg.contents):
            yield msg, edit


class _Fold:
    """One package's fold over a doc's stream, as the tree engine runs it."""

    def __init__(self, em_cls, csm, mpm, pooled: bool):
        self.pool = mpm.MarkPool() if pooled else None
        self.em = em_cls(mark_pool=self.pool)
        self.csm, self.mpm = csm, mpm

    def add(self, msg, edit):
        if self.pool is not None:
            commit = self.mpm.pool_commit_from_json(self.pool, edit["changes"])
        else:
            commit = self.csm.commit_from_json(edit["changes"])
        trunk = self.em.add_sequenced(
            client_id=msg.client_id, revision=(edit["sid"], edit["rev"]),
            change=commit, ref_seq=msg.ref_seq, seq=msg.seq,
        )
        self.em.advance_min_seq(msg.min_seq)
        return json.dumps(self.csm.commit_to_json(trunk), sort_keys=True)

    def summary(self) -> str:
        return json.dumps(self.em.summarize(), sort_keys=True)


@pytest.mark.parametrize("pooled", [True, False], ids=["mark_pool", "object_marks"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_editmanager_fold_matches_reference(stream, pooled):
    svc = STREAMS[stream]()
    for d in range(2):
        log = svc.document(f"doc{d}").sequencer.log
        ref = _Fold(RefEditManager, rcs, rmp, pooled)
        port = _Fold(EditManager, cs, mp, pooled)
        half = None
        for i, (msg, edit) in enumerate(_edits(log)):
            assert port.add(msg, edit) == ref.add(msg, edit), (stream, d, msg.seq)
            if i == 20:
                half = (port.summary(), i)
        assert port.summary() == ref.summary()
        if pooled:
            assert port.pool.stats() == ref.pool.stats()
        # A fold loaded from the mid-stream summary folds the rest alike.
        summary, at = half
        assert summary
        loaded_ref = _Fold(RefEditManager, rcs, rmp, pooled)
        loaded_ref.em.load(json.loads(summary))
        loaded = _Fold(EditManager, cs, mp, pooled)
        loaded.em.load(json.loads(summary))
        for i, (msg, edit) in enumerate(_edits(log)):
            if i > at:
                assert loaded.add(msg, edit) == loaded_ref.add(msg, edit)
        assert loaded.summary() == loaded_ref.summary()


def test_device_rebase_is_not_ported():
    """The device rebase window is ported: an EditManager with a CPU
    ``DeviceRebaser`` folds a stream exactly as the reference's
    ``device_rebase=True`` fold (trunk commits and summary), and a private
    rebaser asks for the card (it raises where there is none)."""
    import torch

    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser

    log = STREAMS["flat"]().document("doc0").sequencer.log
    ref = _Fold(RefEditManager, rcs, rmp, True)
    ref.em = RefEditManager(mark_pool=ref.pool, device_rebase=True)
    port = _Fold(EditManager, cs, mp, True)
    port.em = EditManager(mark_pool=port.pool, device_rebase=DeviceRebaser(port.pool, device="cpu"))
    for msg, edit in _edits(log):
        assert port.add(msg, edit) == ref.add(msg, edit)
    assert port.summary() == ref.summary()
    assert port.em.rebaser.stats() == ref.em.rebaser.stats()
    assert port.em.rebaser.windows > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            EditManager(mark_pool=True, device_rebase=True)


def test_changeset_codec_and_apply_match_reference():
    """Constructors, the wire codec, composition-free apply and the forest
    JSON agree across the packages."""
    def content(lf, bn):
        return [lf(1), lf("ab"), lf(2.5), lf(True), lf(None),
                bn("obj", kids=[lf(3), lf("x")], meta=lf(False))]

    pairs = [
        (rcs.make_insert([], "", 0, content(ref_leaf, ref_build_node)),
         cs.make_insert([], "", 0, content(leaf, build_node))),
        (rcs.make_insert([("", 5)], "kids", 1, [ref_leaf(9)]),
         cs.make_insert([("", 5)], "kids", 1, [leaf(9)])),
        (rcs.make_set_value([("", 0)], 42), cs.make_set_value([("", 0)], 42)),
        (rcs.make_remove([], "", 3, 2), cs.make_remove([], "", 3, 2)),
        (rcs.make_move([], "", 0, 2, 3), cs.make_move([], "", 0, 2, 3)),
        (rcs.make_optional_set([("", 2)], "meta", ref_leaf(7)),
         cs.make_optional_set([("", 2)], "meta", leaf(7))),
    ]
    rf, pf = RefForest(), Forest()
    for rc, pc in pairs:
        rj, pj = rcs.commit_to_json([rc]), cs.commit_to_json([pc])
        if rc is not pairs[4][0]:  # a move's id comes from a per-process counter
            assert json.dumps(pj, sort_keys=True) == json.dumps(rj, sort_keys=True)
        back = cs.commit_from_json(json.loads(json.dumps(pj)))
        assert json.dumps(cs.commit_to_json(back)) == json.dumps(pj)
        rcs.apply_commit(rf.root, [rc])
        cs.apply_commit(pf.root, [pc])
        assert json.dumps(pf.to_json(), sort_keys=True) == json.dumps(rf.to_json(), sort_keys=True)
    loaded = Forest()
    loaded.load_json(json.loads(json.dumps(rf.to_json())))
    assert json.dumps(loaded.to_json()) == json.dumps(pf.to_json())


def test_mark_schema_is_the_reference_numbering():
    names = [n for n in dir(rms) if n.isupper() and not n.startswith("_")]
    assert names
    for n in names:
        assert getattr(ms, n) == getattr(rms, n), n
