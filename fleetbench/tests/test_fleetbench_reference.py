"""The plain reference against a hand-worked case of its semantics, against
a character-list replica of the same rules, and against the program at a
tiny size on the CPU."""

import json

import numpy as np
import pytest

from fleetbench import traffic as tr
from fleetbench.reference import merge_tree

STRING = dict(writers=4, prefix_ops=8, prefix_len=16, head_ops=16, zipf_a=1.1, insert_len=8,
              remove_len=2, rank_stride=7)


def _op(seq, ref, w, contents):
    return (b'{"clientId":"w%d","clientSequenceNumber":%d,"referenceSequenceNumber":%d,'
            b'"sequenceNumber":%d,"minimumSequenceNumber":0,"type":"op","contents":%s}\n'
            % (w, seq, ref, seq, json.dumps(contents).encode()))


def _joins(n):
    return b"".join(b'{"clientId":"w%d","sequenceNumber":0,"type":"join",'
                    b'"contents":{"clientId":"w%d","short":%d}}\n' % (w, w, w) for w in range(n))


def test_merge_tree_concurrent_inserts_later_left():
    data = _joins(3) + _op(1, 0, 0, {"type": 0, "pos1": 0, "seg": "xy"})
    # Two concurrent inserts at position 1 of "xy": the later sequenced
    # lands in front of the earlier one.
    data += _op(2, 1, 1, {"type": 0, "pos1": 1, "seg": "A"})
    data += _op(3, 1, 2, {"type": 0, "pos1": 1, "seg": "B"})
    assert merge_tree.replay(data) == "xBAy"
    # A remove by w1 that does not see B: [1, 3) of its "xAy" is A and y.
    data += _op(4, 2, 1, {"type": 1, "pos1": 1, "pos2": 3})
    assert merge_tree.replay(data) == "xB"


class _CharList:
    """The same rules over a list of characters, each with its removes."""

    def __init__(self):
        self.chars = []   # [ch, seq, client, [(seq, client), ...]]

    def present(self, c, ref, client):
        if c[1] > ref and c[2] != client:
            return False
        return not any(s <= ref or w == client for s, w in c[3])

    def apply(self, m):
        if m["type"] != "op":
            return
        seq, ref, client, c = (m["sequenceNumber"], m["referenceSequenceNumber"],
                               m["clientId"], m["contents"])
        seen = [i for i, ch in enumerate(self.chars) if self.present(ch, ref, client)]
        if c["type"] == 0:
            at = seen[c["pos1"] - 1] + 1 if c["pos1"] else 0
            self.chars[at:at] = [[ch, seq, client, []] for ch in c["seg"]]
        else:
            for i in seen[c["pos1"]:c["pos2"]]:
                self.chars[i][3].append((seq, client))

    def text(self):
        return "".join(ch[0] for ch in self.chars if not ch[3])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_a_character_list(seed):
    D = 12
    p = dict(STRING, rank_every=1)
    rng = tr.seeded_rng(seed, 1)
    boot = tr.boot_blobs(p, D, rng)
    sr = tr.StringRounds(p, D, 6, rng)
    for d in range(D):
        data = boot[d] + b"".join(sr.line[i] for i in np.flatnonzero(sr.doc == d))
        slow = _CharList()
        for line in data.splitlines():
            slow.apply(json.loads(line))
        assert merge_tree.replay(data) == slow.text()


@pytest.mark.parametrize("rank_every", [1, 2])
def test_string_fleet_matches_reference(rank_every):
    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    D = 48
    p = dict(STRING, rank_every=rank_every)
    rng = tr.seeded_rng(2**40 + 5, 1)
    boot = tr.boot_blobs(p, D, rng)
    sr = tr.StringRounds(p, D, 4, rng)
    eng = DocBatchEngine(D, device="cpu", max_segments=256, text_capacity=1024, remove_slots=4,
                         prop_slots=2, ops_per_step=16, megastep_k=8, max_insert_len=16)
    per_doc = [[boot[d]] for d in range(D)]
    for d in range(D):
        eng.ingest_lines(d, boot[d])
    eng.step()
    lo = 0
    for r, hi in enumerate(sr.round_end):
        for d, blob, _n in tr.group_by_doc(sr.doc, sr.line, lo, hi):
            eng.ingest_lines(d, blob)
            per_doc[d].append(blob)
        lo = hi
        if r % 2:
            eng.step()
            eng.compact()
    assert not (eng.overflow or eng.quarantine or eng.oracles)
    assert [eng.text(d) for d in range(D)] == [merge_tree.replay(b"".join(x)) for x in per_doc]
