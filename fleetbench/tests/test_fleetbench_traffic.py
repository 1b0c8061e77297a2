"""The generator: the same seed gives the same bytes, every seed the same
amount of work, valid wire lines in sequence order, and the schedules and
backlog units the drives read."""

import json

import numpy as np
import pytest

from fleetbench import spec
from fleetbench import traffic as tr
from fleetbench.reference import merge_tree

STRING = dict(writers=4, prefix_ops=8, prefix_len=16, head_ops=16, zipf_a=1.1, rank_every=1,
              rank_stride=7, insert_len=8, remove_len=2)


def test_zipf_counts():
    c = tr.zipf_counts(10_000, 16, 1.1)
    assert c[0] == 16 and c.min() == 1 and np.all(np.diff(c) <= 0)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3, -7])
def test_string_rounds_deterministic(seed):
    a = tr.StringRounds(STRING, 32, 3, tr.seeded_rng(seed, 1))
    b = tr.StringRounds(STRING, 32, 3, tr.seeded_rng(seed, 1))
    c = tr.StringRounds(STRING, 32, 3, tr.seeded_rng(seed + 1, 1))
    assert a.line == b.line and np.array_equal(a.doc, b.doc)
    assert a.line != c.line
    # Every seed makes the same amount of work: only positions, texts and
    # which doc holds which rank differ.
    assert len(a.line) == len(c.line)
    assert sorted(np.bincount(a.doc)) == sorted(np.bincount(c.doc))
    assert tr.boot_blobs(STRING, 4, tr.seeded_rng(seed, 1)) == tr.boot_blobs(
        STRING, 4, tr.seeded_rng(seed, 1))


def test_lines_are_wire_json_in_sequence_order():
    D = 8
    boot = tr.boot_blobs(STRING, D, tr.seeded_rng(1, 1))
    sr = tr.StringRounds(STRING, D, 3, tr.seeded_rng(1, 2))
    kinds = []
    for d in range(D):
        msgs = [json.loads(x) for x in boot[d].splitlines()]
        assert [m["type"] for m in msgs] == ["join"] * 4 + ["op"] * 8
        ops = [json.loads(sr.line[i]) for i in np.flatnonzero(sr.doc == d)]
        seqs = [m["sequenceNumber"] for m in msgs[4:] + ops]
        assert seqs == list(range(1, len(seqs) + 1))
        for m in ops:
            assert m["referenceSequenceNumber"] < m["sequenceNumber"]
            kinds.append(m["contents"]["type"])
    assert 0.4 < np.mean(kinds) < 0.6   # inserts and removes alike


def test_each_writer_alternates_over_its_stream():
    sr = tr.StringRounds(STRING, 16, 6, tr.seeded_rng(4, 1))
    for d in range(16):
        by_writer = {}
        for i in np.flatnonzero(sr.doc == d):
            m = json.loads(sr.line[i])
            by_writer.setdefault(m["clientId"], []).append(m["contents"]["type"])
        for kinds in by_writer.values():
            assert kinds == [k % 2 for k in range(len(kinds))]


def test_lengths_are_exact():
    """The generator's length of every doc equals the replayed text's."""
    D = 24
    rng = tr.seeded_rng(9, 1)
    boot = tr.boot_blobs(STRING, D, rng)
    sr = tr.StringRounds(STRING, D, 5, rng)
    for d in range(D):
        lines = b"".join(sr.line[i] for i in np.flatnonzero(sr.doc == d))
        assert len(merge_tree.replay(boot[d] + lines)) == sr.lengths[d]


def test_backlog_units():
    p = dict(STRING, rank_every=2, rounds=5, step_every=2)
    bl = tr.Backlog(p, 16, tr.seeded_rng(3, 1))
    assert len(bl.units) == 3 and len(bl.boot) == 16
    assert [len(u) for u in bl.units] == [16, 16, 16]
    assert sum(bl.unit_ops) == int(tr.zipf_counts(16, 16, 1.1).sum()) * 5
    assert bl.doc_ops(16, 3).sum() == sum(bl.unit_ops)
    # The ranking holds within a unit: the head doc has 16 ops a round.
    assert max(n for _d, _b, n in bl.units[0]) == 32


def test_schedule_order():
    s = tr.Schedule(STRING, 64, rate=2000.0, seconds=1.0, rng=tr.seeded_rng(5, 1))
    assert np.all(np.diff(s.due) >= 0)
    for d in range(64):
        seqs = [json.loads(s.line[i])["sequenceNumber"] for i in np.flatnonzero(s.doc == d)]
        assert seqs == sorted(seqs)
    # The offered rate: ops due in the first second.
    n = int(np.searchsorted(s.due, 1.0))
    per_round = tr.zipf_counts(64, 16, 1.1).sum()
    assert abs(n - 2000) <= per_round


def test_cell_files_match_benchmark():
    bench = spec.benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        assert callable(spec.reader(name))
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], w["chips"])
        cfg = spec.load("configs", w["config"])
        assert configs[w["config"]]["file"] == f"fleetbench/configs/{w['config']}.json"
        assert cfg["source"] == configs[w["config"]]["source"]
        spec.drive(spec.load("traffic", w["traffic"])["drive"])
        reported = spec.cell_metrics(bench, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        moved = {m["name"] for m in reported}
        for m in spec.cell_metrics(bench, w["name"], True):
            assert m["moves"] in moved, (w["name"], m["name"])
