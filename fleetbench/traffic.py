"""Traffic: sequenced SharedString wire JSON lines made from a seed.

Every mix under ``traffic/`` names the generator's parameters and one drive
(``drive``).  Lines are the wire form of a sequenced message
(``sequenceNumber``, ``clientId``, ...), one per line, so the program and
the plain reference read the same bytes.

A doc's stream (``zipf_string``):

- Boot: each writer's join, then a prefix history of ``prefix_ops``
  appends of ``prefix_len`` chars, writers in turn, each op referencing
  the one before it: the doc's content before the traffic.
- Rounds: a doc's ops per round follow Zipf(``zipf_a``) by its rank
  (``head_ops`` at the head, at least 1).  The ranking is a seeded order
  of the docs that moves by ``rank_stride`` places every ``rank_every``
  rounds (the hot set moves).  The b-th op of a doc's round comes from
  writer ``b % writers``.  Every op of a round references the round start
  (writers are mutually concurrent) and the MSN is the round start.
- Each writer alternates insert and remove over its whole stream.  An
  insert puts ``insert_len`` chars at a random position of the writer's
  view.  A remove takes ``remove_len`` chars: of the writer's own insert
  earlier in the round where there is one, else at a random place of the
  round-start text, each writer in its own strip of it, so concurrent
  removes never overlap and every doc's length is known exactly.
"""

from __future__ import annotations

import numpy as np

_STRING_OP = (
    b'{"clientId":"w%d","clientSequenceNumber":%d,"referenceSequenceNumber":%d,'
    b'"sequenceNumber":%d,"minimumSequenceNumber":%d,"type":"op","contents":%s,'
    b'"metadata":null,"timestamp":0.0,"shortClient":-1}\n'
)
_JOIN = (
    b'{"clientId":"w%d","clientSequenceNumber":0,"referenceSequenceNumber":0,'
    b'"sequenceNumber":0,"minimumSequenceNumber":0,"type":"join",'
    b'"contents":{"clientId":"w%d","short":%d},"metadata":null,"timestamp":0.0,'
    b'"shortClient":-1}\n'
)
_FILL = b"#"  # the prefix's chars, replaced per doc


def seeded_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one named use of the run's seed (any size of int)."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def zipf_counts(n_docs: int, head_ops: int, a: float) -> np.ndarray:
    """Ops per round by Zipf rank (rank 0 busiest, floor 1)."""
    w = (np.arange(n_docs, dtype=np.float64) + 1.0) ** (-a)
    return np.maximum(1, np.round(head_ops * w / w[0]).astype(np.int64))


def round_counts(p: dict, n_docs: int, order: np.ndarray, r: int) -> np.ndarray:
    """Each doc's ops in round ``r``: its rank is its place in ``order``
    moved ``rank_stride`` places every ``rank_every`` rounds."""
    by_rank = zipf_counts(n_docs, int(p["head_ops"]), float(p["zipf_a"]))
    shift = (r // int(p["rank_every"])) * int(p["rank_stride"])
    return by_rank[(order + shift) % n_docs]


def boot_blobs(p: dict, n_docs: int, rng: np.random.Generator) -> list[bytes]:
    """Each doc's joins and prefix history (the same lines but the chars)."""
    W, P, PL = int(p["writers"]), int(p["prefix_ops"]), int(p["prefix_len"])
    template = b"".join(_JOIN % (w, w, w) for w in range(W))
    template += b"".join(
        _STRING_OP % ((k - 1) % W, k, k - 1, k, k - 1,
                      b'{"type":0,"pos1":%d,"seg":"%s"}' % ((k - 1) * PL, _FILL * PL))
        for k in range(1, P + 1))
    tmpl = np.frombuffer(template, np.uint8)
    where = np.flatnonzero(tmpl == _FILL[0])
    rows = np.tile(tmpl, (n_docs, 1))
    rows[:, where] = rng.integers(97, 123, size=(n_docs, len(where)), dtype=np.uint8)
    return [r.tobytes() for r in rows]


class StringRounds:
    """``zipf_string`` rounds after the boot, as op arrays.

    ``doc``, ``seq``, ``line`` hold every op of every round, round-major,
    and ``round_end[r]`` is the index one past round r's last op.  Within
    a round ops are in generation order (op slot b major), so each doc's
    ops are in sequence order."""

    def __init__(self, p: dict, n_docs: int, rounds: int, rng: np.random.Generator):
        D, W = n_docs, int(p["writers"])
        L, RL = int(p["insert_len"]), int(p["remove_len"])
        order = rng.permutation(D)
        lengths = np.full(D, int(p["prefix_ops"]) * int(p["prefix_len"]), np.int64)
        seq = np.full(D, int(p["prefix_ops"]), np.int64)
        removing = np.zeros((D, W), bool)   # each writer's next op is a remove
        docs_all, seqs_all, lines = [], [], []
        self.round_end = []
        for r in range(rounds):
            counts = round_counts(p, D, order, r)
            ref = seq.copy()
            strip = lengths // (RL * W) * RL   # a writer's strip of the round-start text
            own_extra = np.zeros((D, W), np.int64)
            last_ins = np.full((D, W), -1, np.int64)
            for b in range(int(counts.max())):
                w = b % W
                docs = np.flatnonzero(b < counts)
                rem = removing[docs, w]
                ins_docs, rem_docs = docs[~rem], docs[rem]
                contents = np.empty(len(docs), object)
                # Inserts: a random position of the writer's view.
                own_len = lengths[ins_docs] + own_extra[ins_docs, w]
                pos = np.minimum((rng.random(len(ins_docs)) * (own_len + 1)).astype(np.int64),
                                 own_len)
                last_ins[ins_docs, w] = pos
                own_extra[ins_docs, w] += L
                chars = rng.integers(97, 123, size=(len(ins_docs), L), dtype=np.uint8)
                contents[~rem] = [b'{"type":0,"pos1":%d,"seg":"%s"}' % (int(x), c.tobytes())
                                  for x, c in zip(pos.tolist(), chars)]
                # Removes: of the writer's insert of this round, else in its
                # strip of the round-start text.
                mine = last_ins[rem_docs, w]
                first = mine < 0
                pick = (rng.random(len(rem_docs)) * (strip[rem_docs] // RL)).astype(np.int64)
                rpos = np.where(first, w * strip[rem_docs] + pick * RL, mine)
                last_ins[rem_docs, w] = -1
                own_extra[rem_docs, w] -= RL
                contents[rem] = [b'{"type":1,"pos1":%d,"pos2":%d}' % (x, x + RL)
                                 for x in rpos.tolist()]
                removing[docs, w] = ~rem
                seq[docs] += 1
                s = seq[docs]
                r0 = ref[docs]
                lines.extend(_STRING_OP % (w, q, f, q, f, c)
                             for q, f, c in zip(s.tolist(), r0.tolist(), contents))
                docs_all.append(docs)
                seqs_all.append(s)
            lengths = lengths + own_extra.sum(axis=1)
            self.round_end.append(len(lines))
        self.doc = np.concatenate(docs_all).astype(np.int64)
        self.seq = np.concatenate(seqs_all).astype(np.int64)
        self.line = lines
        self.lengths = lengths


def group_by_doc(doc: np.ndarray, lines: list[bytes], lo: int, hi: int) -> list[tuple[int, bytes, int]]:
    """Ops [lo, hi) as (doc, that doc's lines joined, op count), by doc.
    A stable sort keeps each doc's ops in their order."""
    if hi <= lo:
        return []
    d = doc[lo:hi]
    order = np.argsort(d, kind="stable")
    ds = d[order]
    cut = np.flatnonzero(np.diff(ds)) + 1
    starts = np.concatenate(([0], cut))
    ends = np.concatenate((cut, [len(ds)]))
    out = []
    for a, b in zip(starts.tolist(), ends.tolist()):
        idx = order[a:b] + lo
        out.append((int(ds[a]), b"".join([lines[i] for i in idx.tolist()]), b - a))
    return out


class Backlog:
    """A fleet's boot and the backlog it replays: ``boot[d]`` is doc d's
    lines ingested in set-up, each unit a list of (doc, lines, ops), one
    entry a doc in doc order, ingested before one step."""

    def __init__(self, p: dict, n_docs: int, rng: np.random.Generator):
        self.boot = boot_blobs(p, n_docs, rng)
        sr = StringRounds(p, n_docs, int(p["rounds"]), rng)
        every = int(p["step_every"])
        ends = [0] + sr.round_end[every - 1::every]
        if ends[-1] != sr.round_end[-1]:
            ends.append(sr.round_end[-1])
        self.units = [group_by_doc(sr.doc, sr.line, lo, hi) for lo, hi in zip(ends, ends[1:])]
        self.unit_ops = [sum(n for _d, _b, n in u) for u in self.units]

    def doc_lines(self, doc: int, n_units: int) -> bytes:
        """Doc ``doc``'s boot lines and its lines of the first ``n_units`` units."""
        parts = [self.boot[doc]]
        for u in self.units[:n_units]:
            parts.extend(b for d, b, _n in u if d == doc)
        return b"".join(parts)

    def doc_ops(self, n_docs: int, n_units: int) -> np.ndarray:
        """Ops per doc in the first ``n_units`` units."""
        out = np.zeros(n_docs, np.int64)
        for u in self.units[:n_units]:
            for d, _b, n in u:
                out[d] += n
        return out


class Schedule:
    """An open loop: ops in due order (``due`` seconds after the window
    opens), each a wire line of doc ``doc``; ``boot`` as in ``Backlog``.
    Round k's ops are due inside [k, k + 1) round intervals, each at a
    uniform time, a doc's ops at increasing times in sequence order."""

    def __init__(self, p: dict, n_docs: int, rate: float, seconds: float,
                 rng: np.random.Generator):
        self.boot = boot_blobs(p, n_docs, rng)
        per_round = zipf_counts(n_docs, int(p["head_ops"]), float(p["zipf_a"])).sum()
        interval = per_round / rate
        rounds = int(np.ceil(seconds / interval)) + 1
        sr = StringRounds(p, n_docs, rounds, rng)
        starts = np.concatenate(([0], sr.round_end[:-1]))
        due = np.empty(len(sr.line))
        for k, (lo, hi) in enumerate(zip(starts.tolist(), sr.round_end)):
            times = (k + rng.random(hi - lo)) * interval
            d, s = sr.doc[lo:hi], sr.seq[lo:hi]
            # Both orders group by doc alike, so a doc's i-th op in
            # sequence order takes the doc's i-th time.
            due[lo + np.lexsort((s, d))] = times[np.lexsort((times, d))]
        order = np.argsort(due, kind="stable")
        self.due = due[order]
        self.doc = sr.doc[order]
        self.line = [sr.line[i] for i in order.tolist()]

    def doc_lines(self, doc: int, n_ops: int) -> bytes:
        """Doc ``doc``'s boot lines and its lines among the first ``n_ops`` ops."""
        idx = np.flatnonzero(self.doc[:n_ops] == doc)
        return self.boot[doc] + b"".join(self.line[i] for i in idx.tolist())

    def doc_ops(self, n_docs: int, n_ops: int) -> np.ndarray:
        """Ops per doc among the first ``n_ops`` ops."""
        return np.bincount(self.doc[:n_ops], minlength=n_docs)
