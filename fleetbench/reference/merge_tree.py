"""Plain SharedString replica: the merge-tree semantics of FluidFramework's
``Client.applyMsg`` for sequenced inserts and removes, one character at a
time, over NumPy columns.  It imports nothing of the program under test.

- A character is present from perspective (ref_seq, client) when its
  insert has occurred there (sequence number <= ref_seq, or made by that
  client) and no remove of it has occurred there.
- An insert at position p of the inserter's view lands right after the
  p-th character present in that view, so in front of every character the
  inserter cannot see at that point: of concurrent inserts at one place,
  the later sequenced sits to the left (merge-tree's ``breakTie``).
- A remove of [p1, p2) marks the characters present in the remover's view
  in that range; a character stays removed once any remove marks it.
- The text is every character that no remove has marked.

Per character the replica keeps its insert's sequence number and client,
the least sequence number of the removes that marked it and a bit per
client that marked it: enough to say whether a remove has occurred from
any perspective.
"""

from __future__ import annotations

import json

import numpy as np

NEVER = np.iinfo(np.int64).max


class StringReplica:
    def __init__(self) -> None:
        self.ch = np.zeros(0, np.uint8)
        self.seq = np.zeros(0, np.int64)
        self.client = np.zeros(0, np.int64)
        self.rem_seq = np.zeros(0, np.int64)
        self.rem_by = np.zeros(0, np.uint64)
        self.last_seq = 0
        self.clients: dict[str, int] = {}

    def apply_line(self, line: bytes) -> None:
        m = json.loads(line)
        seq = m["sequenceNumber"]
        if m["type"] == "join":
            cid = m["contents"]["clientId"]
            if len(self.clients) == 64 and cid not in self.clients:
                raise ValueError("more than 64 clients")
            self.clients.setdefault(cid, len(self.clients))
            return
        if m["type"] != "op":
            return
        if seq <= self.last_seq:
            raise ValueError(f"sequence number {seq} after {self.last_seq}")
        if m["clientId"] not in self.clients:
            raise ValueError(f"op from unjoined client {m['clientId']}")
        client, ref = self.clients[m["clientId"]], m["referenceSequenceNumber"]
        self.last_seq = seq
        c = m["contents"]
        if c["type"] == 0:
            self._insert(c["pos1"], c["seg"], seq, client, ref)
        elif c["type"] == 1:
            self._remove(c["pos1"], c["pos2"], seq, client, ref)
        else:
            raise ValueError(f"op type {c['type']} is not in this reference")

    def _present(self, ref: int, client: int) -> np.ndarray:
        """Indices of the characters present from (ref, client)."""
        bit = np.uint64(1 << client)
        seen = (self.seq <= ref) | (self.client == client)
        removed = (self.rem_seq <= ref) | ((self.rem_by & bit) != 0)
        return np.flatnonzero(seen & ~removed)

    def _insert(self, pos: int, text: str, seq: int, client: int, ref: int) -> None:
        at = 0
        if pos:
            idx = self._present(ref, client)
            if len(idx) < pos:
                raise ValueError(f"insert at {pos} past the view's {len(idx)} characters")
            at = int(idx[pos - 1]) + 1
        n = len(text)
        self.ch = np.insert(self.ch, at, np.frombuffer(text.encode(), np.uint8))
        self.seq = np.insert(self.seq, at, np.full(n, seq))
        self.client = np.insert(self.client, at, np.full(n, client))
        self.rem_seq = np.insert(self.rem_seq, at, np.full(n, NEVER))
        self.rem_by = np.insert(self.rem_by, at, np.zeros(n, np.uint64))

    def _remove(self, p1: int, p2: int, seq: int, client: int, ref: int) -> None:
        idx = self._present(ref, client)
        if len(idx) < p2:
            raise ValueError(f"remove of [{p1}, {p2}) past the view's {len(idx)} characters")
        hit = idx[p1:p2]
        self.rem_seq[hit] = np.minimum(self.rem_seq[hit], seq)
        self.rem_by[hit] |= np.uint64(1 << client)

    def text(self) -> str:
        return self.ch[self.rem_seq == NEVER].tobytes().decode()


def replay(data: bytes) -> str:
    """The text after applying a doc's wire lines in order."""
    rep = StringReplica()
    for line in data.split(b"\n"):
        if line.strip():
            rep.apply_line(line)
    return rep.text()
