"""Each cell's capacity margin: over all the traffic a run can apply (the
catch-up's whole backlog; the live cell's rounds at its rate over the
longest window a run may have), no doc's text pool or segment table
reaches the configuration's capacity, whatever the seed.

The ranking moves by a fixed stride through a seeded order, so the set
of each doc's per-round op counts is the same for every seed: every
start place of the order is checked.  A writer alternates insert and
remove, starting with an insert, so a doc with n ops has at most
(n + writers) // 2 of either.  Text is counted as every char ever
inserted (the pool is append-only).  Segments: one a prefix append, at
most two more an insert (the new one and the split it lands in), one a
remove once compaction has evicted the removed piece, and one more for
each remove of the last ``RECENT_ROUNDS`` rounds (before that eviction,
which waits for the MSN to pass the remove and for the next compact:
two catch-up units, or two seconds of the live cell's arrivals, longer
than any of its steps).  All are upper bounds."""

import numpy as np
import pytest

from fleetbench import spec
from fleetbench import traffic as tr

WINDOW_S = 51.0  # the longest run_seconds the contract allows
RECENT_ROUNDS = 16


def _rounds(name: str, p: dict, n: int) -> int:
    if "rounds" in p:
        return int(p["rounds"])
    cell = spec.load("workloads", name)
    per_round = tr.zipf_counts(n, int(p["head_ops"]), float(p["zipf_a"])).sum()
    return int(np.ceil(cell["rate_ops_per_s"] * WINDOW_S / per_round)) + 1


def upper_use(p: dict, n_docs: int, rounds: int):
    """The most text and segments any doc can hold, over all start places."""
    order = np.arange(n_docs)
    per_round = np.stack([tr.round_counts(p, n_docs, order, r) for r in range(rounds)])
    W = int(p["writers"])
    ops = per_round.sum(axis=0)
    most = (ops + W) // 2
    recent_rounds = min(rounds, RECENT_ROUNDS)
    csum = np.concatenate([np.zeros((1, n_docs), np.int64), np.cumsum(per_round, axis=0)])
    recent = (csum[recent_rounds:] - csum[:-recent_rounds]).max(axis=0)
    text = int(p["prefix_ops"]) * int(p["prefix_len"]) + int(p["insert_len"]) * most
    segs = int(p["prefix_ops"]) + 2 * most + most + np.minimum(recent, most)
    return int(text.max()), int(segs.max())


@pytest.mark.parametrize("name", ["string_fleet_10k.catchup", "string_fleet_10k.live"])
def test_cell_stays_inside_its_geometry(name):
    cell = spec.load("workloads", name)
    g = spec.load("configs", cell["config"])["engine"]
    p = spec.load("traffic", cell["traffic"])
    text, segs = upper_use(p, g["n_docs"], _rounds(name, p, g["n_docs"]))
    assert text < g["text_capacity"], (text, g["text_capacity"])
    assert segs < g["max_segments"], (segs, g["max_segments"])
