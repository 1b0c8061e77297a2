"""``chip_smoke.py`` phases 24 (``cross_card``) and 25 (``chaos_ranks``) on
the CPU at a small size.

The phase's own code and checks run here as on the card: 4 gloo ranks,
each a process of its own with its own rows, serve 64 docs of config 3's
traffic, a hot doc on a 4-rank lane, a cross-rank migration and the long
document, held against the parent's one-card engine (every row and latch
by digest, the lane, the texts, the error counts, the migration) and the
long-document answers against K1's plain version.  The ranks count their
launches on the CPU too (the card's counters count only CUDA calls), and
each rank must have launched K2, K3, K6, its compaction and K1.  Then the
phase's entry-point check (``phase_cross_entry``, which ``--only
cross_card`` runs over NCCL on the cards) over 2 gloo ranks, its string
and tree legs; and phase 25 at its own size over 4 gloo ranks, whose ranks
count K7's and K8's CPU calls as launches.

Tolerance: exact.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SIZES = dict(n_docs=64, rounds=4, hot_rounds=8, spare=8, sample=8, long_S=4096, long_Q=32,
             coll_iters=20)
# A rank that counts its programs' CPU calls as launches, then runs as the
# phase's own rank does.
COUNTING_RANK = """\
from fluidframework_tpu_torch.ops import mergetree_kernel as mk
from fluidframework_tpu_torch.ops import resolve_kernel as rk
mk.count_launch = lambda x, fn: setattr(fn, "launches", fn.launches + 1)
_plain = rk.resolve_positions_plain
def _counted(*args, **kw):
    rk.resolve_positions.launches += 1
    return _plain(*args, **kw)
rk.resolve_positions_plain = _counted
""" + chip_smoke._CROSS_CHILD


def test_phase_cross_card_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_CROSS_CHILD", COUNTING_RANK)
    line = chip_smoke.phase_cross_card(0, "cpu", device="cpu", sizes=SIZES)
    assert (line["backend"], line["ranks"], line["cards"]) == ("gloo", 4, 0)
    assert line["rank_devices"] == ["cpu"] * 4
    assert line["identical_rows"] == line["capacity"] == 4 * line["docs_per_rank"]
    assert line["sampled_texts"] == SIZES["sample"]
    assert line["migrated"]["from"] != line["migrated"]["to"]
    assert [r["rank"] for r in line["ranks_detail"]] == [0, 1, 2, 3]
    for r in line["ranks_detail"]:
        assert set(r["launches"]) == set(chip_smoke._cross_programs())
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
        assert r["lane_dispatches"] > 0 and r["collectives_per_dispatch"] > 0
        assert r["k6"]["shape"][0] == 4


def test_phase_cross_entry_on_cpu():
    """The entry-point check over 2 gloo ranks: ``fleet_main --mesh 2``
    under ``torch.distributed.run`` fed config 3's traffic for 8 docs by
    the phase's firehose, its texts against an engine fed the same bytes;
    then its tree leg, ``--family tree`` fed the first 8 docs and 2 rounds
    of tree_fleet's stream at 16 docs, its trees against an engine's."""
    geom = dict(chip_smoke.FLEET_GEOM, max_segments=128, text_capacity=1024)
    line = chip_smoke.phase_cross_entry("cpu", "cpu", 2, sizes=dict(n_docs=8, rounds=2),
                                        geom=geom,
                                        tree_sizes=dict(fleet_docs=16, n_docs=8, rounds=2))
    assert (line["device"], line["ranks"], line["lines"]) == ("cpu", 2, 2)
    assert line["rows"] > 0
    assert (line["tree"]["docs"], line["tree"]["lines"]) == (8, 2) and line["tree"]["rows"] > 0


# A chaos rank that counts K7's and K8's CPU calls as launches.
COUNTING_CHAOS_RANK = """\
from fluidframework_tpu_torch.ops import tree_kernel as tk
tk.count_launch = lambda x, fn: setattr(fn, "launches", fn.launches + 1)
""" + chip_smoke._CHAOS_RANKS_CHILD


def test_phase_chaos_ranks_on_cpu(monkeypatch):
    """Phase 25 (``chaos_ranks``) over 4 gloo ranks on the CPU at its own
    size: the reference's mixed-fleet smoke with 8 tree docs, the tree
    tier one shard a rank; the phase's checks hold (invariants, one
    restart with two promotions, a move across ranks, every follower in
    step with rank 0), and every rank launched K7 and K8."""
    monkeypatch.setattr(chip_smoke, "_CHAOS_RANKS_CHILD", COUNTING_CHAOS_RANK)
    paths = {"apply_nested_megastep": {}, "compact_nested": {}}
    line = chip_smoke.phase_chaos_ranks("cpu", device="cpu", paths=paths)
    assert (line["backend"], line["ranks"], line["cards"]) == ("gloo", 4, 0)
    assert [r["rank"] for r in line["ranks_detail"]] == [0, 1, 2, 3]
    for r in line["ranks_detail"]:
        assert r["device"] == "cpu" and r["steps"] > 0
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
    assert line["counters"]["standby_promotions"] == 2 and line["collectives_per_tick"] > 0
    assert paths["apply_nested_megastep"]["chaos_ranks"] >= 4
