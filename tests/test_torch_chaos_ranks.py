"""The chaos stack's tree tier over a rank mesh, one rank a card, against
the JAX package.

Each world is real: ``run_world`` (``tests/test_torch_cross_card.py``)
starts one process a rank (``tests/torch_rank_worker.py``, which blocks
JAX) in a gloo group over a ``file://`` store, with a timeout on the group
and on the world; each world runs once a session and is shared by the
xdist workers.  Every rank calls ``run_chaos(tree_mesh=rank_mesh())`` with
the same arguments: rank 0 runs the whole stack and decides every fault,
the others serve their shard of the tree engine (``serve_tree_rank``).
Rank 0 hands back each document's sequenced log (wire JSON) and the
fleet's tree JSON, and this process computes the reference's oracles over
that log (``ref_chaos.ChaosStack.oracle_text`` / ``oracle_tree_json``, as
``tests/test_torch_chaos.py`` does).  Tolerance: exact (texts, tree JSON,
counters).

- the reference's mixed-fleet smoke (``tests/test_chaos.py:502``: seed 16,
  30 ticks, 2 string docs, standbys, ``ckpt_stale_seconds=0.25``, its
  schedule) with 4 tree docs over 2 and over 4 ranks: the reference's
  assertions, a migration that crosses ranks (``shard_of`` before and
  after), and the reference's oracles over the port's log;
- a cold ``fleet_kill`` (no standby) over 2 ranks, so
  ``restore_from_checkpoints`` runs over ranks, against a one-process
  stack (``tree_shards=1``) on the same schedule;
- the refusals, and rank 0 raising mid-run;
- ``fleet_main --family tree --mesh 2`` under ``torch.distributed.run``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import torch_rank_worker as rw
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefTreeEngine
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.testing import chaos as ref_chaos
from fluidframework_tpu_torch.testing import chaos as port_chaos
from test_torch_cross_card import ROOT, TREE, WORKER, WORLD_TIMEOUT_S, _shared, run_world
from test_torch_fleet_consumer import _StubShard
from test_tree_batch_engine import drive_tree_docs

# tests/test_chaos.py:502-539, with 4 tree docs so every rank of 2 or 4
# holds a row and the migrations cross ranks.
SMOKE_EVENTS = [(5, "nack_storm", "cd0", 4), (8, "migrate", "td1", 0), (12, "fleet_kill", "", 0),
                (18, "torn_socket", "td0", 0), (22, "migrate", "td0", 0)]
SMOKE_KW = dict(seed=16, ticks=30, n_docs=2, n_tree_docs=4, standby=True,
                ckpt_stale_seconds=0.25)
# A cold kill: no standby and no staleness sweeps, so the tree tier
# restores from its cadence checkpoints over the ranks.
COLD_EVENTS = [(12, "fleet_kill", "", 0)]
COLD_KW = dict(seed=16, ticks=30, n_docs=2, n_tree_docs=4, checkpoint_every=2)
ABORT_TIMEOUT_S = 60


def _cold_inputs(workdir: Path) -> dict:
    return {"kw": dict(COLD_KW, workdir=str(workdir)), "events": COLD_EVENTS}


@pytest.fixture(scope="module")
def chaos2(tmp_path_factory):
    def make(d: Path):
        cases = [("chaos", {"kw": SMOKE_KW, "events": SMOKE_EVENTS}),
                 ("chaos_cold", _cold_inputs(d / "cold"))]
        return {"ranks": run_world(d, 2, cases), "cold": str(d / "cold")}

    return _shared(tmp_path_factory, "chaos_ranks2", make)


@pytest.fixture(scope="module")
def chaos4(tmp_path_factory):
    def make(d: Path):
        return {"ranks": run_world(d, 4, [("chaos", {"kw": SMOKE_KW, "events": SMOKE_EVENTS})])}

    return _shared(tmp_path_factory, "chaos_ranks4", make)


def _ref_oracles(logs: dict, doc_ids, tree_ids, upto: dict | None = None) -> tuple[dict, dict]:
    """The reference ``ChaosStack``'s oracles over the port's logs (wire
    JSON read back as the reference's messages); ``upto`` cuts a doc's log
    at a seq."""
    upto = upto or {}
    docs = {d: SimpleNamespace(sequencer=SimpleNamespace(log=[
        m for m in (RefMsg.from_json(x) for x in log) if m.seq <= upto.get(d, m.seq)]))
        for d, log in logs.items()}
    shim = SimpleNamespace(plane=SimpleNamespace(nexus=SimpleNamespace(
        lock=contextlib.nullcontext()), service=SimpleNamespace(document=docs.__getitem__)))
    texts = {d: ref_chaos.ChaosStack.oracle_text(shim, d) for d in doc_ids}
    trees = {d: ref_chaos.ChaosStack.oracle_tree_json(shim, d) for d in tree_ids}
    return texts, trees


def _untimed(log: list) -> list:
    """A log's messages without their server timestamps."""
    return [{k: v for k, v in json.loads(x).items() if k != "timestamp"} for x in log]


def _ids(kw: dict) -> tuple[list, list]:
    return ([f"cd{i}" for i in range(kw["n_docs"])], [f"td{i}" for i in range(kw["n_tree_docs"])])


# ------------------------------------------------------------------ smoke
@pytest.mark.parametrize("world", [2, 4])
def test_mixed_fleet_smoke_over_ranks(world, chaos2, chaos4):
    """The reference's mixed-fleet smoke with the tree tier over ``world``
    ranks: both families converge, no double acks, bounded queues, one
    fleet restart, a standby promotion per family, real migrations (every
    move from one rank's block to another's), no open incident, one shard a
    rank; every follower served its shard and made rank 0's collectives."""
    ranks = (chaos2 if world == 2 else chaos4)["ranks"]
    report = ranks[0]["chaos"]["out"]
    inv, c, rec, tree = report["invariants"], report["counters"], report["recovery"], report["tree"]
    assert inv["converged_docs"] == 2 and inv["tree_converged_docs"] == 4
    assert inv["double_acks"] == 0
    assert inv["max_queue_depth"] <= inv["queue_depth_bound"]
    assert inv["max_tree_queue_depth"] <= inv["tree_queue_depth_bound"]
    assert c["fleet_restarts"] == 1 and c["standby_promotions"] == 2
    assert c["doc_migrations"] >= 1
    assert rec["standby"] is True and rec["open"] == 0 and rec["tree_open"] == 0
    assert rec["incidents"] >= 1 and rec["tree_incidents"] >= 1
    assert 0 < rec["tree_recovery_p99_ms"] <= inv["recovery_bound_ms"]
    assert tree["n_docs"] == 4 and tree["n_shards"] == world == tree["health"]["n_shards"]
    # A shard is a rank: both moves left the doc's first placement (2 docs
    # a rank of 2, one a rank of 4) for another rank.  The kill at tick 12
    # promotes a standby placed as at the start, so the final placement is
    # the start's with the move after it (td0 at tick 22).
    moves = tree["moves"]
    start = {f"td{i}": (i if world == 4 else i // 2) for i in range(4)}
    assert [m[0] for m in moves] == ["td1", "td0"] and c["doc_migrations"] == 2
    assert all(src == start[d] != dst for d, src, dst in moves), moves
    shards = dict(start, td0=moves[-1][2])
    assert ranks[0]["chaos"]["shards"] == [shards[f"td{i}"] for i in range(4)]
    lead = tree["rank"]
    for r, out in enumerate(x["chaos"]["out"] for x in ranks[1:]):
        assert out["rank"] == r + 1 and out["steps"] == lead["steps"] > 0
        # The followers also received the spec and the closing action.
        assert out["collectives"] == lead["collectives"] + 1


@pytest.mark.parametrize("world", [2, 4])
def test_reference_oracles_over_the_ports_log(world, chaos2, chaos4):
    """The reference's fault-free oracles over rank 0's sequenced log equal
    the fleet's texts and every tree doc's JSON (exact)."""
    got = (chaos2 if world == 2 else chaos4)["ranks"][0]["chaos"]
    doc_ids, tree_ids = _ids(SMOKE_KW)
    texts, trees = _ref_oracles(got["logs"], doc_ids, tree_ids)
    assert sum(len(t) for t in texts.values()) > 0 and all(trees.values())
    assert got["texts"] == [texts[d] for d in doc_ids]
    assert got["trees"] == [trees[d] for d in tree_ids]


# ------------------------------------------------------------- cold kill
@pytest.fixture(scope="module")
def cold_one(tmp_path_factory):
    """The cold-kill schedule on a one-process stack (``tree_shards=1``)."""
    d = tmp_path_factory.mktemp("cold_one")
    out = rw.chaos_run({**_cold_inputs(d), "kw": dict(_cold_inputs(d)["kw"], tree_shards=1)})
    return out, d


def test_cold_kill_restores_over_ranks(chaos2, cold_one):
    """A ``fleet_kill`` with no standby: each rank of 2 restores the tree
    tier from the shared store (``restore_from_checkpoints`` over ranks) and
    the run converges to the reference's oracles; each rank wrote the
    records of the docs it owned, so the store holds every doc, each record
    the reference's oracle over the log up to its seq.  Against the
    one-process stack (``tree_shards=1``) on the same schedule, for the
    docs whose logs are the same: the same trees, and the same record bytes
    where the two records stand at one seq (the seq a record lands at
    follows the pumps' timing; at this cadence, every op a record, they
    meet at each doc's last op)."""
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    ranked = chaos2["ranks"][0]["chaos_cold"]
    one, one_dir = cold_one
    doc_ids, tree_ids = _ids(COLD_KW)
    for got in (ranked, one):
        rep = got["out"]
        assert rep["counters"]["fleet_restarts"] == 1
        assert rep["counters"]["standby_promotions"] == 0
        assert rep["recovery"]["tree_incidents"] >= 1 and rep["recovery"]["tree_open"] == 0
        assert rep["tree"]["health"].get("docs_restored", 0) >= 1
    assert ranked["out"]["tree"]["n_shards"] == 2 and one["out"]["tree"]["n_shards"] == 1
    dirs = {"ranks": chaos2["cold"], "one": str(one_dir)}
    files = {}
    for name, got in (("ranks", ranked), ("one", one)):
        store = CheckpointStore(os.path.join(dirs[name], "tree-checkpoints"))
        recs = {d: store.load(d) for d in tree_ids}
        assert all(r is not None and r["engine"] == "tree_batch" for r in recs.values()), name
        _texts, want = _ref_oracles(got["logs"], [], tree_ids,
                                    upto={d: r["seq"] for d, r in recs.items()})
        for d, rec in recs.items():
            assert rec["lane"] == "device" and rec["forest"]["root"] == want[d], (name, d)
        texts, trees = _ref_oracles(got["logs"], doc_ids, tree_ids)
        assert got["texts"] == [texts[d] for d in doc_ids], name
        assert got["trees"] == [trees[d] for d in tree_ids], name
        files[name] = {d: (recs[d]["seq"], Path(store._read_path(d)).read_bytes())
                       for d in tree_ids}
    same = [d for d in tree_ids if _untimed(ranked["logs"][d]) == _untimed(one["logs"][d])]
    assert same, "no tree doc's log is the same in both runs"
    at_one_seq = [d for d in same if files["ranks"][d][0] == files["one"][d][0]]
    assert at_one_seq, "no record of a doc with the same log stands at the same seq"
    for d in same:
        i = tree_ids.index(d)
        assert ranked["trees"][i] == one["trees"][i], d
    assert [d for d in at_one_seq if files["ranks"][d][1] != files["one"][d][1]] == []


# -------------------------------------------------------------- refusals
def test_rank_mesh_tree_tier_refusals(tmp_path):
    """In a one-rank gloo world of this process: ``tree_mesh`` with
    ``tree_shards > 1`` (``run_chaos``, ``run_soak``, ``ChaosStack``), a
    ``BackgroundCheckpointWriter`` on a rank-mesh tree engine, and
    ``WarmStandby.watch`` on one (its message names ``trail``)."""
    import torch.distributed as dist

    from fluidframework_tpu_torch.models.recovery import BackgroundCheckpointWriter
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import rank_mesh
    from fluidframework_tpu_torch.server.failover import WarmStandby
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = rank_mesh()
        for call in (
            lambda: port_chaos.run_chaos(n_tree_docs=2, tree_mesh=mesh, tree_shards=8,
                                         device="cpu"),
            lambda: port_chaos.run_soak(n_tree_docs=2, tree_mesh=mesh, tree_shards=2,
                                        device="cpu"),
            lambda: port_chaos.ChaosStack(0, ["cd0"], str(tmp_path), tree_doc_ids=["td0"],
                                          tree_mesh=mesh, tree_shards=4, device="cpu"),
        ):
            with pytest.raises(ValueError, match="tree_shards"):
                call()
        eng = TreeBatchEngine(2, mesh=mesh, checkpoint_store=CheckpointStore(str(tmp_path)),
                              capacity=64, pool_capacity=256)
        with pytest.raises(ValueError, match="rank mesh"):
            BackgroundCheckpointWriter(eng, max_seconds_behind=0.25)
        with pytest.raises(ValueError, match="trail"):
            WarmStandby(eng, eng.checkpoint_store, lease=None).watch()
    finally:
        dist.destroy_process_group()


def test_followers_exit_when_rank_zero_raises(tmp_path):
    """Rank 0 raising mid-run (an unknown fault kind at tick 10) sends
    ``abort``: every rank exits non-zero well inside the subprocess
    timeout, not after the group's timeout, and each follower says why."""
    world = 2
    d = tmp_path / "abort"
    d.mkdir()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump([("chaos", {"kw": SMOKE_KW, "events": SMOKE_EVENTS, "raise_at": 10})], f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(WORKER.parent)]))
    errs = [open(d / f"rank{r}.err", "w+") for r in range(world)]
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(d), str(r), str(world)],
                              env=env, stdout=subprocess.DEVNULL, stderr=errs[r])
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=ABORT_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    took = time.monotonic() - t0
    assert all(rc != 0 for rc in rcs), rcs
    assert took < rw.TIMEOUT_S, took
    tails = []
    for e in errs:
        e.seek(0)
        tails.append(e.read())
    assert "unknown chaos event kind" in tails[0], tails[0][-2000:]
    assert "aborted" in tails[1], tails[1][-2000:]


# ------------------------------------------------------------ fleet_main
def test_fleet_main_tree_family_over_two_gloo_ranks():
    """``fleet_main --family tree --mesh 2`` under ``torch.distributed.run``
    with 2 gloo ranks, fed the tree traffic of
    ``test_tree_engine_over_ranks_matches_reference`` by a firehose: rank 0
    alone prints (one ``ready``, one ``done``), and the done line's trees
    equal a port ``TreeBatchEngine`` on the CPU fed the same bytes and the
    reference engine's JSON."""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    svc, _expected = drive_tree_docs(TREE["n_docs"], TREE["seed"], TREE["steps"])
    logs = {f"t{d}": svc.document(f"doc{d}").sequencer.log for d in range(TREE["n_docs"])}
    wire = {doc: b"".join(m.wire_line() for m in log) for doc, log in logs.items()}
    kw = dict(TREE["kw"], max_insert_len=8)
    eng = TreeBatchEngine(len(wire), device="cpu", **kw)
    rows = sum(eng.ingest_lines(d, data) for d, data in enumerate(wire.values()))
    eng.step()
    ref = RefTreeEngine(len(logs), **TREE["kw"])
    for d, log in enumerate(logs.values()):
        for m in log:
            ref.ingest(d, RefMsg.from_json(m.to_json()))
    ref.step()
    shard = _StubShard(lambda doc, _f: wire[doc])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "fluidframework_tpu_torch.server.fleet_main", "--device", "cpu", "--mesh", "2",
           "--family", "tree", "--port", str(shard.port), "--docs", ",".join(wire),
           "--max-insert-len", "8", "--capacity", str(kw["capacity"]),
           "--pool-capacity", str(kw["pool_capacity"]), "--ops-per-step", str(kw["ops_per_step"]),
           "--status-every", "60", "--exit-after-rows", str(rows)]
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=WORLD_TIMEOUT_S,
                              env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    finally:
        shard.close()
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [x for x in lines if x.get("ready")] == [
        {"ready": True, "family": "tree", "docs": list(wire), "port": shard.port}]
    done = [x for x in lines if x.get("done")]
    assert len(done) == 1
    done = done[0]
    assert done["rows"] == rows and done["errors"] == 0 and done["health"]["n_shards"] == 2
    assert done["trees"] == {doc: eng.tree_json(d) for d, doc in enumerate(wire)}
    assert done["trees"] == {doc: ref.tree_json(d) for d, doc in enumerate(wire)}
