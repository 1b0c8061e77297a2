"""The port's cross-card meshes, one rank a card, against the JAX package.

Each world is real: ``run_world`` starts one process a rank
(``tests/torch_rank_worker.py``) in a gloo group over a ``file://`` store
in the test's temporary directory, every rank on the CPU with its own
rows, with a timeout on ``init_process_group`` and on the world; a rank's
traceback fails the test.  One world runs several checks, and each world
runs once a session (the first xdist worker to need it makes it under a
file lock, the others read its results).  Every comparison is exact.

- a 4-rank world: ``ProcessShardGroup`` against ``StackedShardGroup``
  member by member; the segment megastep and compaction (seeds 0 and 2,
  with obliterates) against the reference's 4-device ``mesh_seg_program``;
  the long-document plane against the reference's ``make_sharded_ops``;
  ``DocBatchEngine`` on a Zipf stream with obliterates, a quarantine and
  overflow lanes against the reference engine (``use_mesh=False``): every
  doc's raw columns and latch, texts, ``error_count`` and the checkpoint
  files byte for byte; the per-shard obliterate gate; a cross-rank
  migration;
- a 2-rank world: the group and the long-document plane again, the
  4-rank store restored into 2 ranks (and in this process into one), and
  ``TreeBatchEngine`` with a cross-rank migration against the reference;
- ``fleet_main`` under ``torch.distributed.run`` with 2 gloo ranks against
  the port's netserver.
"""

from __future__ import annotations

import fcntl
import importlib
import json
import os
import pickle
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fluidframework_tpu.dds import kernel_backend as rkb
from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefTreeEngine
from fluidframework_tpu.ops import mergetree_kernel as mk
from fluidframework_tpu.parallel import long_doc as rld
from fluidframework_tpu.parallel import mesh as pm
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.protocol.stamps import ALL_ACKED
from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
from fluidframework_tpu_torch.dds import kernel_backend as tkb
from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.parallel.mesh import doc_mesh
from fluidframework_tpu_torch.protocol.messages import SequencedMessage as PortMsg
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

import torch_rank_worker as rw
from test_long_doc import build_doc
from test_segment_parallel import four_writer_trace
from test_torch_mergetree_kernel import assert_states_equal
from test_tree_batch_engine import drive_tree_docs

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_rank_worker.py")
WORLD_TIMEOUT_S = 150
SEG = (64, 1024, 8)          # the lane's S, T, OB
SEG_B = 8
VIEWS = ((ALL_ACKED, -2), (70, 0))
MARK = (30, 90, 500, 3, ALL_ACKED, -2)
ENGINE = dict(n_docs=16, rounds=6, seed=0, poison=(3, 2), big=(5, 3),
              kw=dict(watchdog_every=2))
GATE = dict(n_docs=16, rounds=4, seed=1, ob_docs=(8, 9, 10, 11))   # shard 2 of 4
MIGRATE = dict(n_docs=16, rounds=8, seed=3, doc=2, spare=8)
# The reference engines run K=1 megasteps (the ranks K=2): the slices a
# dispatch fuses change no byte, and each reference megastep depth costs a
# cold XLA compile of tens of seconds on the CPU.
REF_GEOM = {**rw.GEOM, "megastep_k": 1}
TREE = dict(n_docs=4, seed=5, steps=6, doc=1,
            kw=dict(capacity=128, pool_capacity=512, ops_per_step=8))


# --------------------------------------------------------------- the worlds
def run_world(world_dir: Path, world: int, cases: list) -> list[dict]:
    """Start ``world`` ranks running ``cases`` and return each rank's
    results; a rank that exits non-zero (its traceback in the failure) or
    a world past ``WORLD_TIMEOUT_S`` ends every rank and fails."""
    world_dir.mkdir(parents=True, exist_ok=True)
    with open(world_dir / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(WORKER.parent)]))
    errs = [open(world_dir / f"rank{r}.err", "w+") for r in range(world)]
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(world_dir), str(r), str(world)],
                         env=env, stdout=subprocess.DEVNULL, stderr=errs[r])
        for r in range(world)
    ]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        logs = []
        for r in failed:
            errs[r].seek(0)
            logs.append(f"rank {r} (rc {procs[r].returncode}):\n{errs[r].read()[-4000:]}")
        pytest.fail(f"{world}-rank world failed:\n" + "\n".join(logs))
    out = []
    for r in range(world):
        with open(world_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    assert [o["leaked"] for o in out] == [[]] * world  # no rank imported JAX
    return out


def _shared(tmp_path_factory, name: str, make):
    """``make(directory)`` once a session, its result shared between xdist
    workers through a pickle under a file lock."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = shared / f"cross_card_{name}.pkl"
    with open(shared / f"cross_card_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                result = make(shared / f"cross_card_{name}")
                tmp = out.with_suffix(f".{os.getpid()}")
                tmp.write_bytes(pickle.dumps(result))
                tmp.replace(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return pickle.loads(out.read_bytes())


def _stacks(world: int) -> list:
    rng = np.random.default_rng(world)
    return [rng.integers(-50, 50, (world, k)).astype(np.int32) for k in (1, 3, 5)]


def _seg_traces() -> dict:
    """Per seed: a 4-writer trace's first half applied to one document by
    the reference, that document re-blocked over 4 segment shards (as a
    promotion mid-stream does: live segments spread evenly), and the
    second half (with its obliterates) as a [K, 8] ring."""
    out = {}
    S, T, OB = SEG
    for seed in (0, 2):
        ops, pays = four_writer_trace(seed, n_rounds=5)
        n = int(np.flatnonzero(ops[:, 0]).max()) + 1
        cut = n // 2
        single = jax.jit(mk.apply_ops)(mk.init_state(S, 4, 4, T, OB), jnp.asarray(ops[:cut]),
                                       jnp.asarray(pays[:cut]))
        blocked = mk.seg_shard_state(jax.tree.map(np.asarray, single), 4)
        ops, pays = ops[cut:n], pays[cut:n]
        assert (ops[:, 0] == mk.OpKind.OBLITERATE).any()
        pad = -len(ops) % SEG_B
        ops = np.concatenate([ops, np.repeat(np.asarray(mk.make_noop())[None], pad, 0)])
        pays = np.concatenate([pays, np.zeros((pad, pays.shape[1]), pays.dtype)])
        out[seed] = (tk.DocState(**blocked._asdict()),
                     ops.reshape(-1, SEG_B, mk.OP_FIELDS).astype(np.int32),
                     pays.reshape(-1, SEG_B, pays.shape[-1]).astype(np.int32))
    return out


def _long_doc_inputs() -> dict:
    ref = jax.tree.map(np.asarray, build_doc(n_segs=48, seg_len=3, removed_every=5,
                                              capacity=64))
    state = tk.DocState(**ref._asdict())  # the port's type: a rank imports no reference
    rng = np.random.default_rng(7)
    queries = np.concatenate([rng.integers(0, 140, 40), [-1, 0, 200]]).astype(np.int32)
    return {"state": state, "queries": queries, "views": VIEWS, "mark": MARK}


def _engine_rounds(p: dict) -> list:
    return rw.zipf_stream(p["n_docs"], p["rounds"], p["seed"], ob_docs=p.get("ob_docs"),
                          poison=p.get("poison"), big=p.get("big"))


def _tree_logs() -> list:
    svc, _expected = drive_tree_docs(TREE["n_docs"], TREE["seed"], TREE["steps"])
    return [[m.to_json() for m in svc.document(f"doc{d}").sequencer.log]
            for d in range(TREE["n_docs"])]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    def make(d: Path):
        store = d / "ckpt"  # beside the rendezvous file, "store"
        cases = [
            ("groups", {"stacks": _stacks(4)}),
            ("seg_lane", {"geom": SEG, "traces": _seg_traces()}),
            ("long_doc", _long_doc_inputs()),
            ("engine", {"n_docs": ENGINE["n_docs"], "rounds": _engine_rounds(ENGINE),
                        "store": str(store), "kw": ENGINE["kw"]}),
            ("gate", {"n_docs": GATE["n_docs"], "rounds": _engine_rounds(GATE)}),
            ("migrate", {"n_docs": MIGRATE["n_docs"], "rounds": _migrate_rounds(),
                         "half": MIGRATE["rounds"] // 2, "doc": MIGRATE["doc"],
                         "spare": MIGRATE["spare"]}),
        ]
        return {"ranks": run_world(d, 4, cases), "store": str(store)}

    return _shared(tmp_path_factory, "world4", make)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, world4):
    def make(d: Path):
        cases = [
            ("groups", {"stacks": _stacks(2)}),
            ("long_doc", _long_doc_inputs()),
            ("restore", {"n_docs": ENGINE["n_docs"], "store": world4["store"],
                         "kw": ENGINE["kw"]}),
            ("tree", {"logs": _tree_logs(), "doc": TREE["doc"], "kw": TREE["kw"]}),
        ]
        return {"ranks": run_world(d, 2, cases)}

    return _shared(tmp_path_factory, "world2", make)


def _migrate_rounds() -> list:
    return rw.zipf_stream(MIGRATE["n_docs"], MIGRATE["rounds"], MIGRATE["seed"],
                          ob_docs=(), ops_per_round=2)


# ---------------------------------------------------------------- reference
def _ref_engine(rounds, n_docs, store=None, **kw):
    """The reference engine fed the stream as the ranks were (a step a
    round, a compact every other round)."""
    eng = RefEngine(n_docs, use_mesh=False, checkpoint_store=store, **{**REF_GEOM, **kw})
    for r, msgs in enumerate(rounds):
        for d, line in msgs:
            eng.ingest(d, RefMsg.from_json(line))
        eng.step()
        if r % 2 == 1:
            eng.compact()
    return eng


def _files(directory) -> dict[str, bytes]:
    out = {}
    for root, _dirs, names in os.walk(directory):
        for n in names:
            path = os.path.join(root, n)
            out[os.path.relpath(path, directory)] = Path(path).read_bytes()
    return out


def _assert_engine_equal(ref, views: dict, tag: str, rows=True) -> None:
    """A rank's engine views equal the reference engine's: every doc's raw
    columns (a lane doc's live content), latch, text, annotations."""
    n = ref.n_docs
    assert np.array_equal(np.asarray(ref.errors())[:n], views["errors"][:n]), tag
    assert views["error_count"] == int(pm.error_count(ref.state.error)), tag
    for d in range(n):
        assert views["texts"][d] == ref.text(d), (tag, d)
        assert views["annotations"][d] == ref.annotations(d), (tag, d)
        if rows:
            assert_states_equal(ref.doc_state(d), views["rows"][d], f"{tag} doc {d}")


# -------------------------------------------------------------------- cases
@pytest.mark.parametrize("world", [2, 4])
def test_process_group_matches_stacked_group(world, world2, world4):
    """Every member of ``ProcessShardGroup`` (a rank's row) equals the
    stacked group's row for that shard, on seeded int32 stacks."""
    ranks = (world2 if world == 2 else world4)["ranks"]
    g = tk.StackedShardGroup(world)
    for r, out in enumerate(r_["groups"] for r_ in ranks):
        assert (out["size"], out["rows"]) == (world, 1)
        assert out["axis_index"].tolist() == [r]
        for i, x in enumerate(_stacks(world)):
            t = torch.from_numpy(x)
            got = out[i]
            assert np.array_equal(got["all_gather"], g.all_gather(t)[:, r : r + 1].numpy())
            assert np.array_equal(got["psum"], g.psum(t)[r : r + 1].numpy())
            assert np.array_equal(got["pmin"], g.pmin(t)[r : r + 1].numpy())
            assert np.array_equal(got["before"], g.before(g.all_gather(t[:, 0]))[r : r + 1].numpy())
        assert out["calls"] == 4 * len(_stacks(world))


def _ref_seg_programs(n: int):
    """The reference's seg-lane programs on an n-device segs mesh with the
    Pallas resolve route on (as ``test_torch_segment_lane`` builds them)."""
    saved = mk.SEG_RESOLVE_PALLAS
    mk.SEG_RESOLVE_PALLAS = True
    try:
        mesh = pm.docs_segs_mesh(jax.devices()[:n], seg_shards=n)
        specs = pm.seg_state_specs(mk.init_state(SEG[0], 4, 4, SEG[1], SEG[2]))
        mega = pm.mesh_seg_program.__wrapped__(mk.apply_megastep_seg, mesh, specs)
        comp = pm.mesh_seg_program.__wrapped__(mk.compact_seg, mesh, specs, arg_specs=(pm.P(),))
        return mesh, mega, comp
    finally:
        mk.SEG_RESOLVE_PALLAS = saved


def _stack_rows(rows: list):
    """The ranks' [1, ...] lane rows as one stacked state."""
    return tk.tree_map(lambda *xs: torch.from_numpy(np.concatenate(xs)), *rows)


@pytest.mark.parametrize("seed", [0, 2])
def test_segment_lane_over_ranks_matches_reference(seed, world4):
    """``apply_megastep_seg`` then ``compact_seg`` over 4 ranks (a
    ``ProcessShardGroup`` over the segs row) equal the reference's 4-device
    ``mesh_seg_program`` on every leaf, the ranks' replicas agreeing."""
    n = 4
    mesh, ref_mega, ref_comp = _ref_seg_programs(n)
    blocked, ops, pays = _seg_traces()[seed]
    ref = pm.shard_seg_state(mk.DocState(**blocked._asdict()), mesh)
    ref = ref_mega(ref, jnp.asarray(ops), jnp.asarray(pays))
    lanes = [r["seg_lane"][seed] for r in world4["ranks"]]
    for key, want in (("megastep", ref), ("compact", ref_comp(ref, jnp.asarray(40, jnp.int32)))):
        port = _stack_rows([lane[key] for lane in lanes])
        assert tk.seg_replica_mismatch(port) == [], (seed, key)
        assert_states_equal(want, tk.seg_unstack(port), f"seed {seed} {key}")
    assert min(lane["calls"] for lane in lanes) > 0
    assert int(np.asarray(ref.error)) == 0  # the trace fits: no latch hides a difference


@pytest.mark.parametrize("world", [2, 4])
def test_long_doc_plane_over_ranks_matches_reference(world, world2, world4):
    """Visible length, resolve (K1 on each rank's block) and mark_range
    over ``world`` ranks equal the reference's on a ``world``-device segs
    mesh."""
    ranks = (world2 if world == 2 else world4)["ranks"]
    inp = _long_doc_inputs()
    state = jax.tree.map(jnp.asarray, mk.DocState(**inp["state"]._asdict()))
    rmesh = Mesh(np.asarray(jax.devices()[:world]), ("segs",))
    ref_ops = rld.make_sharded_ops(rmesh, state)
    ref_state = rld.shard_doc_state(state, rmesh)
    for view in VIEWS:
        ref_len = int(ref_ops[0](ref_state, *view))
        gi, off = ref_ops[1](ref_state, jnp.asarray(inp["queries"]), *view)
        for out in (r["long_doc"] for r in ranks):
            assert out[view]["length"] == ref_len
            assert np.array_equal(out[view]["resolve"][0], np.asarray(gi))
            assert np.array_equal(out[view]["resolve"][1], np.asarray(off))
    ref_mark = jax.device_get(ref_ops[2](ref_state, *MARK))
    blocks = [r["long_doc"]["mark"] for r in ranks]
    marked = {}
    for f in tk.DocState._fields:
        vals = [getattr(b, f) for b in blocks]
        if f not in tk.SEG_COLUMNS:
            marked[f] = vals[0]
        elif isinstance(vals[0], tuple):
            marked[f] = tuple(np.concatenate(xs) for xs in zip(*vals))
        else:
            marked[f] = np.concatenate(vals)
    assert_states_equal(ref_mark, tk.DocState(**marked), f"mark_range over {world}")
    assert all(np.shape(b.seg_len) == (64 // world,) for b in blocks)


@pytest.fixture(scope="module")
def ref_engine(tmp_path_factory):
    store = tmp_path_factory.mktemp("ref_store")
    eng = _ref_engine(_engine_rounds(ENGINE), ENGINE["n_docs"], RefStore(str(store)),
                      **ENGINE["kw"])
    eng.maybe_checkpoint(force=True)
    return eng, store


def test_engine_over_ranks_matches_reference(world4, ref_engine):
    """The string fleet over 4 ranks equals the reference engine on the
    same stream: raw columns and latches of every doc, texts, annotations,
    ``error_count``, the quarantine and the overflow lanes, on every rank;
    each rank holds only its shard's rows and the mesh refuses a
    collective under ``ckpt_lock``."""
    ref, _store = ref_engine
    ranks = [r["engine"] for r in world4["ranks"]]
    assert ref.quarantine and ref.overflow, "the stream must quarantine and overflow"
    for r, views in enumerate(ranks):
        _assert_engine_equal(ref, views, f"rank {r}")
        assert views["quarantine"] == sorted(ref.quarantine)
        assert views["overflow"] == sorted(ref.overflow)
        assert views["rows_held"] == (4 * r, 4 * r + 4)
        assert views["guarded"], "a collective ran under ckpt_lock"
        assert views["written"] == ranks[0]["written"]
        for key in ("checkpoints_written", "quarantines", "capacity_recoveries",
                    "watchdog_checks"):
            assert views["health"][key] == ref.health()[key], key


def test_checkpoint_files_are_the_reference_engines(world4, ref_engine):
    """The 4 ranks' shared store (each rank wrote its own docs' files)
    equals the reference engine's store byte for byte."""
    _ref, store = ref_engine
    want = _files(store)
    got = _files(world4["store"])
    assert want and got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []
    owned = sorted(d for r in world4["ranks"] for d in r["engine"]["owned"])
    assert owned == list(range(ENGINE["n_docs"]))


def test_four_rank_store_restores_into_two_ranks_and_one_process(world2, ref_engine, world4):
    """The 4-rank store restored into a 2-rank mesh and into one process
    gives the reference engine's docs (a restored reference as the
    control)."""
    ref, store = ref_engine
    control = RefEngine(ENGINE["n_docs"], use_mesh=False, checkpoint_store=RefStore(str(store)),
                        **{**REF_GEOM, **ENGINE["kw"]})
    control.restore_from_checkpoints()
    for r, out in enumerate(x["restore"] for x in world2["ranks"]):
        assert out["restored"] == list(range(ENGINE["n_docs"]))
        _assert_engine_equal(control, out, f"2-rank restore, rank {r}")
    one = DocBatchEngine(ENGINE["n_docs"], device="cpu",
                         checkpoint_store=CheckpointStore(world4["store"]),
                         **{**rw.GEOM, **ENGINE["kw"]})
    assert one.restore_from_checkpoints() == list(range(ENGINE["n_docs"]))
    for d in range(ENGINE["n_docs"]):
        assert one.text(d) == ref.text(d) == control.text(d)
        assert_states_equal(control.doc_state(d), one.doc_state(d), f"one process doc {d}")


def test_per_shard_obliterate_gate(world4):
    """Only shard 2's docs obliterate: on ranks 0, 1 and 3 the gate never
    opens (each rank reads its own rows), on rank 2 it does, and the
    obliterating rank pays fewer gate reads (its kinds open the gate on
    the host); a one-card engine's global gate opens for every shard.  The
    bytes equal the reference's."""
    rounds = _engine_rounds(GATE)
    ref = _ref_engine(rounds, GATE["n_docs"])
    ranks = [r["gate"] for r in world4["ranks"]]
    for r, views in enumerate(ranks):
        _assert_engine_equal(ref, views, f"gate rank {r}")
    opens = [v["opens"] for v in ranks]
    assert opens[2] > 0 and [opens[i] for i in (0, 1, 3)] == [0, 0, 0], opens
    syncs = [v["syncs"] for v in ranks]
    assert syncs[2] < min(syncs[i] for i in (0, 1, 3)), syncs
    one = DocBatchEngine(GATE["n_docs"], mesh=doc_mesh(["cpu"] * 4), **rw.GEOM)
    rw.feed_rounds(one, rounds)
    assert one.ob_gate_opens >= opens[2] > 0  # one gate for the fleet
    assert ranks[0]["slices"] == one.counters.get("megastep_slices")


def test_cross_rank_migration_byte_identity(world4):
    """A doc moved to another rank mid-stream (its row broadcast from the
    source rank) converges as in ``test_midstream_migration_byte_identity``:
    texts, annotations and every unmoved row equal the never-migrated
    control's and the reference's; the moved doc's summary equals theirs
    and its raw row equals a one-card engine's that made the same move."""
    rounds = _migrate_rounds()
    half, moved = MIGRATE["rounds"] // 2, MIGRATE["doc"]
    ref = RefEngine(MIGRATE["n_docs"], use_mesh=False, **REF_GEOM)
    one = DocBatchEngine(MIGRATE["n_docs"], mesh=doc_mesh(["cpu"] * 4),
                         spare_slots=MIGRATE["spare"], **rw.GEOM)
    for eng in (ref, one):
        for msgs in rounds[:half]:
            for d, line in msgs:
                eng.ingest(d, (RefMsg if eng is ref else PortMsg).from_json(line))
            eng.step()
    assert one.migrate_doc(moved, (one.shard_of(moved) + 3) % 4)
    for eng in (ref, one):
        for msgs in rounds[half:]:
            for d, line in msgs:
                eng.ingest(d, (RefMsg if eng is ref else PortMsg).from_json(line))
        eng.step()
        eng.compact()
        eng.step()
    for r, out in enumerate(x["migrate"] for x in world4["ranks"]):
        a, b = out["moved"], out["control"]
        assert a["shard"] == one.shard_of(moved) != b["shard"]
        assert a["slot"] == int(one._slot[moved])
        for d in range(MIGRATE["n_docs"]):
            assert a["texts"][d] == b["texts"][d] == ref.text(d), (r, d)
            assert a["annotations"][d] == b["annotations"][d] == ref.annotations(d)
            if d != moved:
                assert_states_equal(ref.doc_state(d), a["rows"][d], f"rank {r} doc {d}")
                assert_states_equal(ref.doc_state(d), b["rows"][d], f"rank {r} doc {d}")
        want = rkb.state_to_summary(jax.tree.map(np.asarray, ref.doc_state(moved)))
        for views in (a, b):
            assert tkb.state_to_summary(views["rows"][moved]) == want
        assert_states_equal(tk.to_numpy(one.doc_state(moved)), a["rows"][moved], "moved row")
        assert a["health"]["doc_migrations"] == 1


def test_tree_engine_over_ranks_matches_reference(world2):
    """``TreeBatchEngine`` over 2 ranks (K7 and K8 on each rank's rows, the
    EditManager folds on every rank's host, one doc migrated to the other
    rank mid-stream) equals the reference engine: every doc's tree JSON
    and values, and every unmoved doc's raw columns; after the compaction
    (K8) every row equals a one-card engine's that made the same move."""
    from fluidframework_tpu.ops import tree_kernel as rtk
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    logs = _tree_logs()
    ref = RefTreeEngine(TREE["n_docs"], **TREE["kw"])
    one = TreeBatchEngine(TREE["n_docs"], mesh=doc_mesh(["cpu"] * 2), spare_slots=4,
                          **TREE["kw"])
    half = {d: len(log) // 2 for d, log in enumerate(logs)}
    for i, part in enumerate((lambda d: logs[d][: half[d]], lambda d: logs[d][half[d]:])):
        for eng in (ref, one):
            for d in range(TREE["n_docs"]):
                for line in part(d):
                    eng.ingest(d, (RefMsg if eng is ref else PortMsg).from_json(line))
            eng.step()
        if i == 0:
            assert one.migrate_doc(TREE["doc"], 1)
    one.compact()
    for r, out in enumerate(x["tree"] for x in world2["ranks"]):
        assert out["fallbacks"] == sorted(ref.fallbacks)
        assert not np.asarray(out["errors"]).any()
        assert out["shard"] == one.shard_of(TREE["doc"]) == 1  # doc 1 started on shard 0
        for d in range(TREE["n_docs"]):
            assert out["trees"][d] == json.dumps(ref.tree_json(d), sort_keys=True), (r, d)
            assert out["values"][d] == json.dumps(ref.values(d), sort_keys=True), (r, d)
            if d != TREE["doc"] and d not in ref.fallbacks:
                slot = int(ref._slot[d])
                for name in rtk.NestedForestState._fields:
                    want = np.asarray(getattr(ref.state, name))[slot]
                    assert np.array_equal(getattr(out["rows"][d], name), want), (r, d, name)
            mine = one.doc_state(d)
            for name in rtk.NestedForestState._fields:
                assert np.array_equal(getattr(out["compacted"][d], name),
                                      getattr(mine, name).numpy()), (r, d, name)


# ---------------------------------------------------------------- fleet_main
def test_fleet_main_over_two_gloo_ranks(tmp_path):
    """``fleet_main --mesh 2`` under ``torch.distributed.run`` with 2 gloo
    ranks against the port's netserver: the final texts equal the
    writers', every JSON line is rank 0's alone (one ``ready``, one
    ``done``), and the checkpoint store holds every doc."""
    from fluidframework_tpu_torch.dds.shared_string import SharedString
    from fluidframework_tpu_torch.server.netserver import NetworkServer

    srv = NetworkServer().start()
    try:
        fleets = []
        for i in range(3):
            doc_id = f"r{i}"
            with srv.lock:
                doc = srv.service.document(doc_id)
                writers = [SharedString(client_id=f"{doc_id}-w{w}") for w in range(2)]
                for c in writers:
                    doc.connect(c.client_id, c.process)
                doc.process_all()
            fleets.append((doc_id, writers))
        rng = random.Random(11)
        rows = 0
        for _ in range(4):
            for doc_id, writers in fleets:
                for c in writers:
                    n = len(c.text)
                    if rng.random() < 0.7 or n < 4:
                        c.insert_text(rng.randint(0, n), "".join(
                            rng.choice("abcdef") for _ in range(rng.randint(1, 6))))
                    else:
                        p = rng.randint(0, n - 2)
                        c.remove_range(p, p + 1)
                with srv.lock:
                    doc = srv.service.document(doc_id)
                    for c in writers:
                        for m in c.take_outbox():
                            doc.submit(m)
                            rows += 1
                    doc.process_all()
        docs = ",".join(d for d, _ in fleets)
        ckpt = tmp_path / "ckpt"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "fluidframework_tpu_torch.server.fleet_main",
               "--device", "cpu", "--mesh", "2", "--port", str(srv.port), "--docs", docs,
               "--max-insert-len", "8", "--capacity", "64", "--text-capacity", "512",
               "--status-every", "60", "--exit-after-rows", str(rows),
               "--checkpoint-dir", str(ckpt)]
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=WORLD_TIMEOUT_S)
    finally:
        srv.stop()
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [x for x in lines if x.get("ready")] == [
        {"ready": True, "family": "string", "docs": docs.split(","), "port": srv.port}]
    done = [x for x in lines if x.get("done")]
    assert len(done) == 1
    want = {d: writers[0].text for d, writers in fleets}
    assert done[0]["texts"] == want and done[0]["errors"] == 0
    assert done[0]["rows"] == rows and done[0]["health"]["n_shards"] == 2
    assert sorted(os.listdir(ckpt / "checkpoints")) and len(
        os.listdir(ckpt / "checkpoints")) >= len(fleets)


# ------------------------------------------------------------- refusals
def test_rank_mesh_refusals(tmp_path, monkeypatch, capsys):
    """What a rank mesh refuses, in a one-rank gloo world of this process:
    the native dispatch plane at engine construction (its host loop owns
    the whole state), the background checkpoint writer (a sweep is
    collective), ``fleet_main``'s options a rank would decide on alone, and
    any collective under the engine's ``ckpt_lock``."""
    import torch.distributed as dist

    from fluidframework_tpu_torch.models import dispatch
    from fluidframework_tpu_torch.models.recovery import BackgroundCheckpointWriter
    from fluidframework_tpu_torch.parallel import mesh as tpm
    from fluidframework_tpu_torch.server.fleet_main import main

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = tpm.rank_mesh()
        assert mesh.ranked and mesh.devices == (torch.device("cpu"),)
        importlib.import_module("fluidframework_tpu_torch.parallel.native_plane")  # registers it
        try:
            with pytest.raises(NotImplementedError, match="rank mesh"):
                DocBatchEngine(4, mesh=mesh, **rw.GEOM)
        finally:
            dispatch.register_dispatch_plane(tpm)
        eng = DocBatchEngine(4, mesh=tpm.rank_mesh(), **rw.GEOM)
        with pytest.raises(ValueError, match="rank mesh"):
            BackgroundCheckpointWriter(eng)
        with eng.ckpt_lock, pytest.raises(RuntimeError, match="ckpt_lock"):
            eng.errors()
        assert eng.error_count() == 0
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("LOCAL_RANK", "0")
        for flag in (["--standby"], ["--drain-file", "x"], ["--rebalance-every", "1"]):
            with pytest.raises(SystemExit):
                main(["--port", "1", "--docs", "a", "--device", "cpu", "--mesh", "1", *flag])
            assert "rank mesh" in capsys.readouterr().err
    finally:
        dist.destroy_process_group()
