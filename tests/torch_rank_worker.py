"""One rank of a gloo world for the port's cross-card tests.

Run as a script, one process a rank (``tests/test_torch_cross_card.py``'s
``run_world`` starts them):

    python tests/torch_rank_worker.py WORLD_DIR RANK WORLD_SIZE

``WORLD_DIR`` holds ``cases.pkl`` (a list of ``(case, inputs)``) and the
``file://`` store; the rank joins the group (gloo, with a timeout), runs
every case of the list in order against the port on the CPU and writes
``rank<RANK>.pkl`` (case -> result).  A failure prints its traceback and
exits 1.

A rank imports neither JAX nor the JAX package: run as a script, the
blocker below refuses them before anything else loads (only the test
parent, which imports this module for ``zipf_stream``, runs the
reference).  ``zipf_stream`` makes the string streams the parent feeds the
reference with (as JSON lines).
"""

from __future__ import annotations

import importlib.abc
import sys

_BLOCKED = ("jax", "jaxlib", "fluidframework_tpu")


class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in _BLOCKED):
            raise ImportError(f"blocked import in a rank: {name}")
        return None


if __name__ == "__main__":  # a rank; the test parent imports this module too
    sys.meta_path.insert(0, _Blocker())

import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import traceback  # noqa: E402
from datetime import timedelta  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine  # noqa: E402
from fluidframework_tpu_torch.ops import mergetree_kernel as tk  # noqa: E402
from fluidframework_tpu_torch.parallel import long_doc as tld  # noqa: E402
from fluidframework_tpu_torch.parallel import mesh as tpm  # noqa: E402
from fluidframework_tpu_torch.protocol.messages import SequencedMessage  # noqa: E402
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore  # noqa: E402

# The engines' geometry (D <= 16, S <= 64, max_insert_len 8).
GEOM = dict(max_insert_len=8, ops_per_step=4, megastep_k=2, max_segments=64,
            text_capacity=512, remove_slots=4, prop_slots=2, ob_slots=8)
TIMEOUT_S = 60


# ------------------------------------------------------------------ streams
def _msg(seq: int, contents: dict) -> str:
    """Op ``seq`` of the single writer, its MSN trailing by four."""
    return SequencedMessage(
        seq=seq, min_seq=max(0, seq - 4), ref_seq=seq - 1, client_id="w0", client_seq=seq,
        type="op", contents=contents,
    ).to_json()


def _join() -> str:
    return SequencedMessage(
        seq=0, min_seq=0, ref_seq=0, client_id="w0", client_seq=0, type="join",
        contents={"clientId": "w0", "short": 0},
    ).to_json()


def zipf_stream(n_docs: int, rounds: int, seed: int, ob_docs=None, poison=None,
                big=None, a: float = 1.1, ops_per_round: int = 4) -> list[list]:
    """A seeded single-writer stream a round a list of ``(doc, JSON line)``
    (round 0 starts with every doc's join): each round doc ``d`` gets
    ``ops_per_round`` ops scaled by a Zipf(``a``) weight of its rank, each
    an insert, a remove or (for ``ob_docs``, every doc when None) an
    obliterate, valid in the writer's own perspective.  ``poison=(d, r)``
    adds an insert past the end (a quarantine), ``big=(d, r)`` a run of
    inserts past the text capacity (an overflow lane)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_docs + 1) ** a
    counts = np.maximum(1, np.round(ops_per_round * n_docs * weights / weights.sum())).astype(int)
    order = rng.permutation(n_docs)
    lengths = [0] * n_docs
    seqs = [0] * n_docs
    out = []
    for r in range(rounds):
        msgs = [(d, _join()) for d in range(n_docs)] if r == 0 else []
        for d in range(n_docs):
            n = int(counts[order[d]])
            if poison == (d, r):
                seqs[d] += 1
                msgs.append((d, _msg(seqs[d], {"type": 0, "pos1": 10**6, "seg": "XX"})))
            if big == (d, r):
                for _ in range(GEOM["text_capacity"] // 8 + 4):
                    seqs[d] += 1
                    msgs.append((d, _msg(seqs[d], {"type": 0, "pos1": lengths[d] // 2,
                                                   "seg": "Z" * 8})))
                    lengths[d] += 8
            for _ in range(n):
                seqs[d] += 1
                roll = rng.random()
                ob = ob_docs is None or d in ob_docs
                if ob and lengths[d] >= 6 and roll < 0.15:
                    p1 = int(rng.integers(0, lengths[d] - 2))
                    p2 = int(rng.integers(p1 + 1, lengths[d] + 1))
                    msgs.append((d, _msg(seqs[d], {"type": 4, "pos1": p1, "pos2": p2})))
                    lengths[d] -= p2 - p1
                elif lengths[d] >= 4 and roll < 0.4:
                    p = int(rng.integers(0, lengths[d] - 1))
                    msgs.append((d, _msg(seqs[d], {"type": 1, "pos1": p, "pos2": p + 1})))
                    lengths[d] -= 1
                else:
                    p = int(rng.integers(0, lengths[d] + 1))
                    text = "".join(rng.choice(list("abcdefgh"), int(rng.integers(1, 9))))
                    msgs.append((d, _msg(seqs[d], {"type": 0, "pos1": p, "seg": text})))
                    lengths[d] += len(text)
        out.append(msgs)
    return out


def feed_rounds(eng, rounds, compact_every: int = 2, after_round=None) -> None:
    """Each round ingested, then one ``step``; a ``compact`` every
    ``compact_every`` rounds; ``after_round(r)`` after round r's step."""
    for r, msgs in enumerate(rounds):
        for d, line in msgs:
            eng.ingest(d, SequencedMessage.from_json(line))
        eng.step()
        if compact_every and r % compact_every == compact_every - 1:
            eng.compact()
        if after_round is not None:
            after_round(r)


def host_rows(eng) -> list:
    """Every doc's one-document state as host numpy (``doc_state``: a
    collective on a rank mesh)."""
    return [tk.to_numpy(eng.doc_state(d)) for d in range(eng.n_docs)]


def engine_views(eng) -> dict:
    """What the tests compare of a string engine (every call collective on
    a rank mesh)."""
    return {
        "rows": host_rows(eng),
        "errors": np.asarray(eng.errors()),
        "texts": [eng.text(d) for d in range(eng.n_docs)],
        "annotations": [eng.annotations(d) for d in range(eng.n_docs)],
        "error_count": eng.error_count(),
        "quarantine": sorted(eng.quarantine),
        "overflow": sorted(eng.overflow),
        "health": eng.health(),
    }


# -------------------------------------------------------------------- cases
def case_groups(inp, rank, world):
    """Every member of ``ProcessShardGroup`` on this rank's row of seeded
    int32 stacks."""
    g = tk.ProcessShardGroup(dist.group.WORLD)
    out = {"size": g.size, "rows": g.rows,
           "axis_index": g.axis_index("cpu").numpy()}
    for i, x in enumerate(inp["stacks"]):
        row = torch.from_numpy(x[rank : rank + 1])
        gathered = g.all_gather(row)
        out[i] = {
            "all_gather": gathered.numpy(),
            "psum": g.psum(row).numpy(),
            "pmin": g.pmin(row).numpy(),
            "before": g.before(g.all_gather(row[:, 0])).numpy(),
        }
    out["calls"] = g.calls
    return out


def case_seg_lane(inp, rank, world):
    """The segment megastep and compaction over a rank mesh of ``world``
    ranks (one ``segs`` row): this rank's lane row after each."""
    mesh = tpm.rank_mesh(seg_shards=world)
    out = {}
    for seed, (blocked, ops, pays) in inp["traces"].items():
        mega = tpm.mesh_seg_program(tk.apply_megastep_seg, mesh)
        comp = tpm.mesh_seg_program(tk.compact_seg, mesh)
        lane = tpm.shard_seg_state(blocked, mesh)
        lane = mega(lane, ops, pays)
        after = tk.to_numpy(lane)
        lane = comp(lane, 40)
        out[seed] = {"megastep": after, "compact": tk.to_numpy(lane),
                     "calls": mega.group.calls}
    return out


def case_long_doc(inp, rank, world):
    """The long-document plane over a ``world``-rank segs mesh: visible
    length, resolve and mark_range per view, and this rank's block."""
    mesh = tpm.rank_mesh(seg_shards=world)
    state = tld.shard_doc_state(tk.from_numpy(inp["state"], "cpu"), mesh)
    length, resolve, mark = tld.make_sharded_ops(mesh, state)
    out = {"block": tk.to_numpy(state).seg_len}
    for ref_seq, client in inp["views"]:
        gi, off = resolve(state, inp["queries"], ref_seq, client)
        out[(ref_seq, client)] = {
            "length": int(length(state, ref_seq, client)),
            "resolve": (gi.numpy(), off.numpy()),
        }
    out["mark"] = tk.to_numpy(mark(state, *inp["mark"]))
    return out


def _rank_engine(n_docs, world, store=None, **kw):
    mesh = tpm.rank_mesh()
    return DocBatchEngine(n_docs, mesh=mesh, checkpoint_store=store, **{**GEOM, **kw})


def case_engine(inp, rank, world):
    """The string fleet over a rank mesh: the stream round by round (step,
    compact every other round), then a forced checkpoint into the shared
    store; also shows no collective runs under ``ckpt_lock``."""
    eng = _rank_engine(inp["n_docs"], world, CheckpointStore(inp["store"]), **inp["kw"])
    feed_rounds(eng, inp["rounds"])
    written = eng.maybe_checkpoint(force=True)
    with eng.ckpt_lock:
        try:
            eng.error_count()
            guarded = False
        except RuntimeError:
            guarded = True
    out = engine_views(eng)
    out.update(written=written, guarded=guarded, rows_held=eng._rows,
               owned=[d for d in range(eng.n_docs) if eng.shard_of(d) == rank])
    return out


def case_gate(inp, rank, world):
    """The per-shard obliterate gate: a stream whose obliterates are all on
    one shard's docs; this rank's gate opens and device reads."""
    eng = _rank_engine(inp["n_docs"], world)
    feed_rounds(eng, inp["rounds"])
    out = engine_views(eng)
    out.update(opens=eng.ob_gate_opens, syncs=eng.counters.get("ob_gate_syncs"),
               slices=eng.counters.get("megastep_slices"))
    return out


def case_migrate(inp, rank, world):
    """A doc migrated to another rank mid-stream (the migrating engine) and
    a control that never moves it, both on the rank mesh."""
    engines = {}
    for name in ("moved", "control"):
        eng = _rank_engine(inp["n_docs"], world, spare_slots=inp["spare"])
        half = inp["half"]
        feed_rounds(eng, inp["rounds"][:half], compact_every=0)
        if name == "moved":
            src = eng.shard_of(inp["doc"])
            dst = (src + 3) % eng.n_shards
            assert eng.migrate_doc(inp["doc"], dst), "migration refused"
            assert eng.shard_of(inp["doc"]) == dst
        rest = inp["rounds"][half:]
        for d, line in (x for msgs in rest for x in msgs):
            eng.ingest(d, SequencedMessage.from_json(line))
        eng.step()
        eng.compact()
        eng.step()
        engines[name] = {**engine_views(eng), "shard": eng.shard_of(inp["doc"]),
                         "slot": int(eng._slot[inp["doc"]])}
    return engines


def case_restore(inp, rank, world):
    """A store written by another world's ranks restored into this one."""
    eng = _rank_engine(inp["n_docs"], world, CheckpointStore(inp["store"]), **inp["kw"])
    restored = eng.restore_from_checkpoints()
    return {**engine_views(eng), "restored": restored}


def case_tree(inp, rank, world):
    """The tree fleet over a rank mesh: half of every doc's messages, a
    step, a doc migrated across ranks, the rest, a step (the rows read
    here), then a compaction (K8)."""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.ops import tree_kernel as ttk

    mesh = tpm.rank_mesh()
    eng = TreeBatchEngine(len(inp["logs"]), mesh=mesh, spare_slots=4, **inp["kw"])
    half = {d: len(log) // 2 for d, log in enumerate(inp["logs"])}
    for d, log in enumerate(inp["logs"]):
        for line in log[: half[d]]:
            eng.ingest(d, SequencedMessage.from_json(line))
    eng.step()
    moved = inp["doc"]
    dst = (eng.shard_of(moved) + 1) % eng.n_shards
    assert eng.migrate_doc(moved, dst), "tree migration refused"
    for d, log in enumerate(inp["logs"]):
        for line in log[half[d]:]:
            eng.ingest(d, SequencedMessage.from_json(line))
    eng.step()
    rows = [ttk.tree_map(lambda x: x.numpy(), eng.doc_state(d)) for d in range(eng.n_docs)]
    eng.compact()
    return {
        "trees": [json.dumps(eng.tree_json(d), sort_keys=True) for d in range(eng.n_docs)],
        "values": [json.dumps(eng.values(d), sort_keys=True) for d in range(eng.n_docs)],
        "rows": rows,
        "compacted": [ttk.tree_map(lambda x: x.numpy(), eng.doc_state(d))
                      for d in range(eng.n_docs)],
        "errors": eng.errors(),
        "fallbacks": sorted(eng.fallbacks),
        "shard": eng.shard_of(moved),
    }


def chaos_run(inp, tree_mesh=None) -> dict:
    """``run_chaos`` with ``inp["kw"]`` and the schedule's events
    (``inp["events"]``), its tree tier over ``tree_mesh`` when given.  The
    process that runs the stack returns the report with each document's
    sequenced log (wire JSON), the fleet's texts and tree JSON and the tree
    docs' shards, read once the invariants held; another rank returns its
    tier's stats.  ``inp["raise_at"]`` makes the stack raise at that tick (a
    schedule event of no known kind).  The tree writers' session ids come
    from a generator seeded with the run's seed and their move ids count
    from 0, so two runs that sequence the same ops write the same bytes but
    for the timestamps."""
    import random
    import uuid

    from fluidframework_tpu_torch.dds.tree import changeset
    from fluidframework_tpu_torch.testing import chaos
    from fluidframework_tpu_torch.utils import id_compressor

    events = [chaos.ChaosEvent(*e) for e in inp["events"]]
    if "raise_at" in inp:
        events.append(chaos.ChaosEvent(inp["raise_at"], "no_such_fault"))
    schedule = chaos.ChaosSchedule(seed=inp["kw"]["seed"], events=events)
    seen = {}
    check = chaos.ChaosStack.check_invariants

    def check_and_read(stack):
        out = check(stack)
        with stack.plane.nexus.lock:
            seen["logs"] = {d: [m.to_json() for m in stack.plane.service.document(d).sequencer.log]
                            for d in stack.all_doc_ids}
        seen["texts"] = [stack.engine.text(i) for i in range(len(stack.doc_ids))]
        seen["trees"] = stack.tree.views()[0]
        seen["shards"] = [stack.tree_engine.shard_of(i) for i in range(len(stack.tree_doc_ids))]
        return out

    rng = random.Random(inp["kw"]["seed"])
    moves, changeset._move_counter = changeset._move_counter, 0
    session = id_compressor.create_session_id
    chaos.ChaosStack.check_invariants = check_and_read
    id_compressor.create_session_id = lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4))
    try:
        out = chaos.run_chaos(schedule=schedule, device="cpu", tree_mesh=tree_mesh, **inp["kw"])
    finally:
        chaos.ChaosStack.check_invariants = check
        id_compressor.create_session_id = session
        changeset._move_counter = max(changeset._move_counter, moves)
    return {"out": out, **seen}


def case_chaos(inp, rank, world):
    """``chaos_run`` on every rank with the same arguments, the tree tier
    over the rank mesh."""
    return chaos_run(inp, tpm.rank_mesh())


CASES = {
    "groups": case_groups, "seg_lane": case_seg_lane, "long_doc": case_long_doc,
    "engine": case_engine, "gate": case_gate, "migrate": case_migrate,
    "restore": case_restore, "tree": case_tree, "chaos": case_chaos,
    "chaos_cold": case_chaos,
}


def main(world_dir: str, rank: int, world: int) -> int:
    store = dist.FileStore(os.path.join(world_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        with open(os.path.join(world_dir, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        out = {}
        for name, inp in cases:
            out[name] = CASES[name](inp, rank, world)
        leaked = sorted(m for m in sys.modules
                        if any(m == b or m.startswith(b + ".") for b in _BLOCKED))
        out["leaked"] = leaked
        tmp = os.path.join(world_dir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(world_dir, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
    except Exception:  # noqa: BLE001 — a rank's traceback fails its world
        traceback.print_exc()
        sys.exit(1)
