"""The port's SharedMatrix and SharedMap clients against the JAX package's.

Every test of the reference's ``tests/test_shared_matrix.py`` (the grid,
LWW and FWW cells, removes under concurrent writes, the seeded farm) and
``tests/test_shared_map.py`` (LWW, pending overlays, clear) runs in both
packages through ``torch_twins``: the port's copy must pass and the two runs
must agree message by message and on every replica's grid or items.  The
map farm's kernel replay runs the port's ``map_kernel`` (CPU) on the port's
log.  ``SharedMatrixChannel`` runs inside ``ContainerRuntime`` over
``LocalService`` in a seeded farm with reconnects, offline stashes and a
late joiner loaded from a summary; and the committed
``sharedMatrix.v1.json`` and ``sharedMap.v1.json`` load in both packages.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

import torch_twins as twins

MAP_FARM = "test_map_farm_and_kernel_equivalence"
CASES = twins.cases("test_shared_matrix.py") + twins.cases("test_shared_map.py", skip=(MAP_FARM,))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


def map_farm(root: str, seed: int):
    """The reference map farm's client half (``test_shared_map.py``) in
    package ``root``; returns the sequenced log and the replicas' items."""
    port = twins.port_twin("test_shared_map.py")
    ref = importlib.import_module("test_shared_map")
    mod = port if root.endswith("_torch") else ref
    rng = random.Random(seed)
    doc = mod.LocalDocument("d")
    maps = mod.make_maps(doc, rng.randint(2, 4))
    keyspace = [f"k{i}" for i in range(8)]
    for _round in range(rng.randint(3, 8)):
        for m in maps:
            for _ in range(rng.randint(0, 3)):
                r = rng.random()
                if r < 0.70:
                    m.set(rng.choice(keyspace), rng.randint(0, 100))
                elif r < 0.92:
                    m.delete(rng.choice(keyspace))
                else:
                    m.clear()
            if rng.random() < 0.7:
                for msg in m.take_outbox():
                    doc.submit(msg)
        doc.process_some(rng.randint(0, doc.pending_count))
    mod.pump(doc, maps)
    return doc, maps, keyspace, rng


@pytest.mark.parametrize("seed", range(6))
def test_map_farm_and_kernel_replay_match(seed, monkeypatch):
    """The reference farm in both packages, then the port's map program (on
    the CPU) replaying the port's log in random batch sizes gives the
    replicas' items, as the reference's jnp program does on its log."""
    from fluidframework_tpu_torch.ops import map_kernel as mpk

    case = (f"map{seed}", lambda: map_farm("fluidframework_tpu", seed)[1][0].items(),
            lambda: map_farm("fluidframework_tpu_torch", seed)[1][0].items())
    twins.run_pair(case, monkeypatch, seed=seed)
    doc, maps, keyspace, rng = map_farm("fluidframework_tpu_torch", seed)
    assert len({tuple(sorted(m.sequenced.items())) for m in maps}) == 1
    key_intern = {k: i for i, k in enumerate(keyspace)}
    ops = []
    for msg in doc.sequencer.log:
        if msg.type != "op":
            continue
        c = msg.contents
        if c["type"] == "set":
            ops.append((mpk.MapOpKind.SET, key_intern[c["key"]], c["value"], msg.seq))
        elif c["type"] == "delete":
            ops.append((mpk.MapOpKind.DELETE, key_intern[c["key"]], 0, msg.seq))
        else:
            ops.append((mpk.MapOpKind.CLEAR, -1, 0, msg.seq))
    state = mpk.init_state(max_keys=len(keyspace), device="cpu")
    i = 0
    while i < len(ops):
        n = rng.randint(1, 6)
        arr = np.array(ops[i:i + n], np.int32).reshape(-1, 4)
        i += n
        state = mpk.apply_batch(state, arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])
    assert mpk.host_items(state) == {key_intern[k]: v for k, v in maps[0].sequenced.items()}


def matrix_channel_farm(root: str, seed: int, churn: bool, rounds: int = 8):
    """Three containers with a ``sharedMatrix`` channel in package ``root``:
    row/col churn, cell writes (a switch to FWW on one seed), with ``churn``
    a disconnect and rejoin with parked ops and an offline stash, and a late
    joiner loaded from a summary.

    Returns every replica's grid, the late joiner's last.  With ``churn``
    the reference channel's replicas can diverge, or it can raise while it
    applies a resubmitted or stashed op (``_Perm.handle_at``: a position
    past the permutation); ROADMAP queue 3 records this among the
    reference's faults.  The farm then returns the error, and the port must
    raise it at the same message, or diverge the same way, with the same
    state recorded."""
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    channels, runtime = imp("dds.channels"), imp("runtime")
    doc = imp("server.local_service").LocalService().document("m")
    rng = random.Random(seed)

    def container(name, stash=None):
        rt = runtime.ContainerRuntime(channels.default_registry(), container_id=name)
        rt.create_datastore("root").create_channel("sharedMatrix", "g")
        rt.connect(doc, name, stash=stash)
        return rt

    grid = lambda rt: rt.datastore("root").get_channel("g")
    rts = [container(f"M{i}") for i in range(3)]
    doc.process_all()
    if seed % 3 == 2:
        grid(rts[0]).switch_to_fww()
    try:
        _matrix_rounds(rng, rts, grid, doc, container, churn, rounds)
    except IndexError as e:
        return ["raised", type(e).__name__, str(e)]
    late = runtime.ContainerRuntime(channels.default_registry(), container_id="late")
    late.create_datastore("root").create_channel("sharedMatrix", "g")
    grid(late).load(grid(rts[0]).summarize())
    return [grid(rt).to_grid() for rt in rts + [late]]


def _matrix_rounds(rng, rts, grid, doc, container, churn, rounds):
    epoch = 0
    for r in range(rounds):
        for rt in rts:
            g = grid(rt)
            for _ in range(rng.randint(1, 4)):
                nr, nc = g.row_count, g.col_count
                x = rng.random()
                if x < 0.2 or nr == 0:
                    g.insert_rows(rng.randint(0, nr), rng.randint(1, 2))
                elif x < 0.4 or nc == 0:
                    g.insert_cols(rng.randint(0, nc), rng.randint(1, 2))
                elif x < 0.5 and nr > 1:
                    g.remove_rows(rng.randrange(nr), 1)
                elif x < 0.58 and nc > 1:
                    g.remove_cols(rng.randrange(nc), 1)
                else:
                    g.set_cell(rng.randrange(nr), rng.randrange(nc), rng.choice(
                        [rng.randrange(999), "v%d" % rng.randrange(9), None]))
            if rng.random() < 0.7:
                rt.flush()
        if churn and r == 2:
            rts[1].disconnect()
        elif churn and r == 4:
            epoch += 1
            rts[1].connect(doc, f"M1.r{epoch}")
        elif churn and r == 5:
            stash = rts[2].get_pending_local_state()
            rts[2].close()
            rts[2] = container("M2.s", stash=stash)
        doc.process_some(rng.randint(0, doc.pending_count))
    for rt in rts:
        rt.flush()
    doc.process_all()


@pytest.mark.parametrize("churn", [False, True], ids=["steady", "churn"])
@pytest.mark.parametrize("seed", range(4))
def test_matrix_channel_farm_matches(seed, churn, monkeypatch):
    case = (f"matrix{seed}", lambda: matrix_channel_farm("fluidframework_tpu", seed, churn),
            lambda: matrix_channel_farm("fluidframework_tpu_torch", seed, churn))
    trace = twins.run_pair(case, monkeypatch, seed=seed)
    assert len(trace["logs"][0]) > 15
    if not churn:
        grids = trace["result"]
        assert grids[0] and all(g == grids[0] for g in grids), "matrix replicas diverged"


@pytest.mark.parametrize("name", ["sharedMatrix", "sharedMap"])
def test_golden_snapshot_loads_in_both(name):
    twins.check_golden(name)
