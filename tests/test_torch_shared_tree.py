"""The port's SharedTree channel against the JAX package's, exact.

Every test of the reference's ``tests/test_shared_tree.py`` (the seeded
convergence farm, transactions, rollback, stash, reconnect and resubmit,
schema ops, typed views, summaries), ``test_simple_tree.py`` (the
class-based views and their events) and ``test_tree_branch_schema.py``
(forks and merges, ``schema_compat``, upgrade flows) runs in both packages
through ``torch_twins``: the port's copy of each test must pass, and the
two runs must agree message by message on the wire and on every tree's
forest, ``em.summarize()``, ``summarize()`` and ``summary_tree()``.

Then a seeded farm of its own mixes everything in one document (schema op,
transactions and aborts, view reads, forks merged back, disconnects
and rejoins with resubmits, offline stashes, a late joiner loaded from a
summary), and the reference engine test's ``drive_tree_docs`` runs in the
port's copy: the same sequenced log, and the port's ``TreeBatchEngine``
agreeing with the reference's on it.
"""

from __future__ import annotations

import json
import random

import pytest

import torch_twins as twins

CASES = [c for f in ("test_shared_tree.py", "test_simple_tree.py", "test_tree_branch_schema.py")
         for c in twins.cases(f)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


# ------------------------------------------------------------------- farm


def farm(pkg_root: str, seed: int, rounds: int = 10):
    """One document, four writers and a late joiner in package
    ``pkg_root``; returns what the farm observed (twins records the rest)."""
    import importlib

    imp = lambda m: importlib.import_module(f"{pkg_root}.{m}")
    cs, schema = imp("dds.tree.changeset"), imp("dds.tree.schema")
    channels, runtime = imp("dds.channels"), imp("runtime")
    LocalService = imp("server.local_service").LocalService
    rng = random.Random(seed)
    doc = LocalService().document("farm")
    out = []

    def container(name, stash=None):
        rt = runtime.ContainerRuntime(channels.default_registry(), container_id=name)
        rt.create_datastore("root").create_channel("sharedTree", "t")
        rt.connect(doc, name, stash=stash)
        return rt

    tree = lambda rt: rt.datastore("root").get_channel("t")
    rts = [container(f"W{i}") for i in range(4)]
    doc.process_all()
    reg = schema.SchemaRegistry()
    reg.add(schema.array_schema("list", {"number"}))
    reg.root = schema.FieldSchema(schema.FieldKind.OPTIONAL, {"list", "number", "string"})
    tree(rts[0]).set_schema(reg)
    epoch = [0] * 4
    offline = set()

    def edit(t, n):
        kind = rng.choice(["ins", "ins", "rm", "set", "move"] if n else ["ins"])
        if kind == "ins":
            v = rng.randrange(1000) if rng.random() < 0.6 else "s%d" % rng.randrange(99)
            t.submit_change(cs.make_insert([], "", rng.randint(0, n), [schema.leaf(v)]))
        elif kind == "rm":
            i = rng.randrange(n)
            t.submit_change(cs.make_remove([], "", i, rng.randint(1, min(2, n - i))))
        elif kind == "set":
            t.submit_change(cs.make_set_value([("", rng.randrange(n))], rng.randrange(1000)))
        else:
            s = rng.randrange(n)
            t.submit_change(cs.make_move([], "", s, rng.randint(1, min(2, n - s)),
                                         rng.randint(0, n)))

    for r in range(rounds):
        for i, rt in enumerate(rts):
            t = tree(rt)
            for _ in range(rng.randint(1, 3)):
                edit(t, len(t.forest.root_field))
            roll = rng.random()
            if roll < 0.15:
                with t.transaction():
                    edit(t, len(t.forest.root_field))
                    edit(t, len(t.forest.root_field))
            elif roll < 0.25:
                try:
                    with t.transaction():
                        edit(t, len(t.forest.root_field))
                        raise RuntimeError("abort")
                except RuntimeError:
                    out.append(["aborted", i, r])
            elif roll < 0.35:
                br = t.fork()
                edit(br, len(br.forest.root_field))
                edit(br, len(br.forest.root_field))
                br.merge_into_parent()
            elif roll < 0.45:
                root = t.view.root
                out.append(["view", i, None if root is None else root.to_json()])
            if rng.random() < 0.7:
                rt.flush()
        if r % 4 == 1:
            rts[3].disconnect()
            offline.add(3)
        elif r % 4 == 3 and 3 in offline:
            epoch[3] += 1
            rts[3].connect(doc, f"W3.r{epoch[3]}")
            offline.discard(3)
        if r == 5:
            stash = rts[2].get_pending_local_state()
            rts[2].close()
            rts[2] = container("W2.s", stash=stash)
        doc.process_some(rng.randint(0, doc.pending_count))
    if offline:
        rts[3].connect(doc, "W3.last")
    for rt in rts:
        rt.flush()
    doc.process_all()
    late = runtime.ContainerRuntime(channels.default_registry(), container_id="late")
    late.create_datastore("root").create_channel("sharedTree", "t")
    tree(late).load(tree(rts[1]).summarize())
    forests = [json.dumps(tree(rt).forest.to_json(), sort_keys=True) for rt in rts + [late]]
    assert len(set(forests)) == 1, "the farm's replicas diverged"
    out.append(tree(rts[0]).forest.to_json())
    return out


@pytest.mark.parametrize("seed", range(3))
def test_mixed_farm_matches(seed, monkeypatch):
    case = (f"farm{seed}", lambda: farm("fluidframework_tpu", seed),
            lambda: farm("fluidframework_tpu_torch", seed))
    trace = twins.run_pair(case, monkeypatch, seed=seed)
    assert len(trace["logs"][0]) > 40


# ---------------------------------------------------- drive_tree_docs + engine


def test_drive_tree_docs_log_and_engine_match(monkeypatch):
    """The reference engine test's driver in both packages gives the same
    sequenced log, and the port's ``TreeBatchEngine`` (CPU) agrees with the
    reference's on every doc's raw columns, views and EditManager summary."""
    import test_tree_batch_engine as ref_tbe

    from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefEngine
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine as PortEngine
    from test_torch_tree_engine import assert_engines_equal

    port_tbe = twins.port_twin("test_tree_batch_engine.py")
    D = 4
    pkgs = twins.packages()
    runs = {}
    for key, mod in (("ref", ref_tbe), ("port", port_tbe)):
        trace, seen = twins.run_traced(
            lambda mod=mod: mod.drive_tree_docs(D, seed=5, steps=24, nested_prob=0.5)[1],
            pkgs[key], monkeypatch)
        runs[key] = (trace, seen["LocalDocument"])
    assert runs["port"][0] == runs["ref"][0]
    ref_eng, port_eng = RefEngine(D), PortEngine(D, device="cpu")
    for d in range(D):
        for m in runs["ref"][1][d].sequencer.log:
            ref_eng.ingest(d, m)
        for m in runs["port"][1][d].sequencer.log:
            port_eng.ingest(d, m)
    ref_eng.step()
    port_eng.step()
    assert_engines_equal(ref_eng, port_eng)
