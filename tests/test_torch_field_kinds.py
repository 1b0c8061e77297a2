"""The port's field kinds and revision constraints against the JAX
package's, exact.

The scenarios of the reference's ``tests/test_field_kinds.py`` are written
once over a package namespace and run in both packages on the same seeded
inputs: the rebase convergence square and the invert and compose laws for
the sequence and optional kinds, the optional-field and commit codecs,
compose and invert over mixed-kind histories (and that neither mutates its
inputs), and revision constraints through the channel boundary, the
constraint fuzz included.  Each scenario's own assertions must hold in
both packages, and its record (changes as ``field_change_to_json`` /
``change_to_json`` / ``commit_to_json``, fields and forests as node JSON)
must be equal as canonical JSON.  ``torch_twins.run_pair`` runs each side
with a counter clock and seeded session ids and adds every document's
sequenced wire messages and every tree replica's forest and summaries to
the comparison.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import pytest

import torch_twins as twins

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"


def _ns(root: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    return SimpleNamespace(
        cs=imp("dds.tree.changeset"), fk=imp("dds.tree.field_kinds"),
        Node=imp("dds.tree.forest").Node, leaf=imp("dds.tree.schema").leaf,
        registry=imp("dds.channels").default_registry,
        ContainerRuntime=imp("runtime").ContainerRuntime,
        LocalService=imp("server.local_service").LocalService,
    )


def _match(fn, monkeypatch) -> dict:
    """``fn(namespace)`` in both packages; the records must be equal."""
    return twins.run_pair(
        (fn.__name__, lambda: fn(_ns(REF)), lambda: fn(_ns(PORT))), monkeypatch
    )["result"]


def _field(P, values) -> list:
    return [P.leaf(v) for v in values]


def _nodes(nodes) -> list:
    return [n.to_json() for n in nodes]


def _vals(nodes) -> list:
    return [n.value for n in nodes]


def _fc(P, change):
    return P.fk.field_change_to_json(change)


# ---------------------------------------------------------------- the kind laws

def _rand_seq_marks(P, rng, n: int) -> list:
    """Random move-free mark list over an n-node field (the reference
    test's generator)."""
    cs = P.cs
    marks = []
    pos = 0
    while pos < n:
        k = rng.random()
        if k < 0.4:
            step = rng.randint(1, n - pos)
            marks.append(cs.Skip(step))
            pos += step
        elif k < 0.6:
            marks.append(cs.Insert(_field(P, [rng.randrange(100) for _ in range(rng.randint(1, 2))])))
        elif k < 0.8:
            step = rng.randint(1, min(2, n - pos))
            marks.append(cs.Remove(step))
            pos += step
        else:
            marks.append(cs.Modify(cs.NodeChange(value=(rng.randrange(100),))))
            pos += 1
    if rng.random() < 0.5:
        marks.append(cs.Insert(_field(P, [rng.randrange(100)])))
    return marks


def _rand_opt_change(P, rng, occupied: bool):
    OC = P.fk.OptionalChange
    k = rng.random()
    if k < 0.4:
        return OC(set=(P.leaf(rng.randrange(100)),))
    if k < 0.6:
        return OC(set=(None,))
    if occupied:
        return OC(nested=P.cs.NodeChange(value=(rng.randrange(100),)))
    return OC(set=(P.leaf(rng.randrange(100)),))


def _opt_field(P, rng) -> list:
    return _field(P, [rng.randrange(100)]) if rng.random() < 0.7 else []


def seq_square(P, seed):
    """a sequenced first: apply(a) + rebase(b over a, later) == apply(b) +
    rebase(a over b, earlier)."""
    cs = P.cs
    rng = random.Random(seed)
    n = rng.randint(0, 6)
    base = [rng.randrange(100) for _ in range(n)]
    a, b = _rand_seq_marks(P, rng, n), _rand_seq_marks(P, rng, n)
    rec = {"a": _fc(P, a), "b": _fc(P, b)}
    f1 = _field(P, base)
    cs.apply_marks(f1, [cs._clone_mark(m) for m in a])  # a stays pristine
    rb = cs.rebase_marks(b, a, a_after=True)
    rec["b_over_a"] = _fc(P, rb)
    cs.apply_marks(f1, rb)
    f2 = _field(P, base)
    cs.apply_marks(f2, b)
    ra = cs.rebase_marks(a, b, a_after=False)
    rec["a_over_b"] = _fc(P, ra)
    cs.apply_marks(f2, ra)
    assert _nodes(f1) == _nodes(f2), seed
    rec["field"] = _nodes(f1)
    return rec


def seq_invert(P, seed):
    cs = P.cs
    rng = random.Random(seed)
    n = rng.randint(0, 6)
    f = _field(P, [rng.randrange(100) for _ in range(n)])
    a = _rand_seq_marks(P, rng, n)
    snapshot = _nodes(f)
    cs.apply_marks(f, a)  # enriches a
    inv = cs.invert_marks(a)
    rec = {"a": _fc(P, a), "inverse": _fc(P, inv), "applied": _nodes(f)}
    cs.apply_marks(f, inv)
    assert _nodes(f) == snapshot, seed
    return rec


def seq_compose(P, seed):
    cs = P.cs
    rng = random.Random(seed)
    n = rng.randint(0, 6)
    base = [rng.randrange(100) for _ in range(n)]
    a = _rand_seq_marks(P, rng, n)
    f1 = _field(P, base)
    cs.apply_marks(f1, a)
    b = _rand_seq_marks(P, rng, len(f1))
    composed = P.fk.compose_marks(a, b)
    rec = {"a": _fc(P, a), "b": _fc(P, b), "composed": _fc(P, composed)}
    cs.apply_marks(f1, b)
    f2 = _field(P, base)
    cs.apply_marks(f2, composed)
    assert _nodes(f1) == _nodes(f2), seed
    rec["field"] = _nodes(f1)
    return rec


def opt_square(P, seed):
    OPT = P.fk.OPTIONAL
    rng = random.Random(seed)
    base = _opt_field(P, rng)
    a, b = _rand_opt_change(P, rng, bool(base)), _rand_opt_change(P, rng, bool(base))
    rec = {"a": OPT.to_json(a), "b": OPT.to_json(b)}
    f1 = [n.clone() for n in base]
    OPT.apply(f1, OPT.from_json(OPT.to_json(a)))
    rb = OPT.rebase(b, a, a_after=True)
    rec["b_over_a"] = [OPT.is_empty(rb), OPT.to_json(rb)]
    if not OPT.is_empty(rb):
        OPT.apply(f1, OPT.from_json(OPT.to_json(rb)))
    f2 = [n.clone() for n in base]
    OPT.apply(f2, OPT.from_json(OPT.to_json(b)))
    ra = OPT.rebase(a, b, a_after=False)
    rec["a_over_b"] = [OPT.is_empty(ra), OPT.to_json(ra)]
    if not OPT.is_empty(ra):
        OPT.apply(f2, OPT.from_json(OPT.to_json(ra)))
    assert _nodes(f1) == _nodes(f2), seed
    rec["field"] = _nodes(f1)
    return rec


def opt_invert(P, seed):
    OPT = P.fk.OPTIONAL
    rng = random.Random(seed)
    base = _opt_field(P, rng)
    a = _rand_opt_change(P, rng, bool(base))
    f = [n.clone() for n in base]
    snapshot = _nodes(f)
    OPT.apply(f, a)  # enriches
    inv = OPT.invert(a)
    rec = {"a": OPT.to_json(a), "inverse": OPT.to_json(inv), "applied": _nodes(f)}
    OPT.apply(f, inv)
    assert _nodes(f) == snapshot, seed
    return rec


def opt_compose(P, seed):
    OPT = P.fk.OPTIONAL
    rng = random.Random(seed)
    base = _opt_field(P, rng)
    a = _rand_opt_change(P, rng, bool(base))
    f1 = [n.clone() for n in base]
    OPT.apply(f1, OPT.from_json(OPT.to_json(a)))
    b = _rand_opt_change(P, rng, bool(f1))
    composed = OPT.compose(OPT.from_json(OPT.to_json(a)), OPT.from_json(OPT.to_json(b)))
    rec = {"a": OPT.to_json(a), "b": OPT.to_json(b), "composed": OPT.to_json(composed)}
    OPT.apply(f1, OPT.from_json(OPT.to_json(b)))
    f2 = [n.clone() for n in base]
    OPT.apply(f2, composed)
    assert _nodes(f1) == _nodes(f2), seed
    rec["field"] = _nodes(f1)
    return rec


# Each law over the reference test's seeds.
LAWS = {
    "seq_square": (seq_square, range(40)),
    "seq_invert": (seq_invert, range(1000, 1040)),
    "seq_compose": (seq_compose, range(2000, 2040)),
    "opt_square": (opt_square, range(60)),
    "opt_invert": (opt_invert, range(500, 540)),
    "opt_compose": (opt_compose, range(900, 940)),
}


@pytest.mark.parametrize("law", list(LAWS))
def test_kind_laws_match_reference(law, monkeypatch):
    fn, seeds = LAWS[law]

    def run(P):
        return [fn(P, seed) for seed in seeds]

    run.__name__ = law
    assert len(_match(run, monkeypatch)) == len(seeds)


# ------------------------------------------------------------------ the codecs

def _codec_change(P, case):
    cs, OC = P.cs, P.fk.OptionalChange
    return {
        "optional_set": lambda: OC(set=(P.leaf(7),)),
        "optional_clear": lambda: OC(set=(None,)),
        "value_kind": lambda: OC(kind="value", set=(P.leaf(1), P.leaf(2))),
        "optional_nested": lambda: OC(nested=cs.NodeChange(value=(3,))),
        "sequence_marks": lambda: [cs.Skip(2), cs.Remove(1)],
    }[case]()


@pytest.mark.parametrize("case", ["optional_set", "optional_clear", "value_kind",
                                  "optional_nested", "sequence_marks"])
def test_field_change_codec_matches_reference(case, monkeypatch):
    def codec(P):
        data = P.fk.field_change_to_json(_codec_change(P, case))
        back = P.fk.field_change_from_json(data)
        assert P.fk.field_change_to_json(back) == data
        return data

    data = _match(codec, monkeypatch)
    if case == "sequence_marks":  # bare lists stay the sequence kind on the wire
        assert data == [["s", 2], ["r", 1]]


@pytest.mark.parametrize("constrained", [True, False], ids=["constraints", "bare_list"])
def test_commit_codec_matches_reference(constrained, monkeypatch):
    def codec(P):
        cs = P.cs
        if constrained:
            c = cs.Commit([cs.make_insert([], "", 0, _field(P, [1]))],
                          [cs.node_exists_constraint([("", 2)])])
        else:
            c = cs.Commit([cs.make_remove([], "", 0, 1)])
        data = cs.commit_to_json(c)
        back = cs.commit_from_json(data)
        assert back.constraints == c.constraints and not back.violated
        assert cs.commit_to_json(back) == data
        return data

    data = _match(codec, monkeypatch)
    # Constraint-free commits keep the bare-list wire shape.
    assert isinstance(data, dict) == constrained
    assert not constrained or data["constraints"]


# ---------------------------------------------------- compose and invert cases

def dispatch_kinds(P):
    """compose_node_change folds value + mixed-kind fields."""
    cs, OC = P.cs, P.fk.OptionalChange
    a = cs.NodeChange(value=(5,), fields={
        "seq": [cs.Insert(_field(P, [1, 2]))], "opt": OC(set=(P.leaf(9),))})
    node = P.Node(type="obj")
    cs.apply_node_change(node, a)  # enrich
    b = cs.NodeChange(value=(6,), fields={
        "seq": [cs.Skip(1), cs.Remove(1)], "opt": OC(nested=cs.NodeChange(value=(10,)))})
    composed = cs.compose_node_change(a, b)
    n2 = P.Node(type="obj")
    cs.apply_node_change(n2, composed)
    cs.apply_node_change(node, b)
    assert n2.to_json() == node.to_json()
    assert P.Node(type="obj").to_json() != n2.to_json()
    return [cs.change_to_json(x) for x in (a, b, composed)] + [n2.to_json()]


def _squash_restores(P, node, changes, commit=False):
    """Apply ``changes`` to ``node``, then the invert of their compose (of
    ``compose_commit`` with ``commit``): the change JSON and the node after
    each stage."""
    cs = P.cs
    rec = []
    for c in changes:
        cs.apply_node_change(node, c)
        rec.append(node.to_json())
    sq = cs.compose_commit(changes) if commit else cs.compose_node_change(*changes)
    inv = cs.invert_node_change(sq)
    cs.apply_node_change(node, inv)
    rec += [cs.change_to_json(sq), cs.change_to_json(inv), node.to_json()]
    return rec


def invert_sequence(P):
    """a modifies a node's value, b removes it: the squash's invert restores
    the original value, not the intermediate."""
    cs = P.cs
    node = P.Node(type="obj")
    node.fields["seq"] = _field(P, [1])
    rec = _squash_restores(P, node, [
        cs.NodeChange(fields={"seq": [cs.Modify(cs.NodeChange(value=(2,)))]}),
        cs.NodeChange(fields={"seq": [cs.Remove(1)]}),
    ])
    assert node.fields["seq"][0].value == 1
    return rec


def invert_optional(P):
    """a nested-edits the resident node, b replaces the field."""
    cs, OC = P.cs, P.fk.OptionalChange
    node = P.Node(type="obj")
    node.fields["opt"] = _field(P, [1])
    rec = _squash_restores(P, node, [
        cs.NodeChange(fields={"opt": OC(nested=cs.NodeChange(value=(2,)))}),
        cs.NodeChange(fields={"opt": OC(set=(P.leaf(9),))}),
    ])
    assert node.fields["opt"][0].value == 1
    return rec


def invert_commit(P):
    """Commit-level squash of an applied transaction round-trips."""
    cs = P.cs
    node = P.Node(type="obj")
    node.fields["seq"] = _field(P, [5, 6])
    rec = _squash_restores(P, node, [
        cs.NodeChange(fields={"seq": [cs.Modify(cs.NodeChange(value=(7,)))]}),
        cs.NodeChange(fields={"seq": [cs.Skip(1), cs.Remove(1)]}),
    ], commit=True)
    assert _vals(node.fields["seq"]) == [5, 6]
    return rec


def invert_mixed_empty(P):
    """Marks insert on an EMPTY field, a later optional set shadows it: the
    squash's invert restores the empty input field."""
    cs, OC = P.cs, P.fk.OptionalChange
    node = P.Node(type="obj")
    node.fields["mix"] = []
    rec = _squash_restores(P, node, [
        cs.NodeChange(fields={"mix": [cs.Insert(_field(P, [1]))]}),
        cs.NodeChange(fields={"mix": OC(set=(P.leaf(9),))}),
    ])
    assert node.fields["mix"] == []
    return rec


def invert_mixed_resident(P):
    """Marks modify the resident, a set follows: the squash's invert
    restores the original value."""
    cs, OC = P.cs, P.fk.OptionalChange
    node = P.Node(type="obj")
    node.fields["mix"] = _field(P, [1])
    rec = _squash_restores(P, node, [
        cs.NodeChange(fields={"mix": [cs.Modify(cs.NodeChange(value=(2,)))]}),
        cs.NodeChange(fields={"mix": OC(set=(P.leaf(9),))}),
    ])
    assert _vals(node.fields["mix"]) == [1]
    return rec


def no_mutation(P):
    """Composing and applying the composed change leaves the inputs as they
    were, and the enriched composed change still inverts."""
    cs = P.cs
    a = cs.NodeChange(fields={"only_a": [cs.Insert(_field(P, [1, 2]))],
                              "both": [cs.Modify(cs.NodeChange(value=(7,)))]})
    b = cs.NodeChange(fields={"both": [cs.Skip(1)], "only_b": [cs.Remove(1)]})
    node = P.Node(type="obj")
    node.fields["only_a"] = []
    node.fields["both"] = _field(P, [5])
    node.fields["only_b"] = _field(P, [8])
    a_before, b_before = cs.change_to_json(a), cs.change_to_json(b)
    composed = cs.compose_node_change(a, b)
    cs.apply_node_change(node, composed)
    assert cs.change_to_json(a) == a_before, "compose+apply mutated input a"
    assert cs.change_to_json(b) == b_before, "compose+apply mutated input b"
    rec = [a_before, b_before, cs.change_to_json(composed), node.to_json()]
    cs.apply_node_change(node, cs.invert_node_change(composed))
    assert node.fields["only_a"] == []
    assert _vals(node.fields["both"]) == [5] and _vals(node.fields["only_b"]) == [8]
    return rec + [node.to_json()]


def no_mutation_marks(P):
    """compose_marks places fresh copies of b's Insert content and Modify
    changes, not b's own."""
    cs = P.cs
    ma = [cs.Modify(cs.NodeChange(value=(3,)))]
    mb = [cs.Skip(1), cs.Insert(_field(P, [4]))]
    nodes = _field(P, [1])
    ma_before = _fc(P, ma)
    out = P.fk.compose_marks(ma, mb)
    rec = [_fc(P, out)]
    cs.apply_marks(nodes, out)
    assert _fc(P, ma) == ma_before
    assert mb[1].content[0].value == 4 and _vals(nodes) == [3, 4]
    return rec + [_nodes(nodes)]


def _mixed_history(P, a, b):
    """a then b on a fresh node, and their compose on another: equal."""
    cs = P.cs
    node = P.Node(type="obj")
    cs.apply_node_change(node, a)
    cs.apply_node_change(node, b)
    sq = cs.compose_node_change(a, b)
    n2 = P.Node(type="obj")
    cs.apply_node_change(n2, sq)
    assert n2.to_json() == node.to_json()
    return [cs.change_to_json(sq), n2.to_json()]


def mixed_set_shadows(P):
    cs, OC = P.cs, P.fk.OptionalChange
    return _mixed_history(P, cs.NodeChange(fields={"f": [cs.Insert(_field(P, [1, 2]))]}),
                          cs.NodeChange(fields={"f": OC(set=(P.leaf(9),))}))


def mixed_marks_into_set(P):
    cs, OC = P.cs, P.fk.OptionalChange
    return _mixed_history(P, cs.NodeChange(fields={"f": OC(set=(P.leaf(5),))}),
                          cs.NodeChange(fields={"f": [cs.Modify(cs.NodeChange(value=(6,)))]}))


def mixed_nested_as_modify(P):
    cs, OC = P.cs, P.fk.OptionalChange
    return _mixed_history(P, cs.NodeChange(fields={"f": [cs.Insert(_field(P, [7]))]}),
                          cs.NodeChange(fields={"f": OC(nested=cs.NodeChange(value=(8,)))}))


def voided_optional_invert(P):
    """A nested edit rebased over a set is empty, and so is its invert."""
    OPT, OC = P.fk.OPTIONAL, P.fk.OptionalChange
    empty = OPT.rebase(OC(nested=P.cs.NodeChange(value=(1,))), OC(set=(P.leaf(2),)),
                       a_after=True)
    assert OPT.is_empty(empty)
    inv = OPT.invert(empty)  # must not raise
    assert OPT.is_empty(inv)
    return [OPT.to_json(empty), OPT.to_json(inv)]


COMPOSE = {fn.__name__: fn for fn in (
    dispatch_kinds, invert_sequence, invert_optional, invert_commit, invert_mixed_empty,
    invert_mixed_resident, no_mutation, no_mutation_marks, mixed_set_shadows,
    mixed_marks_into_set, mixed_nested_as_modify, voided_optional_invert,
)}


@pytest.mark.parametrize("case", list(COMPOSE))
def test_compose_and_invert_match_reference(case, monkeypatch):
    assert _match(COMPOSE[case], monkeypatch)


# ------------------------------------------- the channel and revision constraints

def _tree_fleet(P, n=2):
    doc = P.LocalService().document("doc")
    rts = []
    for i in range(n):
        rt = P.ContainerRuntime(P.registry(), container_id=f"c{i}")
        rt.create_datastore("root").create_channel("sharedTree", "t")
        rt.connect(doc, f"c{i}")
        rts.append(rt)
    doc.process_all()
    return doc, rts, [rt.datastore("root").get_channel("t") for rt in rts]


def _sync(doc, rts):
    for rt in rts:
        rt.flush()
    doc.process_all()


def _converged(trees) -> list:
    """Every replica's forest equals the first's; the values of its root
    field."""
    for t in trees[1:]:
        assert t.forest.equal(trees[0].forest)
    return _vals(trees[0].forest.root_field)


def optional_convergence(P):
    """Concurrent optional-field sets: the later-sequenced wins on every
    replica; a clear against a nested edit converges too."""
    cs = P.cs
    doc, rts, (a, b) = _tree_fleet(P)
    a.submit_change(cs.make_insert([], "", 0, [P.Node(type="obj")]))
    _sync(doc, rts)
    a.submit_change(cs.make_optional_set([("", 0)], "meta", P.leaf(1)))
    b.submit_change(cs.make_optional_set([("", 0)], "meta", P.leaf(2)))
    _sync(doc, rts)
    meta = [t.forest.root_field[0].fields["meta"][0].value for t in (a, b)]
    assert meta == [2, 2]  # b sequenced later, later wins
    a.submit_change(cs.make_optional_edit([("", 0)], "meta", cs.NodeChange(value=(5,))))
    b.submit_change(cs.make_optional_set([("", 0)], "meta", None))
    _sync(doc, rts)
    for t in (a, b):
        assert t.forest.root_field[0].fields.get("meta", []) == []
    _converged([a, b])
    return meta


def _constrained_race(P, first, constrained, concurrent, values):
    """Seed the root field with ``values``; ``constrained(a)`` and
    ``concurrent(b)`` race, and ``first`` (0 or 1) is sequenced first."""
    doc, rts, (a, b) = _tree_fleet(P)
    a.submit_change(P.cs.make_insert([], "", 0, _field(P, values)))
    _sync(doc, rts)
    constrained(a)
    concurrent(b)
    rts[first].flush()
    rts[1 - first].flush()
    doc.process_all()
    return _converged([a, b])


def node_exists_voids(P):
    """B removes the node A constrained on (B sequenced first): A's edit
    no-ops on every replica, A's own optimistic view included."""
    cs = P.cs
    out = _constrained_race(
        P, 1,
        lambda a: a.submit_change(cs.make_set_value([("", 1)], 99),
                                  constraints=[cs.node_exists_constraint([("", 1)])]),
        lambda b: b.submit_change(cs.make_remove([], "", 1, 1)),
        [10, 20, 30])
    assert out == [10, 30]
    return out


def constraint_path_shift(P):
    """An insert before the constrained node shifts the constraint's path;
    the commit still applies."""
    cs = P.cs
    out = _constrained_race(
        P, 1,
        lambda a: a.submit_change(cs.make_set_value([("", 1)], 99),
                                  constraints=[cs.node_exists_constraint([("", 1)])]),
        lambda b: b.submit_change(cs.make_insert([], "", 0, _field(P, [5]))),
        [10, 20])
    assert out == [5, 10, 99]
    return out


def no_change_voided(P):
    """An edit of the subtree voids a no-change constrained transaction."""
    cs = P.cs

    def txn(a):
        with a.transaction(constraints=[cs.no_change_constraint([("", 0)])]):
            a.submit_change(cs.make_insert([], "", 2, _field(P, [77])))

    out = _constrained_race(
        P, 1, txn, lambda b: b.submit_change(cs.make_set_value([("", 0)], 11)), [10, 20])
    assert out == [11, 20]
    return out


def incoming_not_judged_locally(P):
    """A sequenced commit's constraints were settled at sequencing: a local
    unsequenced remove of the constrained node does not void it on this
    replica only."""
    cs = P.cs
    doc, rts, (a, b) = _tree_fleet(P)
    a.submit_change(cs.make_insert([], "", 0, _field(P, [10, 20, 30])))
    _sync(doc, rts)
    b.submit_change(cs.make_set_value([("", 1)], 77),
                    constraints=[cs.node_exists_constraint([("", 1)])])
    rts[1].flush()
    a.submit_change(cs.make_remove([], "", 1, 1))  # pending, unflushed
    doc.process_all()
    _sync(doc, rts[:1])
    out = _converged([a, b])
    assert out == [10, 30]
    return out


def void_with_lww_suppressed_prior(P):
    """A voided pending set whose recorded prior is stale (it had
    LWW-suppressed a concurrent sequenced set) still converges to the
    trunk: A's commit stays concurrent with S1/S2 across an offline
    window."""
    cs = P.cs
    doc, rts, (a, b) = _tree_fleet(P)
    a.submit_change(cs.make_insert([], "", 0, _field(P, [10, 20])))
    _sync(doc, rts)
    rts[0].disconnect()
    a.submit_change(cs.make_set_value([("", 0)], 99),
                    constraints=[cs.node_exists_constraint([("", 1)])])
    b.submit_change(cs.make_set_value([("", 0)], 55))
    b.submit_change(cs.make_remove([], "", 1, 1))
    _sync(doc, rts[1:])
    rts[0].connect(doc, "c0-re")  # catch-up bridges S1 then S2, voids A
    _sync(doc, rts[:1])
    out = _converged([a, b])
    assert out == [55]
    return out


CHANNEL = {fn.__name__: fn for fn in (
    optional_convergence, node_exists_voids, constraint_path_shift, no_change_voided,
    incoming_not_judged_locally, void_with_lww_suppressed_prior,
)}


@pytest.mark.parametrize("case", list(CHANNEL))
def test_channel_constraints_match_reference(case, monkeypatch):
    trace = twins.run_pair(
        (case, lambda: CHANNEL[case](_ns(REF)), lambda: CHANNEL[case](_ns(PORT))), monkeypatch
    )
    assert trace["logs"] and len(trace["trees"]) >= 2


@pytest.mark.parametrize("seed", [3, 17, 31])
def test_constraint_fuzz_matches_reference(seed, monkeypatch):
    """Random constrained and unconstrained edits from three writers under
    random interleaving: every replica's tree stays identical, and the two
    packages sequence the same wire messages into the same trees."""

    def fuzz(P):
        cs = P.cs
        rng = random.Random(seed)
        doc, rts, trees = _tree_fleet(P, 3)
        trees[0].submit_change(cs.make_insert([], "", 0, _field(P, list(range(6)))))
        _sync(doc, rts)
        for _step in range(25):
            i = rng.randrange(3)
            rt, t = rts[i], trees[i]
            n = len(t.forest.root_field)
            kind = rng.choices(["ins", "rm", "set", "cons"], [4, 2, 3, 3])[0]
            if kind == "ins" or n == 0:
                t.submit_change(cs.make_insert([], "", rng.randint(0, n),
                                               _field(P, [rng.randrange(100)])))
            elif kind == "rm":
                t.submit_change(cs.make_remove([], "", rng.randrange(n), 1))
            elif kind == "set":
                t.submit_change(cs.make_set_value([("", rng.randrange(n))], rng.randrange(100)))
            else:
                idx = rng.randrange(n)
                ctor = cs.node_exists_constraint if rng.random() < 0.6 else cs.no_change_constraint
                t.submit_change(cs.make_set_value([("", idx)], rng.randrange(100)),
                                constraints=[ctor([("", idx)])])
            if rng.random() < 0.5:
                rt.flush()
            if rng.random() < 0.4:
                doc.process_some(rng.randint(0, doc.pending_count))
        _sync(doc, rts)
        ref = trees[0].forest.to_json()
        for t in trees[1:]:
            assert t.forest.to_json() == ref, seed
        return ref

    fuzz.__name__ = f"constraint_fuzz_{seed}"
    trace = twins.run_pair((fuzz.__name__, lambda: fuzz(_ns(REF)), lambda: fuzz(_ns(PORT))),
                           monkeypatch)
    # Some commits carried constraints on the wire.
    assert any("constraints" in m for m in trace["logs"][0])
