"""The port's undo-redo stacks against the JAX package's, exact.

The undo-redo cases of the reference's ``tests/test_framework.py`` (map
set/undo/redo, a string insert that slides under a concurrent edit, a
string remove re-inserted, a tree change reverted and redone, an insert
split by a remote insert, the listeners released on dispose), plus a seeded
farm of captured edits across the three channel kinds, run in both
packages.  The reference cases drive containers through
``framework.LocalServiceClient``, which the port does not have; here the
same containers are ``ContainerRuntime``s over ``LocalService`` holding a
``sharedString`` "text", a ``sharedMap`` "meta" and a ``sharedTree``
"doc".  Each case runs in both packages through ``torch_twins``: its
assertions must hold in both, and the two runs must agree message by
message and on every tree's forest and summaries.
"""

from __future__ import annotations

import importlib
import random

import pytest

import torch_twins as twins

ROOTS = ("fluidframework_tpu", "fluidframework_tpu_torch")


class Host:
    """One document and its containers in package ``root``."""

    def __init__(self, root: str, n: int = 1):
        imp = lambda m: importlib.import_module(f"{root}.{m}")
        self.cs = imp("dds.tree.changeset")
        self.leaf = imp("dds.tree.schema").leaf
        self.Manager = imp("framework").UndoRedoStackManager
        channels, runtime = imp("dds.channels"), imp("runtime")
        self.doc = imp("server.local_service").LocalService().document("doc1")
        self.rts = []
        for i in range(n):
            rt = runtime.ContainerRuntime(channels.default_registry(), container_id=f"c{i}")
            ds = rt.create_datastore("root")
            for kind, name in (("sharedString", "text"), ("sharedMap", "meta"),
                               ("sharedTree", "doc")):
                ds.create_channel(kind, name)
            rt.connect(self.doc, f"c{i}")
            self.rts.append(rt)
        self.doc.process_all()

    def ch(self, name: str, i: int = 0):
        return self.rts[i].datastore("root").get_channel(name)

    def sync(self, *which: int):
        for i in which or range(len(self.rts)):
            self.rts[i].flush()
        self.doc.process_all()


def tree_values(t) -> list:
    return [n.value for n in t.forest.root_field]


def undo_redo_map(root):
    h = Host(root)
    meta, ur = h.ch("meta"), h.Manager()
    ur.capture_map_set(meta, "k", 1)
    ur.close_current_operation()
    ur.capture_map_set(meta, "k", 2)
    ur.close_current_operation()
    h.sync()
    seen = [meta.get("k")]
    for step in ("undo", "undo", "redo", "redo"):
        getattr(ur, step)()
        h.sync()
        seen.append(meta.get("k"))
    assert seen == [2, 1, None, 1, 2]
    ur.capture_map_delete(meta, "k")
    ur.close_current_operation()
    h.sync()
    ur.undo()
    h.sync()
    assert meta.get("k") == 2
    return seen + [ur.undoable, ur.redoable]


def string_insert_slides(root):
    h = Host(root, 2)
    t1, t2, ur = h.ch("text", 0), h.ch("text", 1), h.Manager()
    t1.insert_text(0, "base ")
    h.sync()
    ur.capture_string_insert(t1, 5, "WORD")
    ur.close_current_operation()
    h.sync()
    t2.insert_text(0, ">>> ")
    h.sync()
    assert t1.text == ">>> base WORD"
    ur.undo()
    h.sync()
    assert t1.text == t2.text == ">>> base "
    ur.redo()
    h.sync()
    return [t1.text, t2.text]


def string_remove_reinserts(root):
    h = Host(root)
    t, ur = h.ch("text"), h.Manager()
    t.insert_text(0, "hello world")
    h.sync()
    ur.capture_string_remove(t, 5, 11)
    ur.close_current_operation()
    h.sync()
    assert t.text == "hello"
    ur.undo()
    h.sync()
    assert t.text == "hello world"
    ur.redo()
    h.sync()
    assert t.text == "hello"
    return t.text


def undo_tree_change(root):
    h = Host(root)
    tree, ur = h.ch("doc"), h.Manager()
    tree.submit_change(h.cs.make_insert([], "", 0, [h.leaf(1), h.leaf(2)]))
    h.sync()
    ur.capture_tree_change(tree, h.cs.make_set_value([("", 0)], 99))
    ur.close_current_operation()
    h.sync()
    seen = [tree_values(tree)]
    for step in ("undo", "redo"):
        getattr(ur, step)()
        h.sync()
        seen.append(tree_values(tree))
    assert seen == [[99, 2], [1, 2], [99, 2]]
    return seen


def insert_split_by_remote(root):
    h = Host(root, 2)
    t1, t2, ur = h.ch("text", 0), h.ch("text", 1), h.Manager()
    ur.capture_string_insert(t1, 0, "abcdef")
    ur.close_current_operation()
    h.rts[0].flush()
    t2.insert_text(0, "seed ")
    h.sync(1)
    assert t1.text == t2.text and "abcdef" in t1.text
    t2.insert_text(t2.text.index("abcdef") + 3, "XX")
    h.sync(1)
    assert "abcXXdef" in t1.text
    ur.undo()
    h.sync(0)
    assert t1.text == t2.text
    assert "abc" not in t1.text and "def" not in t1.text
    assert "XX" in t1.text and "seed " in t1.text
    return t1.text


def releases_listeners(root):
    h = Host(root)
    t, ur = h.ch("text"), h.Manager()
    for i in range(5):
        ur.capture_string_insert(t, 0, f"w{i} ")
        ur.close_current_operation()
        h.sync()
        ur.undo()
        h.sync()
        ur.capture_string_insert(t, 0, "k ")
        ur.close_current_operation()
        h.sync()
    ur.dispose()
    assert t._converged_listeners == []
    return t.text


def grouped_operation(root):
    """One operation spanning all three channels undoes and redoes as one."""
    h = Host(root, 2)
    ur = h.Manager()
    h.ch("doc").submit_change(h.cs.make_insert([], "", 0, [h.leaf(5)]))
    h.sync()
    ur.capture_string_insert(h.ch("text"), 0, "abc")
    ur.capture_map_set(h.ch("meta"), "m", {"x": 1})
    ur.capture_tree_change(h.ch("doc"), h.cs.make_set_value([("", 0)], 6))
    ur.close_current_operation()
    h.sync()
    states = []
    for step in ("undo", "redo", "undo"):
        getattr(ur, step)()
        h.sync()
        states.append([h.ch("text", 1).text, h.ch("meta", 1).get("m"),
                       tree_values(h.ch("doc", 1))])
    assert states[0] == ["", None, [5]] and states[1] == ["abc", {"x": 1}, [6]]
    return states


def undo_farm(seed: int):
    def run(root):
        rng = random.Random(seed)
        h = Host(root, 2)
        ur = h.Manager()
        out = []
        for _ in range(24):
            r = rng.random()
            t = h.ch("text")
            if r < 0.3:
                ur.capture_string_insert(t, rng.randint(0, len(t.text)), "w%d" % rng.randrange(9))
            elif r < 0.4 and len(t.text) > 1:
                a = rng.randrange(len(t.text) - 1)
                ur.capture_string_remove(t, a, rng.randint(a + 1, len(t.text)))
            elif r < 0.55:
                ur.capture_map_set(h.ch("meta"), rng.choice("ab"), rng.randrange(99))
            elif r < 0.7:
                tree = h.ch("doc")
                n = len(tree.forest.root_field)
                ur.capture_tree_change(tree, h.cs.make_insert(
                    [], "", rng.randint(0, n), [h.leaf(rng.randrange(99))]))
            elif r < 0.85:
                out.append(["undo", ur.undo()])
            else:
                out.append(["redo", ur.redo()])
            if rng.random() < 0.5:
                ur.close_current_operation()
            if rng.random() < 0.3:  # a concurrent remote edit
                h.ch("text", 1).insert_text(0, "r")
            if rng.random() < 0.6:
                h.sync()
        h.sync()
        a = [h.ch("text").text, h.ch("meta").items(), tree_values(h.ch("doc"))]
        b = [h.ch("text", 1).text, h.ch("meta", 1).items(), tree_values(h.ch("doc", 1))]
        assert a == b, "replicas diverged"
        return out + [a, ur.undoable, ur.redoable]

    run.__name__ = f"farm{seed}"
    return run


CASES = [undo_redo_map, string_insert_slides, string_remove_reinserts, undo_tree_change,
         insert_split_by_remote, releases_listeners, grouped_operation] + [
    undo_farm(s) for s in range(4)]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_undo_redo_matches(case, monkeypatch):
    twins.run_pair((case.__name__, lambda: case(ROOTS[0]), lambda: case(ROOTS[1])), monkeypatch)
