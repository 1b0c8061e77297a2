"""Run a reference test module's cases in both packages and compare them.

``port_twin(file)`` loads a reference test file (``tests/<file>``) with
every ``fluidframework_tpu`` import pointed at ``fluidframework_tpu_torch``:
the port's own copy of the same test code.  ``cases(file)`` pairs each test
of the reference module with its twin (class methods and ``parametrize``d
cases expanded; tests that need fixtures are left out), and
``run_pair(case, monkeypatch)`` runs the two under the same conditions:

- both packages' sequencers read one counter clock in place of the wall
  clock, both packages' ``create_session_id`` draw from one seeded
  sequence, and both packages' move-id counters start at 0, so
  timestamps, id-compressor sessions and move ids agree;
- every document, container runtime and tree, matrix and map replica the
  test builds is recorded, and after the test body its observable state is
  taken: each document's sequenced messages (wire JSON, message by
  message), each tree channel's forest, ``em.summarize()``,
  ``summarize()`` and ``summary_tree()``, each runtime's ``summarize()``,
  each matrix's grid and summary and each map's items.

The two traces must be equal as canonical JSON (``sort_keys``), which keeps
``True`` apart from ``1`` and tuples equal to lists, as a reloaded summary
holds them.  The test body's own assertions must hold in both packages.
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import json
import os
import random
import re
import types
import uuid
from types import SimpleNamespace

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = re.compile(r"\bfluidframework_tpu\b(?!_torch)")
_twins: dict[str, types.ModuleType] = {}


def port_twin(file: str) -> types.ModuleType:
    """The reference test module ``file`` with its package imports pointed
    at the port."""
    if file not in _twins:
        path = os.path.join(TESTS_DIR, file)
        with open(path) as f:
            src = _PKG.sub("fluidframework_tpu_torch", f.read())
        mod = types.ModuleType(f"port_twin_{file[:-3]}")
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        for name, obj in vars(mod).items():  # nothing of the reference left
            home = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
            assert not (isinstance(home, str) and home.startswith("fluidframework_tpu.")), name
        _twins[file] = mod
    return _twins[file]


def _param_sets(fn) -> list[dict]:
    """The keyword sets of a test's one-name ``parametrize`` marks."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            name, values = mark.args[0], mark.args[1]
            assert "," not in name, f"{fn.__name__}: one name a parametrize mark"
            sets = [dict(s, **{name: v}) for s in sets for v in values]
    return sets


def cases(file: str, skip: tuple[str, ...] = ()) -> list[tuple]:
    """``(id, ref_callable, port_callable)`` for every test of ``file``
    that needs no fixture, in file order."""
    ref = importlib.import_module(file[:-3])
    port = port_twin(file)
    out = []

    def add(name, ref_fn, port_fn, bind=None):
        if name in skip:
            return
        for params in _param_sets(ref_fn):
            wanted = [p for p in inspect.signature(ref_fn).parameters if p != "self"]
            if set(wanted) - set(params):
                continue  # a fixture this harness does not provide
            tag = "-".join(f"{v}" for v in params.values())
            cid = f"{file[5:-3]}::{name}" + (f"[{tag}]" if tag else "")
            out.append((cid, _bound(ref_fn, bind and bind[0], params),
                        _bound(port_fn, bind and bind[1], params)))

    for name, obj in vars(ref).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            add(name, obj, getattr(port, name))
        elif name.startswith("Test") and inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if meth.startswith("test_") and inspect.isfunction(fn):
                    add(f"{name}.{meth}", fn, getattr(port, name).__dict__[meth],
                        (obj, getattr(port, name)))
    return out


def _bound(fn, cls, params):
    if cls is None:
        return lambda: fn(**params)
    return lambda: fn(cls(), **params)


def packages():
    """The two packages' modules a recorder patches, keyed ref/port."""
    out = {}
    for key, root in (("ref", "fluidframework_tpu"), ("port", "fluidframework_tpu_torch")):
        imp = lambda m, root=root: importlib.import_module(f"{root}.{m}")
        out[key] = SimpleNamespace(
            sequencer=imp("server.sequencer"), idc=imp("utils.id_compressor"),
            changeset=imp("dds.tree.changeset"),
            LocalDocument=imp("server.local_service").LocalDocument,
            ContainerRuntime=imp("runtime.container_runtime").ContainerRuntime,
            SharedTreeChannel=imp("dds.tree.shared_tree").SharedTreeChannel,
            SharedMatrix=imp("dds.shared_matrix").SharedMatrix,
            SharedMatrixChannel=imp("dds.shared_matrix").SharedMatrixChannel,
            SharedMap=imp("dds.shared_map").SharedMap,
        )
    return out


def seeded_session_ids(seed: int):
    rng = random.Random(seed)
    return lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4))


RECORDED = ("LocalDocument", "ContainerRuntime", "SharedTreeChannel", "SharedMatrix",
            "SharedMatrixChannel", "SharedMap")


def install(pkg, monkeypatch, seed: int = 0) -> dict[str, list]:
    """Patch one package: a counter clock, seeded session ids, and a record
    of every instance of the ``RECORDED`` classes built from now on."""
    tick = itertools.count(1)
    monkeypatch.setattr(pkg.sequencer, "time", SimpleNamespace(time=lambda: next(tick) / 8.0))
    monkeypatch.setattr(pkg.idc, "create_session_id", seeded_session_ids(seed))
    # Move ids come from a module-global counter: start both packages at 0,
    # whatever earlier tests in the process minted.
    monkeypatch.setattr(pkg.changeset, "_move_counter", 0)
    seen: dict[str, list] = {name: [] for name in RECORDED}
    for name in RECORDED:
        cls = getattr(pkg, name)
        init = cls.__init__

        def rec_init(self, *a, _init=init, _into=seen[name], _cls=cls, **kw):
            _init(self, *a, **kw)
            if type(self) is _cls:
                _into.append(self)

        monkeypatch.setattr(cls, "__init__", rec_init)
    return seen


def _try(fn):
    try:
        return fn()
    except Exception as e:  # the same refusal must come from both packages
        return ["raised", type(e).__name__, str(e)]


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=lambda o: f"<{type(o).__name__}>")


def observe(seen: dict[str, list]) -> dict:
    """The recorded objects' observable state, in creation order."""
    return {
        "logs": [[m.to_json() for m in d.sequencer.log] for d in seen["LocalDocument"]],
        "trees": [{
            "forest": t.forest.to_json(),
            "em": _try(t.em.summarize),
            "summarize": _try(t.summarize),
            "summary_tree": _try(lambda t=t: t.summary_tree(None, "p")),
            "schema": t.schema.to_json(),
        } for t in seen["SharedTreeChannel"]],
        "runtimes": [_try(rt.summarize) for rt in seen["ContainerRuntime"]],
        "matrices": [_try(m.to_grid) for m in seen["SharedMatrix"]],
        "matrix_channels": [[_try(m.to_grid), _try(m.summarize)]
                            for m in seen["SharedMatrixChannel"]],
        "maps": [[m.sequenced, _try(m.items)] for m in seen["SharedMap"]],
    }


def run_traced(fn, pkg, monkeypatch, seed: int = 0) -> tuple[str, dict]:
    """Run ``fn`` with ``pkg`` recorded; its trace as canonical JSON, and
    the recorded objects."""
    with monkeypatch.context() as mp:
        seen = install(pkg, mp, seed)
        result = fn()
        trace = _canon({"result": result, **observe(seen)})
    return trace, seen


def run_pair(case, monkeypatch, seed: int = 0) -> dict:
    """Run a ``cases`` entry in both packages; the traces must be equal.
    Returns the port's trace."""
    _cid, ref_fn, port_fn = case
    pkgs = packages()
    want, _ = run_traced(ref_fn, pkgs["ref"], monkeypatch, seed)
    got, _ = run_traced(port_fn, pkgs["port"], monkeypatch, seed)
    if got != want:
        a, b = json.loads(got), json.loads(want)
        keys = [k for k in a if a[k] != b[k]]
        pytest.fail(f"port and reference differ in {keys}")
    return json.loads(got)


# ------------------------------------------------------- the snapshot corpus
# The reference's golden corpus (``fluidframework_tpu/testing/
# snapshot_corpus.py``, committed as ``tests/snapshots/*.json``) scripted in
# either package for the channel types the port has, with the reference
# corpus's state extractors.

SNAPSHOT_DIR = os.path.join(TESTS_DIR, "snapshots")
SESSION_PIN = "00000000-0000-4000-8000-00000000c0de"


def corpus_channel(root: str, name: str):
    """Run the corpus script for channel type ``name`` in package ``root``;
    the settled writer channel."""
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    doc = imp("server.local_service").LocalService().document("corpus")
    c = imp("runtime").ContainerRuntime(imp("dds.channels").default_registry(),
                                        container_id="writer")
    ch = c.create_datastore("root").create_channel(name, {
        "sharedMap": "kv", "sharedMatrix": "grid", "sharedTree": "tree"}[name])
    c.connect(doc, "writer")
    doc.process_all()
    if name == "sharedMap":
        ch.set("alpha", 1)
        ch.set("beta", {"nested": [1, 2, 3]})
        ch.set("gamma", "to-delete")
        ch.delete("gamma")
    elif name == "sharedMatrix":
        ch.insert_rows(0, 3)
        ch.insert_cols(0, 2)
        ch.set_cell(0, 0, "a")
        ch.set_cell(2, 1, 42)
        ch.remove_rows(1, 1)
    else:
        cs, schema = imp("dds.tree.changeset"), imp("dds.tree.schema")
        ch.idc = imp("utils.id_compressor").IdCompressor(session_id=SESSION_PIN)
        for i, v in enumerate([10, 20, 30]):
            ch.submit_change(cs.make_insert([], "", i, [schema.leaf(v)]))
        ch.submit_change(cs.make_set_value([("", 1)], 99))
        with ch.transaction():
            ch.submit_change(cs.make_insert([], "", 3, [schema.leaf(40)]))
    c.flush()
    doc.process_all()
    return ch


def corpus_state(name: str, ch) -> dict:
    if name == "sharedMap":
        return {"entries": {k: ch.get(k) for k in sorted(ch.keys())}}
    if name == "sharedMatrix":
        return {"rows": ch.row_count, "cols": ch.col_count,
                "cells": [[ch.get_cell(r, c) for c in range(ch.col_count)]
                          for r in range(ch.row_count)]}
    return {"forest": ch.forest.to_json()}


def canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, indent=1)


def check_golden(name: str) -> None:
    """The committed ``<name>.v1.json`` in both packages: each loads it into
    a fresh channel that reproduces the recorded state and re-summarizes to
    the recorded summary, and each package's corpus script writes the
    committed file byte for byte."""
    path = os.path.join(SNAPSHOT_DIR, f"{name}.v1.json")
    with open(path) as f:
        committed = f.read()
    entry = json.loads(committed)
    for root in ("fluidframework_tpu", "fluidframework_tpu_torch"):
        imp = lambda m, root=root: importlib.import_module(f"{root}.{m}")
        sf = imp("protocol.snapshot_formats")
        ch = imp("dds.channels").default_registry()[name].create("golden")
        ch.load(sf.upgrade(name, entry["summary"], entry["format"]))
        assert corpus_state(name, ch) == entry["state"], root
        assert canonical(ch.summarize()) == canonical(entry["summary"]), root
        written = corpus_channel(root, name)
        rebuilt = {"type": name, "format": sf.current_format(name),
                   "summary": written.summarize(), "state": corpus_state(name, written)}
        assert canonical(rebuilt) + "\n" == committed, root
