"""Run a reference test module's cases in both packages and compare them.

``port_twin(file)`` loads a reference test file (``tests/<file>``) with
every ``fluidframework_tpu`` import pointed at ``fluidframework_tpu_torch``:
the port's own copy of the same test code.  ``cases(file)`` pairs each test
of the reference module with its twin (class methods and ``parametrize``d
cases expanded; tests that need a fixture this harness does not supply are
left out), and ``run_pair(case, monkeypatch)`` runs the two under the same
conditions.  ``cases`` supplies two of the reference's fixtures in either
package (and ``module_fixture`` a reference module's own fixture):
``env`` (``ENV_LOCAL``, a ``LocalService`` and its local driver
factory; ``ENV_NETWORK``, the network plane in-process over real sockets)
and the ``string_backend`` setup (``BACKENDS``: the ``RefMergeTree`` oracle,
or ``KernelMergeTree`` behind the channel boundary, the port's on the CPU).
Under ``run_pair``:

- both packages' sequencers read one counter clock in place of the wall
  clock, both packages' ``create_session_id`` and consensus-queue acquire
  ids draw from one seeded sequence each, and both packages' move-id
  counters start at 0, so timestamps, id-compressor sessions, acquire ids
  and move ids agree;
- network delta connections submit one at a time: each submit waits for
  the server's echo of a sync marker sent behind it, so the server
  sequences concurrent clients' ops in the order the test made them, and
  the default reconnect jitter of ``loader.connection_manager`` draws from
  a seeded generator;
- ``SummaryManager.tick()`` called without ``now`` reads a counter clock;
- every document, container runtime and tree, matrix and map replica the
  test builds is recorded, and after the test body (and, where it ran a
  network front, once the documents' logs stop growing: ``settle``) its
  observable state is taken: each document's sequenced messages (wire
  JSON, message by message), each tree channel's forest, ``em.summarize()``,
  ``summarize()`` and ``summary_tree()``, each runtime's ``summarize()``,
  each matrix's grid and summary and each map's items.

The two traces must be equal as canonical JSON (``sort_keys``), which keeps
``True`` apart from ``1`` and tuples equal to lists, as a reloaded summary
holds them.  The test body's own assertions must hold in both packages.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import itertools
import json
import os
import random
import re
import time
import types
import uuid
from types import SimpleNamespace

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = re.compile(r"\bfluidframework_tpu\b(?!_torch)")
_twins: dict[str, types.ModuleType] = {}


def port_twin(file: str, subs: tuple[tuple[str, str], ...] = ()) -> types.ModuleType:
    """The reference test module ``file`` with its package imports pointed
    at the port, and each ``(old, new)`` of ``subs`` replaced in its source
    (where the port's entry point spells an option differently)."""
    key = (file, subs)
    if key not in _twins:
        path = os.path.join(TESTS_DIR, file)
        with open(path) as f:
            src = _PKG.sub("fluidframework_tpu_torch", f.read())
        for old, new in subs:
            assert old in src, (file, old)
            src = src.replace(old, new)
        mod = types.ModuleType(f"port_twin_{file[:-3]}")
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        for name, obj in vars(mod).items():  # nothing of the reference left
            home = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
            assert not (isinstance(home, str) and home.startswith("fluidframework_tpu.")), name
        _twins[key] = mod
    return _twins[key]


def _param_sets(fn) -> list[dict]:
    """The keyword sets of a test's one-name ``parametrize`` marks."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            name, values = mark.args[0], mark.args[1]
            assert "," not in name, f"{fn.__name__}: one name a parametrize mark"
            sets = [dict(s, **{name: v}) for s in sets for v in values]
    return sets


@contextlib.contextmanager
def env_local(root: str):
    """The reference's ``env`` fixture, local: a ``LocalService`` and its
    local driver factory."""
    svc = importlib.import_module(f"{root}.server.local_service").LocalService()
    factory = importlib.import_module(f"{root}.driver").LocalDocumentServiceFactory
    yield svc, factory(svc)


@contextlib.contextmanager
def env_network(root: str):
    """The reference's ``env`` fixture, network: the service plane on
    ephemeral local ports and the network driver's factory."""
    net = importlib.import_module(f"{root}.testing.network_env").NetworkTestService()
    try:
        yield net, net.factory
    finally:
        net.close()


ENV_LOCAL = {"local": env_local}
ENV_NETWORK = {"local": env_local, "network": env_network}

# The reference conftest's ``string_backend`` kernel geometry.
KERNEL_GEOMETRY = dict(max_segments=1024, remove_slots=6, prop_slots=4,
                       text_capacity=16384, max_insert_len=16, ob_slots=16)


@contextlib.contextmanager
def oracle_backend(root: str):
    yield "oracle"


@contextlib.contextmanager
def kernel_backend(root: str):
    """``KernelMergeTree`` behind every string channel made in the block
    (the port's on the CPU), as the reference conftest's fixture does."""
    channels = importlib.import_module(f"{root}.dds.channels")
    kmt = importlib.import_module(f"{root}.dds.kernel_backend").KernelMergeTree
    extra = {"device": "cpu"} if root.endswith("_torch") else {}
    channels.set_string_backend_factory(lambda: kmt(**KERNEL_GEOMETRY, **extra))
    try:
        yield "kernel"
    finally:
        channels.set_string_backend_factory(None)


BACKENDS = {"oracle": oracle_backend, "kernel": kernel_backend}


def module_fixture(file: str, name: str, subs: tuple[tuple[str, str], ...] = ()):
    """A ``cases`` provider for the fixture ``name`` that the reference
    test module ``file`` defines itself: the reference's own function in
    the reference package, the twin's copy in the port (a generator
    fixture's teardown runs when the case ends)."""

    @contextlib.contextmanager
    def provide(root: str):
        mod = (port_twin(file, subs) if root.endswith("_torch")
               else importlib.import_module(file[:-3]))
        out = getattr(mod, name).__wrapped__()
        if not inspect.isgenerator(out):
            yield out
            return
        value = next(out)
        try:
            yield value
        finally:
            next(out, None)

    return provide


def cases(file: str, skip: tuple[str, ...] = (), fixtures: dict | None = None,
          setup: dict | None = None, subs: tuple[tuple[str, str], ...] = ()) -> list[tuple]:
    """``(id, ref_callable, port_callable)`` for every test of ``file``
    whose fixtures are supplied, in file order.

    ``fixtures`` maps a fixture name to ``{param_id: provider}``, and
    ``setup`` is one more ``{param_id: provider}`` axis entered around the
    test (a module's ``usefixtures``); a provider takes the package root
    and is a context manager yielding the fixture's value.  ``subs`` are
    source substitutions for the port's copy (``port_twin``)."""
    ref = importlib.import_module(file[:-3])
    port = port_twin(file, subs)
    fixtures = fixtures or {}
    setups = list((setup or {None: None}).items())
    out = []

    def add(name, ref_fn, port_fn, bind=None):
        if name in skip:
            return
        wanted = [p for p in inspect.signature(ref_fn).parameters if p != "self"]
        for params in _param_sets(ref_fn):
            missing = [w for w in wanted if w not in params]
            if set(missing) - set(fixtures):
                continue  # a fixture this harness does not provide
            axes = [list(fixtures[m].items()) for m in missing]
            for picks in itertools.product(*axes):
                for setup_id, setup_fn in setups:
                    given = dict(zip(missing, picks))
                    tag = "-".join([f"{v}" for v in params.values()]
                                   + [pid for pid, _ in picks]
                                   + ([setup_id] if setup_id else []))
                    cid = f"{file[5:-3]}::{name}" + (f"[{tag}]" if tag else "")
                    out.append((cid,
                                _bound(ref_fn, bind and bind[0], params, given, setup_fn,
                                       "fluidframework_tpu"),
                                _bound(port_fn, bind and bind[1], params, given, setup_fn,
                                       "fluidframework_tpu_torch")))

    for name, obj in vars(ref).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            add(name, obj, getattr(port, name))
        elif name.startswith("Test") and inspect.isclass(obj):
            for meth, fn in vars(obj).items():
                if meth.startswith("test_") and inspect.isfunction(fn):
                    add(f"{name}.{meth}", fn, getattr(port, name).__dict__[meth],
                        (obj, getattr(port, name)))
    return out


def _bound(fn, cls, params, given=None, setup=None, root=None):
    def call():
        with contextlib.ExitStack() as stack:
            if setup is not None:
                stack.enter_context(setup(root))
            kw = dict(params)
            for name, (_pid, provider) in (given or {}).items():
                kw[name] = stack.enter_context(provider(root))
            return fn(cls(), **kw) if cls is not None else fn(**kw)

    return call


def packages():
    """The two packages' modules a recorder patches, keyed ref/port."""
    out = {}
    for key, root in (("ref", "fluidframework_tpu"), ("port", "fluidframework_tpu_torch")):
        imp = lambda m, root=root: importlib.import_module(f"{root}.{m}")
        out[key] = SimpleNamespace(
            sequencer=imp("server.sequencer"), idc=imp("utils.id_compressor"),
            small=imp("dds.small"),
            changeset=imp("dds.tree.changeset"),
            LocalDocument=imp("server.local_service").LocalDocument,
            ContainerRuntime=imp("runtime.container_runtime").ContainerRuntime,
            SharedTreeChannel=imp("dds.tree.shared_tree").SharedTreeChannel,
            SharedMatrix=imp("dds.shared_matrix").SharedMatrix,
            SharedMatrixChannel=imp("dds.shared_matrix").SharedMatrixChannel,
            SharedMap=imp("dds.shared_map").SharedMap,
            network_driver=imp("driver.network_driver"),
            connection_manager=imp("loader.connection_manager"),
            summary=imp("runtime.summary"),
            NetworkServer=imp("server.netserver").NetworkServer,
        )
    return out


def seeded_session_ids(seed: int):
    rng = random.Random(seed)
    return lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4))


RECORDED = ("LocalDocument", "ContainerRuntime", "SharedTreeChannel", "SharedMatrix",
            "SharedMatrixChannel", "SharedMap", "NetworkServer")


def install(pkg, monkeypatch, seed: int = 0) -> dict[str, list]:
    """Patch one package: a counter clock, seeded session ids, and a record
    of every instance of the ``RECORDED`` classes built from now on."""
    tick = itertools.count(1)
    monkeypatch.setattr(pkg.sequencer, "time", SimpleNamespace(time=lambda: next(tick) / 8.0))
    monkeypatch.setattr(pkg.idc, "create_session_id", seeded_session_ids(seed))
    # Consensus-queue acquire ids are fresh UUIDs: one seeded sequence.
    acquire_ids = seeded_session_ids(seed)
    monkeypatch.setattr(pkg.small, "_uuid",
                        SimpleNamespace(uuid4=lambda: uuid.UUID(acquire_ids())))
    # Move ids come from a module-global counter: start both packages at 0,
    # whatever earlier tests in the process minted.
    monkeypatch.setattr(pkg.changeset, "_move_counter", 0)
    monkeypatch.setattr(pkg.network_driver.NetworkDeltaConnection, "submit",
                        serialized_submit(pkg.network_driver.NetworkDeltaConnection.submit))
    monkeypatch.setattr(pkg.connection_manager, "random",
                        SimpleNamespace(Random=lambda r=random.Random(seed): r))
    clock = itertools.count(1)
    tick_fn = pkg.summary.SummaryManager.tick
    monkeypatch.setattr(pkg.summary.SummaryManager, "tick",
                        lambda self, now=None: tick_fn(self, next(clock) / 1000.0
                                                       if now is None else now))
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


def serialized_submit(submit):
    """``NetworkDeltaConnection.submit`` followed by a wait for the server's
    echo of a sync marker sent behind the op: the server handles a
    socket's lines in order, so when the echo is in the connection's
    inbound queue the op is sequenced.  The echo stays queued (dispatching
    it later only sets ``_sync_seen``); nothing is dispatched here."""

    def run(self, message):
        submit(self, message)
        self._sync_counter += 1
        n = self._sync_counter
        self._send({"t": "sync", "n": n})
        deadline = time.monotonic() + 30.0
        while True:
            with self._inbound.mutex:
                if any(i.get("t") == "__eof__" or (i.get("t") == "sync" and i.get("n") == n)
                       for i in self._inbound.queue):
                    return
            if time.monotonic() > deadline:
                raise TimeoutError(f"submit not echoed by the server: sync {n}")
            time.sleep(0.0002)

    return run


def reference_encoder_loaded(limit_s: float = 120.0) -> bool:
    """Whether the reference's native ingest encoder is loaded in this
    process, retrying its load until ``limit_s`` has passed.

    The reference builds ``native/libtpuingest.so`` in place (g++ writes
    the library's own path) and keeps its first load attempt for the rest
    of the process.  On a checkout with no built library, test workers
    that warm it at once see the file while another worker's g++ is still
    writing it: the load fails, and that worker's reference engines decode
    on their Python path for the whole session, where the engines'
    ``health()["checkpoint_age_seqs"]`` differs from the native path's
    that the port's engines take.  So the parity tests load it here, again
    and again until the file is whole; ``False`` only when no library
    loads within the limit (no g++)."""
    ref = importlib.import_module("fluidframework_tpu.native.ingest_native")
    end = time.monotonic() + limit_s
    loaded = ref.warm()
    while not loaded and time.monotonic() < end:
        time.sleep(0.5)
        ref._lib_cache[:] = []  # the accessor loads a built library afresh
        loaded = ref._ensure_built() is not None
    return loaded


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


def settle(seen: dict[str, list], quiet_s: float = 0.2, limit_s: float = 10.0) -> None:
    """Where the body ran a network front, wait until no document's log has
    grown for ``quiet_s``: a socket the body closed without a goodbye is
    torn down on the server's handler thread, which sequences its leave
    after the body returned."""
    if not seen["NetworkServer"]:
        return
    lens, still, end = None, time.monotonic(), time.monotonic() + limit_s
    while time.monotonic() < end:
        now = [len(d.sequencer.log) for d in seen["LocalDocument"]]
        if now != lens:
            lens, still = now, time.monotonic()
        elif time.monotonic() - still >= quiet_s:
            return
        time.sleep(0.02)


def run_traced(fn, pkg, monkeypatch, seed: int = 0) -> tuple[str, dict]:
    """Run ``fn`` with ``pkg`` recorded; its trace as canonical JSON, and
    the recorded objects."""
    with monkeypatch.context() as mp:
        seen = install(pkg, mp, seed)
        result = fn()
        settle(seen)
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
