"""The port's SharedString client path against the JAX package's.

``ContainerRuntime`` + ``LocalService`` + ``SharedStringChannel`` (and a
``SharedMapChannel`` beside it) in both packages, driven in lockstep by one
seeded script: edits of every kind (text, rich annotates, markers, plain
and sided obliterates, plain and sided intervals, map sets and deletes),
flushes, syncs, reconnects with pending ops (the kernel replicas
regenerate through K5) and offline stashes re-applied by
``apply_stashed``.  The fleets mix ``KernelMergeTree`` replicas
(``device="cpu"`` on the port) and ``RefMergeTree`` ones.  Exact
equality: after every sync each client's text, position text, resolved
annotations, markers, intervals and map items agree across the packages
(and every live replica of a package agrees with the others), each
kernel replica's raw state columns and error latch equal its reference
twin's; at the end the sequenced message streams and every container's
summary are equal.

The registry: ``default_registry()`` holds the reference's 16 channel
types; each is built in both packages, edited, summarized and reloaded
alike, and an unknown type raises ``KeyError`` in both.

The two sequencers read a counter in place of the wall clock, so the
stamped timestamps (and the attributor tables built from them) agree.
One kernel geometry (S=112, T=1792, L=8, OB=6), used by no other file.
"""

from __future__ import annotations

import importlib
import itertools
import json
import random
from types import SimpleNamespace
from typing import NamedTuple

import pytest

from fluidframework_tpu.dds import channels as ref_channels
from fluidframework_tpu.dds.kernel_backend import KernelMergeTree as RefKMT
from fluidframework_tpu.dds.mergetree_ref import RefMergeTree as RefOracle
from fluidframework_tpu.runtime import ContainerRuntime as RefRuntime
from fluidframework_tpu.server import sequencer as ref_sequencer
from fluidframework_tpu.server.local_service import LocalService as RefService
from fluidframework_tpu_torch.dds import channels as port_channels
from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree as PortKMT
from fluidframework_tpu_torch.dds.mergetree_ref import RefMergeTree as PortOracle
from fluidframework_tpu_torch.runtime import ContainerRuntime as PortRuntime
from fluidframework_tpu_torch.server import sequencer as port_sequencer
from fluidframework_tpu_torch.server.local_service import LocalService as PortService

import torch_twins as twins
from test_torch_kernel_merge_tree import assert_raw_equal, message_stream

KGEOM = dict(max_segments=112, remove_slots=4, prop_slots=4, text_capacity=1792,
             max_insert_len=8, ob_slots=6)


class Pkg(NamedTuple):
    name: str
    Service: type
    Runtime: type
    channels: object
    make_kernel: object
    Oracle: type


REF = Pkg("ref", RefService, RefRuntime, ref_channels, lambda: RefKMT(**KGEOM), RefOracle)
PORT = Pkg("port", PortService, PortRuntime, port_channels,
           lambda: PortKMT(**KGEOM, device="cpu"), PortOracle)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """A counter clock in each package's sequencer, and each package's
    module-global backend factory reset after the test."""
    for mod in (ref_sequencer, port_sequencer):
        tick = itertools.count(1)
        monkeypatch.setattr(mod, "time", SimpleNamespace(time=lambda t=tick: next(t) / 8.0))
    yield
    ref_channels.set_string_backend_factory(None)
    port_channels.set_string_backend_factory(None)


class Fleet:
    """One package's document with its containers, each holding a
    ``sharedString`` "s" and a ``sharedMap`` "m" in datastore "root"."""

    def __init__(self, pkg: Pkg, kinds: str, track_attribution: bool = False):
        self.pkg = pkg
        self.doc = pkg.Service().document("d")
        self.track = track_attribution
        self.kinds = list(kinds)
        self.clients = [self.container(f"C{i}", k) for i, k in enumerate(kinds)]
        self.epoch = [0] * len(kinds)
        self.doc.process_all()

    def container(self, name: str, kind: str, stash: str | None = None):
        ch = self.pkg.channels
        ch.set_string_backend_factory(self.pkg.make_kernel if kind == "k" else None)
        try:
            rt = self.pkg.Runtime(ch.default_registry(), container_id=name,
                                  track_attribution=self.track)
            ds = rt.create_datastore("root")
            ds.create_channel("sharedString", "s")
            ds.create_channel("sharedMap", "m")
            rt.connect(self.doc, name, stash=stash)
        finally:
            ch.set_string_backend_factory(None)
        return rt

    def s(self, i: int):
        return self.clients[i].datastore("root").get_channel("s")

    def m(self, i: int):
        return self.clients[i].datastore("root").get_channel("m")

    def live(self) -> list[int]:
        return [i for i, rt in enumerate(self.clients) if rt.has_document and rt.joined]

    # ------------------------------------------------------------- actions
    def act(self, action: tuple) -> None:
        kind, i, *rest = action
        rt = self.clients[i]
        if kind == "edit":
            apply_edit(self, i, rest[0])
        elif kind == "flush":
            rt.flush()
        elif kind == "sync":
            for c in self.clients:
                if c.has_document:
                    c.flush()
            self.doc.process_all()
        elif kind == "drop":
            rt.disconnect()
        elif kind == "rejoin":
            # Ops made while offline were parked; they regenerate against
            # everything sequenced since (KernelMergeTree: K5) on the join.
            self.epoch[i] += 1
            rt.connect(self.doc, f"C{i}.r{self.epoch[i]}")
            self.doc.process_all()
        elif kind == "rehydrate":
            # Offline stash: the pending state re-enters a fresh container
            # through ``apply_stashed`` and is resubmitted on its join.
            stash = rt.get_pending_local_state()
            rt.close()
            self.epoch[i] += 1
            self.clients[i] = self.container(f"C{i}.s{self.epoch[i]}", self.kinds[i], stash=stash)
            self.doc.process_all()
        else:
            raise ValueError(kind)


def client_views(fleet: Fleet, i: int) -> dict:
    s = fleet.s(i)
    out = {
        "text": s.text,
        "positions": s.position_text(),
        "annotations": json.dumps(s.annotations(), sort_keys=True),
        "markers": json.dumps(s.markers(), sort_keys=True),
        "intervals": sorted(json.dumps(iv.to_json(), sort_keys=True)
                            for iv in s.get_interval_collection("f")),
        "map": json.dumps(fleet.m(i).items(), sort_keys=True),
    }
    if hasattr(s.backend, "check_errors"):
        out["error"] = s.backend.check_errors()
    return out


def assert_fleets_equal(ref: Fleet, port: Fleet, tag: str, converged: bool = True) -> None:
    assert ref.live() == port.live(), tag
    views = {}
    for i in range(len(ref.clients)):
        vr, vp = client_views(ref, i), client_views(port, i)
        assert vr == vp, f"{tag}: client {i} diverged"
        views[i] = vr
        if ref.kinds[i] == "k":
            assert vr["error"] == 0, f"{tag}: client {i} latched {vr['error']}"
            assert_raw_equal(ref.s(i).backend.state, port.s(i).backend.state, f"{tag} client {i}")
    if converged:
        live = ref.live()
        for i in live[1:]:
            for k in ("text", "positions", "annotations", "markers", "intervals", "map"):
                assert views[i][k] == views[live[0]][k], f"{tag}: {k} of client {i} not converged"


def assert_final_equal(ref: Fleet, port: Fleet) -> None:
    assert message_stream(ref.doc) == message_stream(port.doc)
    for i in range(len(ref.clients)):
        a = json.dumps(ref.clients[i].summarize(), sort_keys=True)
        b = json.dumps(port.clients[i].summarize(), sort_keys=True)
        assert a == b, f"client {i} summary diverged"


# ------------------------------------------------------------------ edits

def gen_edit(rng: random.Random, fleet: Fleet, i: int, serial: int) -> tuple:
    s = fleet.s(i)
    n = len(s.position_text())
    kind = rng.choices(
        ["ins", "rem", "ann", "ob", "obs", "marker", "ann_marker", "iv", "ivs",
         "iv_change", "set", "del"],
        [10, 4, 3, 1, 1, 1, 1, 2, 1, 1, 2, 1],
    )[0]
    if kind == "set":
        return ("set", f"k{rng.randrange(4)}", rng.choice([1, "v", [1, 2], {"a": serial}]))
    if kind == "del":
        return ("del", f"k{rng.randrange(4)}")
    if kind == "marker":
        return ("marker", rng.randint(0, n), f"m{serial}")
    if kind == "ins" or n == 0:
        return ("ins", rng.randint(0, n), rng.choice("abcxyz") * rng.randint(1, 6))
    p1 = rng.randrange(n)
    p2 = rng.randint(p1 + 1, min(n, p1 + 4))
    if kind == "rem":
        return ("rem", p1, p2)
    if kind == "ob":
        return ("ob", p1, p2)
    if kind == "ann":
        # Four property keys in all (the kernel's prop slots): bold, color
        # and the two marker keys.
        return ("ann", p1, p2, rng.choice(["bold", "color"]),
                rng.choice([True, "red", 3, [1, 2], {"k": serial % 3}]))
    if kind == "ann_marker":
        ms = s.markers()
        if not ms:
            return ("noop",)
        return ("ann_marker", rng.choice(ms)["props"]["markerId"], {"color": serial % 4})
    if kind == "obs":
        c2 = rng.randint(p1, n - 1)
        s1, s2 = rng.random() < 0.5, rng.random() < 0.5
        if p1 == c2 and not s1 and s2:
            s1 = True
        return ("obs", (p1, s1), (c2, s2))
    if kind == "iv":
        return ("iv", p1, rng.randint(p1, n - 1))
    if kind == "ivs":
        c2 = rng.randint(p1, n - 1)
        s1, s2 = rng.randrange(2), rng.randrange(2)
        if p1 == c2 and s1 > s2:
            s1, s2 = s2, s1
        return ("ivs", (p1, s1), (c2, s2))
    ids = sorted(iv.interval_id for iv in s.get_interval_collection("f"))
    if not ids:
        return ("noop",)
    return ("iv_change", rng.choice(ids), p1, rng.randint(p1, n - 1))


def apply_edit(fleet: Fleet, i: int, op: tuple) -> None:
    s, m = fleet.s(i), fleet.m(i)
    kind, *a = op
    coll = s.get_interval_collection("f")
    if kind == "ins":
        s.insert_text(*a)
    elif kind == "rem":
        s.remove_range(*a)
    elif kind == "ob":
        s.obliterate_range(*a)
    elif kind == "obs":
        s.obliterate_range_sided(*a)
    elif kind == "ann":
        s.annotate_range(*a)
    elif kind == "marker":
        s.insert_marker(a[0], props={"markerId": a[1], "referenceTileLabels": ["pg"]})
    elif kind == "ann_marker":
        s.annotate_marker(*a)
    elif kind in ("iv", "ivs"):
        coll.add(*a)
    elif kind == "iv_change":
        coll.change(a[0], a[1], a[2])
    elif kind == "set":
        m.set(*a)
    elif kind == "del":
        m.delete(*a)


def run_lockstep(seed: int, kinds: str, steps: int, weights: dict, track: bool = False):
    """``weights``: edit, flush, sync, reconnect, stash.  A reconnect or a
    stash drops one client, makes one to three edits on it offline, then
    rejoins it (or rehydrates its stash into a fresh container)."""
    rng = random.Random(seed)
    fleets = ref, port = Fleet(REF, kinds, track), Fleet(PORT, kinds, track)
    names = list(weights)

    def both(action):
        for f in fleets:
            f.act(action)

    for step in range(steps):
        kind = rng.choices(names, [weights[k] for k in names])[0]
        i = rng.randrange(len(kinds))
        if kind in ("reconnect", "stash"):
            both(("drop", i))
            for _ in range(rng.randint(1, 3)):
                both(("edit", i, gen_edit(rng, ref, i, step)))
            both(("rejoin" if kind == "reconnect" else "rehydrate", i))
        elif kind == "edit":
            both(("edit", i, gen_edit(rng, ref, i, step)))
        else:
            both((kind, i))
        if kind == "sync":
            assert_fleets_equal(ref, port, f"seed {seed} step {step}")
    for fleet in fleets:
        fleet.act(("sync", 0))
    assert_fleets_equal(ref, port, f"seed {seed} end")
    assert_final_equal(ref, port)
    return ref, port


WEIGHTS = {"edit": 12.0, "flush": 4.0, "sync": 2.0, "reconnect": 1.5, "stash": 1.0}


@pytest.mark.parametrize("seed", range(6))
def test_mixed_fleet_matches_reference(seed):
    """Two kernel and two oracle containers a package; reconnects with
    pending ops and stashes included."""
    ref, port = run_lockstep(seed, "koko", steps=60, weights=WEIGHTS)
    assert any(e > 0 for e in ref.epoch)


def test_kernel_fleet_with_attribution_matches_reference():
    """Three kernel containers with ``track_attribution=True``: the
    attributor tables, the attribution runs and every summary agree."""
    ref, port = run_lockstep(7, "kkk", steps=50, weights=WEIGHTS, track=True)
    for i in range(3):
        a, b = ref.s(i), port.s(i)
        n = len(a.position_text())
        assert a.attribution_range() == b.attribution_range()
        assert [a.attribution_at(p) for p in range(n)] == [b.attribution_at(p) for p in range(n)]
        ra, rb = ref.clients[i].attributor, port.clients[i].attributor
        assert json.dumps(ra.summarize(), sort_keys=True) == json.dumps(rb.summarize(), sort_keys=True)


# ------------------------------------------------------------- directed cases

def _both(kinds: str):
    return Fleet(REF, kinds), Fleet(PORT, kinds)


def _each(fleets, fn):
    for f in fleets:
        fn(f)


@pytest.mark.parametrize("in_flight", [False, True], ids=["offline", "in-flight"])
def test_kernel_reconnect_regenerates_pending(in_flight):
    """Pending insert, remove, annotate, marker and obliterate made offline
    on a kernel replica regenerate on the rejoin against a concurrent
    remote edit; with ``in-flight`` a first batch was already flushed
    before the drop (it acks through catch-up, the offline one regenerates)."""
    fleets = _both("ko")

    def script(f):
        f.s(0).insert_text(0, "hello world")
        f.act(("sync", 0))
        if in_flight:
            f.s(0).insert_text(2, "IN")
            f.clients[0].flush()
        f.act(("drop", 0))
        f.s(0).insert_text(5, "XY")
        f.s(0).remove_range(0, 2)
        f.s(0).annotate_range(3, 8, "w", 7)
        f.s(0).insert_marker(1, props={"markerId": "mk"})
        f.s(0).obliterate_range_sided((6, False), (9, True))
        f.s(0).obliterate_range(8, 10)
        f.s(1).insert_text(0, "zz")
        f.s(1).remove_range(6, 8)
        f.clients[1].flush()
        f.doc.process_all()
        f.act(("rejoin", 0))
        f.act(("sync", 0))

    _each(fleets, script)
    assert_fleets_equal(*fleets, "after reconnect")
    assert_final_equal(*fleets)


def test_kernel_stash_rehydrates_through_apply_stashed():
    """An offline stash of a kernel container rehydrates into a fresh
    kernel container (``apply_stashed``), regenerates and converges."""
    fleets = _both("ko")

    def script(f):
        f.s(0).insert_text(0, "abcdef")
        f.m(0).set("a", 1)
        f.act(("sync", 0))
        f.act(("drop", 0))
        f.s(0).insert_text(3, "QQ")
        f.s(0).remove_range(0, 1)
        f.s(0).obliterate_range(4, 6)
        f.s(0).get_interval_collection("f").add(1, 3)
        f.m(0).delete("a")
        f.s(1).insert_text(0, "pp")
        f.clients[1].flush()
        f.doc.process_all()
        f.act(("rehydrate", 0))
        f.act(("sync", 0))

    _each(fleets, script)
    assert_fleets_equal(*fleets, "after stash")
    assert_final_equal(*fleets)


@pytest.mark.parametrize("source", ["k", "o"])
def test_channel_summary_loads_into_both_backends(source):
    """A channel summary (kernel or oracle replica) loads into a fresh
    kernel and a fresh oracle channel in both packages: equal views, and
    equal summaries out."""
    fleets = _both(source + "o")

    def script(f):
        f.s(0).insert_text(0, "summary me please")
        f.s(0).annotate_range(0, 4, "bold", True)
        f.s(0).insert_marker(3, props={"markerId": "x", "referenceTileLabels": ["pg"]})
        f.s(0).get_interval_collection("f").add(2, 6)
        f.act(("sync", 0))
        f.s(1).obliterate_range(5, 8)
        f.act(("sync", 0))

    _each(fleets, script)
    out = []
    for f in fleets:
        summary = json.loads(json.dumps(f.s(0).summarize()))
        loaded = []
        for backend in (f.pkg.make_kernel(), f.pkg.Oracle()):
            ch = f.pkg.channels.SharedStringChannel("s2", backend=backend)
            ch.load(summary)
            loaded.append((ch.text, json.dumps(ch.annotations(), sort_keys=True),
                           json.dumps(ch.markers(), sort_keys=True),
                           json.dumps(ch.summarize(), sort_keys=True)))
        assert loaded[0] == loaded[1]
        out.append((json.dumps(summary, sort_keys=True), loaded))
    assert out[0] == out[1]


def test_container_snapshot_loads_identically():
    """``ContainerRuntime.summarize`` of a kernel container, loaded by
    ``load_snapshot`` into fresh kernel containers of both packages."""
    ref, port = run_lockstep(3, "ko", steps=30, weights={"edit": 6.0, "sync": 1.0})
    out = []
    for f in (ref, port):
        snap = json.loads(json.dumps(f.clients[0].summarize()))
        ch = f.pkg.channels
        ch.set_string_backend_factory(f.pkg.make_kernel)
        try:
            rt = f.pkg.Runtime(ch.default_registry(), container_id="late")
            rt.load_snapshot(snap)
        finally:
            ch.set_string_backend_factory(None)
        s = rt.datastore("root").get_channel("s")
        assert s.text == f.s(0).text
        out.append(json.dumps(rt.summarize(), sort_keys=True))
    assert out[0] == out[1]


def test_shared_map_channel_matches_reference():
    """Map sets, deletes and clears with pending overlays, a reconnect and
    a stash: equal items and message streams."""
    fleets = _both("oo")

    def script(f):
        f.m(0).set("a", 1)
        f.m(1).set("a", 2)
        f.m(1).set("b", [1, 2])
        f.act(("sync", 0))
        f.m(0).clear()
        f.m(0).set("c", {"x": 1})
        assert f.m(0).items() == {"c": {"x": 1}}
        f.act(("drop", 1))
        f.m(1).delete("b")
        f.act(("rejoin", 1))
        f.act(("drop", 1))
        f.m(1).set("d", 4)
        f.act(("rehydrate", 1))
        f.act(("sync", 0))

    _each(fleets, script)
    assert_fleets_equal(*fleets, "map")
    assert_final_equal(*fleets)
    assert fleets[1].m(0).items() == {"c": {"x": 1}, "d": 4}


# ------------------------------------------------------------- the registry

def _edit(kind: str, chs: list):
    """A short two-client edit of channel type ``kind`` (``chs``: the
    channel in each of the two containers); the caller syncs the
    containers at each ``yield`` and at the end."""
    a, b = chs
    if kind == "sharedString":
        a.insert_text(0, "hello")
        b.insert_text(0, "ab")
    elif kind == "sharedMap":
        a.set("k", 1)
        b.set("k", [2])
    elif kind == "sharedTree":
        imp = lambda m: importlib.import_module(f"{a.__module__.split('.')[0]}.{m}")
        cs, schema = imp("dds.tree.changeset"), imp("dds.tree.schema")
        a.submit_change(cs.make_insert([], "", 0, [schema.leaf(1)]))
        b.submit_change(cs.make_insert([], "", 0, [schema.leaf("x")]))
    elif kind == "sharedMatrix":
        a.insert_rows(0, 2)
        a.insert_cols(0, 2)
        a.set_cell(1, 1, "v")
    elif kind == "sharedDirectory":
        a.create_subdirectory("sub")
        a.set("sub", "k", 1)
        b.set("", "top", {"x": 2})
    elif kind == "ink":
        sid = a.create_stroke({"color": "red"})
        a.append_point(sid, 1.0, 2.0, 0.5, 0.25)
    elif kind == "sharedSummaryBlock":
        a.set("k", "only-in-summaries")
    elif kind == "sharedCell":
        a.set(1)
        b.set({"v": 2})
    elif kind == "sharedCounter":
        a.increment(3)
        b.increment(-1)
    elif kind == "consensusQueue":
        a.add("job1")
        a.add("job2")
        b.acquire()
    elif kind == "consensusRegisterCollection":
        a.write("r", 1)
        b.write("r", 2)
    elif kind == "taskManager":
        a.volunteer("t")
        b.volunteer("t")
    elif kind == "pactMap":
        a.set("p", "v")
    elif kind == "sharedJsonOT":
        a.replace([], {"items": []})
        yield
        a.insert(["items", 0], "x")
        b.insert(["title"], "t")
    elif kind == "sharedJson1":
        a.replace([], None, {})
        yield
        a.insert(["k"], 1)
        b.insert(["j"], [1, 2])
    elif kind == "propertyTree":
        a.insert_property(["p"], "Int32", 5)
        b.insert_property(["q"], "String", "s")
    else:
        raise KeyError(kind)


def _registry_round_trip(root: str, kind: str) -> dict:
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    registry = imp("dds.channels").default_registry
    doc = imp("server.local_service").LocalService().document("reg")
    rts = []
    for name in ("A", "B"):
        rt = imp("runtime").ContainerRuntime(registry(), container_id=name)
        rt.create_datastore("root").create_channel(kind, "ch")
        rt.connect(doc, name)
        rts.append(rt)
    doc.process_all()
    chs = [rt.datastore("root").get_channel("ch") for rt in rts]
    for _phase in (*_edit(kind, chs), None):
        for _ in range(2):  # the sequenced edits, then what they set off
            for rt in rts:
                rt.flush()
            doc.process_all()
    summaries = [ch.summarize() for ch in chs]
    fresh = registry()[kind].create("ch")
    fresh.load(json.loads(json.dumps(summaries[0])))
    return {"type": fresh.channel_type, "summaries": summaries,
            "reloaded": fresh.summarize(),
            "runtimes": [rt.summarize() for rt in rts],
            "stream": [m.to_json() for m in doc.sequencer.log]}


REF_TYPES = sorted(ref_channels.default_registry())


def test_registry_keys_equal_the_references():
    """``default_registry()`` holds the reference's 16 channel types."""
    assert sorted(port_channels.default_registry()) == REF_TYPES and len(REF_TYPES) == 16


@pytest.mark.parametrize("kind", REF_TYPES)
def test_registry_type_round_trips_like_the_reference(kind, monkeypatch):
    """Each reference channel type, built in both packages and edited by
    two clients, then summarized and loaded into a fresh channel: equal
    sequenced streams, channel and container summaries, and the reloaded
    channel re-summarizes to what it loaded."""
    pkgs = twins.packages()
    got = {}
    for key, root in (("ref", "fluidframework_tpu"), ("port", "fluidframework_tpu_torch")):
        with monkeypatch.context() as mp:
            twins.install(pkgs[key], mp)
            got[key] = twins._canon(_registry_round_trip(root, kind))
    assert got["port"] == got["ref"]
    out = json.loads(got["port"])
    assert out["type"] == kind
    assert out["reloaded"] == out["summaries"][0]


def test_registry_unknown_type_raises_key_error():
    """A type neither registry has raises ``KeyError``, as the reference's
    does; nothing falls through to another type."""
    for channels, runtime in ((ref_channels, RefRuntime), (port_channels, PortRuntime)):
        reg = channels.default_registry()
        with pytest.raises(KeyError):
            reg["noSuchType"]
        assert reg.get("noSuchType") is None
        rt = runtime(reg, container_id="c")
        with pytest.raises(KeyError):
            rt.create_datastore("root").create_channel("noSuchType", "x")
