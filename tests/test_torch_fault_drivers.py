"""The port's fault-injection, replay, file and virtual-storage drivers
against the JAX package's, exact.

- The reference's ``tests/test_stress_faults.py`` (randomized edit
  schedules with injected nacks, errors and disconnects over loader
  stacks, eight seeds) and ``tests/test_virtual_storage.py`` (snapshot
  shredding, the persistent cache, prefetch, ``run_with_retry`` and a
  container boot through virtualized storage) run in both packages through
  ``torch_twins``: each case's assertions hold in both, and their
  documents' sequenced logs and container summaries are equal.  The stress
  file's ``test_quarantine_checkpoint_schedule`` drives the batched
  engine, not a driver, through the reference's own engine helpers; the
  port's engine runs that schedule in ``tests/test_torch_quarantine.py``.
- A recorded history (string and map edits from three containers, one of
  them torn down by an injected disconnect and replayed) replays in both
  packages through ``ReplayDocumentServiceFactory`` (to the head and to a
  cap) and through the file driver (``save_document_file`` /
  ``load_document_file`` / ``FileDocumentServiceFactory``): the replayed
  containers' texts, maps and summaries at each cap, the loaded streams and
  the written files must be equal.

Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import pathlib
import tempfile

import pytest

import torch_twins as twins

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
QUARANTINE = "test_quarantine_checkpoint_schedule"


@contextlib.contextmanager
def tmp_dir(root: str):
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


CASES = (twins.cases("test_stress_faults.py", skip=(QUARANTINE,))
         + twins.cases("test_virtual_storage.py", fixtures={"tmp_path": {"tmp": tmp_dir}}))


def test_every_reference_case_is_twinned():
    assert len(CASES) == 8 + 4 + 14, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


# ------------------------------------------------------ replay and file drivers

def _record(root: str):
    """A history on doc "d": three containers edit a string and a map; one
    is torn down by an injected disconnect with edits pending, then
    reconnects and replays them."""
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    registry = imp("dds.channels").default_registry
    Container = imp("loader").Container
    svc = imp("server").LocalService()
    fi = imp("driver.fault_injection")
    factory = fi.FaultInjectionDocumentServiceFactory(imp("driver").LocalDocumentServiceFactory(svc))
    d = Container.create_detached(registry(), container_id="creator")
    ds = d.runtime.create_datastore("root")
    ds.create_channel("sharedString", "text")
    ds.create_channel("sharedMap", "meta")
    d.attach("d", factory, "creator")
    svc.process_all()
    others = [Container.load("d", factory, registry(), f"c{i}") for i in (1, 2)]
    svc.process_all()
    words = ["alpha ", "beta ", "gamma ", "delta ", "eps "]
    for i, word in enumerate(words):
        c = [d, *others][i % 3]
        c.runtime.datastore("root").get_channel("text").insert_text(0, word)
        c.runtime.datastore("root").get_channel("meta").set(f"k{i}", i)
        if i == 3:
            victim = c.delta_manager.connection_manager.connection
            assert victim in factory.live()
            victim.inject_disconnect()
            with contextlib.suppress(Exception):
                c.runtime.flush()
            c.reconnect()
        else:
            c.runtime.flush()
        svc.process_all()
    texts = [c.runtime.datastore("root").get_channel("text").text for c in (d, *others)]
    assert len(set(texts)) == 1
    return svc, imp


def _view(c) -> dict:
    root = c.runtime.datastore("root")
    meta = root.get_channel("meta")
    return {"text": root.get_channel("text").text,
            "meta": {k: meta.get(k) for k in sorted(meta.keys())},
            "summary": c.runtime.summarize()}


def _replays(root: str, directory: pathlib.Path) -> dict:
    svc, imp = _record(root)
    rd = imp("driver.replay_driver")
    Container = imp("loader").Container
    registry = imp("dds.channels").default_registry
    doc = svc.document("d")
    log = doc.sequencer.log
    out: dict = {"stream": [m.to_json() for m in log]}
    caps = [None, log[len(log) // 2].seq, log[-3].seq]
    for cap in caps:
        factory = rd.ReplayDocumentServiceFactory.from_local_service(svc, to_seq=cap)
        c = Container.load("d", factory, registry(), "viewer", mode="read")
        conn = c.delta_manager.connection_manager.connection
        n = conn.replay_to(None)
        out[f"replay_{cap}"] = {"delivered": n, **_view(c)}
        with pytest.raises(imp("driver.definitions").DriverError):
            conn.submit({"x": 1})
    path = str(directory / "doc.json")
    rd.save_document_file(path, log, doc.latest_snapshot())
    with open(path) as f:
        out["file"] = json.load(f)
    ops, snap = rd.load_document_file(path)
    out["loaded"] = [[m.client_id, m.client_seq, m.ref_seq, m.seq, m.min_seq, m.type,
                      m.contents, m.metadata, m.short_client] for m in ops]
    out["loaded_snapshot"] = snap
    c = Container.load("d", rd.FileDocumentServiceFactory(path), registry(), "viewer", mode="read")
    c.delta_manager.connection_manager.connection.replay_to(None)
    out["file_view"] = _view(c)
    return out


def test_replay_and_file_drivers_match_reference(monkeypatch, tmp_path):
    pkgs = twins.packages()
    results = {}
    for key, root in (("ref", REF), ("port", PORT)):
        with monkeypatch.context() as mp:
            twins.install(pkgs[key], mp)
            (tmp_path / key).mkdir()
            results[key] = _replays(root, tmp_path / key)
    got, want = results["port"], results["ref"]
    assert got["replay_None"]["text"] == "eps delta gamma beta alpha "
    assert got["file_view"]["text"] == got["replay_None"]["text"]
    assert got["replay_None"]["delivered"] > got[f"replay_{got['loaded'][-3][3]}"]["delivered"]
    assert got == want
