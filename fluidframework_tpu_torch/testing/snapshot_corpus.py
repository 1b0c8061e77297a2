"""The port's own copy of ``fluidframework_tpu/testing/snapshot_corpus.py`` (no JAX in it).

Golden snapshot corpus: scripted documents + their pinned summaries.

Reference parity: packages/test/snapshots — a committed corpus of real
snapshot files regenerated only deliberately, so any change to a DDS's
summary layout shows up as a reviewed diff, and every supported read
format keeps loading forever.

``build_documents()`` scripts one deterministic document per DDS family;
``python -m fluidframework_tpu_torch.testing.snapshot_corpus DIR`` writes
the corpus into ``DIR`` (``regenerate(directory)``: it has no default, so
nothing overwrites the committed ``tests/snapshots/*.json``, which
``SNAPSHOT_DIR`` names for reading). The test suite asserts both directions:
1. every committed file LOADS and reproduces the recorded user state
   (backward compatibility for every committed format version), and
2. re-running the scripts yields summaries byte-identical to the current-
   format files (no accidental format drift).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from ..dds.channels import default_registry
from ..dds.sequence_intervals import Side
from ..runtime import ContainerRuntime
from ..runtime.snapshot_formats import current_format
from ..server.local_service import LocalService

SNAPSHOT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "snapshots",
)


def _host(channel_type: str, name: str):
    svc = LocalService()
    doc = svc.document("corpus")
    c = ContainerRuntime(default_registry(), container_id="writer")
    ds = c.create_datastore("root")
    ch = ds.create_channel(channel_type, name)
    c.connect(doc, "writer")
    doc.process_all()
    return svc, doc, c, ch


def _settle(doc, c):
    c.flush()
    doc.process_all()


# --------------------------------------------------------------- the scripts

def _string():
    svc, doc, c, ch = _host("sharedString", "text")
    ch.insert_text(0, "hello world")
    ch.annotate_range(0, 5, "style", {"bold": True})
    coll = ch.get_interval_collection("marks")
    coll.add(0, 4, {"kind": "word"})
    coll.add((5, Side.AFTER), "end", {"kind": "sticky"})
    ch.remove_range(5, 6)
    ch.obliterate_range(0, 2)
    _settle(doc, c)
    return ch


def _map():
    svc, doc, c, ch = _host("sharedMap", "kv")
    ch.set("alpha", 1)
    ch.set("beta", {"nested": [1, 2, 3]})
    ch.set("gamma", "to-delete")
    ch.delete("gamma")
    _settle(doc, c)
    return ch


def _matrix():
    svc, doc, c, ch = _host("sharedMatrix", "grid")
    ch.insert_rows(0, 3)
    ch.insert_cols(0, 2)
    ch.set_cell(0, 0, "a")
    ch.set_cell(2, 1, 42)
    ch.remove_rows(1, 1)
    _settle(doc, c)
    return ch


def _tree():
    from ..dds.tree.changeset import make_insert, make_set_value
    from ..dds.tree.schema import leaf
    from ..utils.id_compressor import IdCompressor

    svc, doc, c, ch = _host("sharedTree", "tree")
    # Pin the compressor session so revision UUIDs (and thus the summary
    # bytes) are reproducible across regenerations.
    ch.idc = IdCompressor(session_id="00000000-0000-4000-8000-00000000c0de")
    for i, v in enumerate([10, 20, 30]):
        ch.submit_change(make_insert([], "", i, [leaf(v)]))
    ch.submit_change(make_set_value([("", 1)], 99))
    with ch.transaction():
        ch.submit_change(make_insert([], "", 3, [leaf(40)]))
    _settle(doc, c)
    return ch


def _cell():
    svc, doc, c, ch = _host("sharedCell", "cell")
    ch.set({"payload": True})
    _settle(doc, c)
    return ch


def _counter():
    svc, doc, c, ch = _host("sharedCounter", "n")
    ch.increment(5)
    ch.increment(-2)
    _settle(doc, c)
    return ch


def _directory():
    svc, doc, c, ch = _host("sharedDirectory", "dir")
    ch.set("", "topKey", 1)
    ch.create_subdirectory("sub")
    ch.set("sub", "inner", "x")
    _settle(doc, c)
    return ch


def _json_ot():
    svc, doc, c, ch = _host("sharedJsonOT", "jdoc")
    ch.replace([], {"items": [1, 2, 3], "meta": {"title": "pinned"}})
    ch.insert(["items", 1], 99)
    ch.remove(["items", 3])
    ch.replace(["meta", "title"], "golden")
    _settle(doc, c)
    return ch


SCRIPTS: dict[str, Callable[[], Any]] = {
    "sharedString": _string,
    "sharedMap": _map,
    "sharedMatrix": _matrix,
    "sharedTree": _tree,
    "sharedCell": _cell,
    "sharedCounter": _counter,
    "sharedDirectory": _directory,
    "sharedJsonOT": _json_ot,
}


# State extractors run on BOTH the scripted channel and a channel freshly
# loaded from a committed summary — the equality the corpus pins.

def extract_state(name: str, ch) -> dict:
    if name == "sharedString":
        return {
            "text": ch.text,
            "annotations": ch.annotations(),
            "intervals": sorted(
                (iv.to_json() for iv in ch.get_interval_collection("marks")),
                key=lambda d: d["id"],
            ),
        }
    if name == "sharedMap":
        return {"entries": {k: ch.get(k) for k in sorted(ch.keys())}}
    if name == "sharedMatrix":
        return {
            "rows": ch.row_count,
            "cols": ch.col_count,
            "cells": [
                [ch.get_cell(r, col) for col in range(ch.col_count)]
                for r in range(ch.row_count)
            ],
        }
    if name == "sharedTree":
        return {"forest": ch.forest.to_json()}
    if name == "sharedCell":
        return {"value": ch.get()}
    if name == "sharedCounter":
        return {"value": ch.value}
    if name == "sharedDirectory":
        return {
            "top": {k: ch.get("", k) for k in sorted(ch.keys(""))},
            "sub": {k: ch.get("sub", k) for k in sorted(ch.keys("sub"))},
        }
    if name == "sharedJsonOT":
        return {"doc": ch.get()}
    raise KeyError(name)


def build_entry(name: str) -> dict:
    ch = SCRIPTS[name]()
    return {
        "type": name,
        "format": current_format(name),
        "summary": ch.summarize(),
        "state": extract_state(name, ch),
    }


def canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, indent=1)


def regenerate(directory: str) -> list[str]:
    """Write every ``SCRIPTS`` entry's current-format file into
    ``directory``; the paths written."""
    os.makedirs(directory, exist_ok=True)
    written = []
    for name in SCRIPTS:
        entry = build_entry(name)
        path = os.path.join(directory, f"{name}.v{entry['format']}.json")
        with open(path, "w") as f:
            f.write(canonical(entry) + "\n")
        written.append(path)
    return written


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 2:
        sys.exit("usage: python -m fluidframework_tpu_torch.testing.snapshot_corpus DIR")
    for path in regenerate(sys.argv[1]):
        print(path)
