"""The port's own copy of ``fluidframework_tpu/runtime/gc.py`` (no JAX in it).

Garbage collection over the summary reference graph.

Reference parity: container-runtime/src/gc/ — the runtime periodically
marks every node (datastore, attachment blob) reachable from the roots via
serialized handles, ages unreferenced nodes, and eventually SWEEPS them.
Two phases, exactly the reference's split:

- **mark**: walk handle references out of the reachable datastores' channel
  summaries to a fixpoint; record the sequence number at which a node first
  became unreferenced (the reference records timestamps;
  sequence distance is the deterministic analog).
- **sweep**: nodes unreferenced for at least ``sweep_after_ops`` are
  deleted via a SEQUENCED gcDelete runtime op, so every replica removes
  them at the same point in the total order (the reference's sweep-ready
  GC op) and late ops to deleted routes are dropped as tombstoned.

Handles come in two wire shapes, both GC-visible: plain strings
(``fluid:<datastore id>`` for datastores, ``blob:<id>`` for attachment
blobs — blob_manager.py) and the aqueduct IFluidHandle dict
(``{"__fluid_handle__": "/<ds id>[/<channel id>]"}`` — framework/
aqueduct.py make_handle; segments are percent-encoded).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .handles import is_handle, parse_handle_url, HANDLE_KEY

DS_PREFIX = "fluid:"
BLOB_PREFIX = "blob:"


def scan_handles(value: Any, ds_refs: set[str], blob_refs: set[str]) -> None:
    """Deep-scan a JSON-ish summary value for handle references."""
    if isinstance(value, str):
        if value.startswith(DS_PREFIX):
            ds_refs.add(value[len(DS_PREFIX):])
        elif value.startswith(BLOB_PREFIX):
            blob_refs.add(value[len(BLOB_PREFIX):])
    elif isinstance(value, dict):
        if is_handle(value):
            parts = parse_handle_url(value[HANDLE_KEY])
            if parts:
                ds_refs.add(parts[0])
        for v in value.values():
            scan_handles(v, ds_refs, blob_refs)
    elif isinstance(value, (list, tuple)):
        for v in value:
            scan_handles(v, ds_refs, blob_refs)


@dataclass
class GCState:
    """Ages + tombstones; part of the runtime summary so a reloading
    summarizer continues aging where the last one left off."""

    unreferenced_since: dict[str, int] = field(default_factory=dict)
    tombstoned: set[str] = field(default_factory=set)

    def to_json(self) -> dict:
        return {
            "unreferencedSince": dict(sorted(self.unreferenced_since.items())),
            "tombstoned": sorted(self.tombstoned),
        }

    @staticmethod
    def from_json(data: dict) -> "GCState":
        return GCState(
            unreferenced_since=dict(data.get("unreferencedSince", {})),
            tombstoned=set(data.get("tombstoned", [])),
        )


@dataclass
class MarkResult:
    reachable_ds: set[str]
    referenced_blobs: set[str]
    unreferenced: dict[str, int]  # node key -> since seq


def mark(runtime) -> MarkResult:
    """The mark phase over the live runtime (roots -> handle fixpoint).
    Node keys: ``ds/<id>`` and ``blob/<id>``."""
    roots = {
        ds_id for ds_id, ds in runtime.datastores.items() if ds.is_root
    }
    reachable = set(roots)
    blob_refs: set[str] = set()
    frontier = list(roots)
    while frontier:
        ds_id = frontier.pop()
        ds = runtime.datastores.get(ds_id)
        if ds is None:
            continue
        ds_refs: set[str] = set()
        scan_handles(ds.summarize(), ds_refs, blob_refs)
        for ref in ds_refs:
            if ref not in reachable:
                reachable.add(ref)
                frontier.append(ref)
    unreferenced: dict[str, int] = {}
    seq = runtime.ref_seq
    prev = runtime.gc_state.unreferenced_since
    for ds_id in runtime.datastores:
        if ds_id not in reachable:
            key = f"ds/{ds_id}"
            unreferenced[key] = prev.get(key, seq)
    for blob_id in runtime.blobs.attached_ids:
        if blob_id not in blob_refs:
            key = f"blob/{blob_id}"
            unreferenced[key] = prev.get(key, seq)
    return MarkResult(reachable, blob_refs, unreferenced)
