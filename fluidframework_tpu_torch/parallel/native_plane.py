"""Native dispatch plane: the second backend behind ``models/dispatch``.

Counterpart of ``fluidframework_tpu/parallel/native_plane.py``.  It has
the duck-typed plane surface of ``parallel.mesh`` (the default torch
plane) but routes the two fleet hot-path programs — the merge-tree
megastep (K2) and the set_min_seq + zamboni compact (K3) — through the
host C++ row loops of ``native/megastep.cpp`` instead of the torch
programs on the engine's device.  It is host code, not a kernel: a fleet
whose state lives on the card copies its columns out, steps them on the
host and copies them back in, every dispatch (``chip_smoke.py``'s
``native_plane`` phase times the three parts against K2).

Design points:

* **Mesh machinery is delegated**: ``doc_mesh`` / ``docs_segs_mesh`` /
  ``shard_fleet_state`` / ``shard_docs`` come straight from
  ``parallel.mesh``, so the engine's state stays where the engine put it
  (``device="cuda"`` keeps it on the card; the watchdog digest K4, the
  cohort programs and the restore scatter run there on the torch plane).
* **State stays torch-typed at the seam**: each native dispatch copies the
  int32 columns to writable host numpy, mutates them in place in C++, and
  returns int32 tensors on the state's own device, so checkpoints and
  scribe folds are plane-invariant by construction.
* **Byte identity is the contract**, held against the reference's lax
  programs and the port's torch programs by
  tests/test_torch_dispatch_backends.py (full arrays, padding remnants
  included, plus the per-doc error latch).
* **Seg lanes raise loudly**: the native plane has no segment-parallel
  programs; ``mesh_seg_program`` / ``seg_state_specs`` /
  ``shard_seg_state`` / ``upload_replicated`` raise NotImplementedError
  and ``DocBatchEngine`` maps that to its counted downgrade
  (``seg_plane_unsupported``).
* **The library never builds under a lock**: ``megastep_native.warm()``
  runs only from ``mesh_fleet_program`` (engine construction), and a
  library that does not build raises there — no fallback to the torch
  programs.

Importing this module registers it as THE dispatch plane (last wins, see
``models.dispatch.register_dispatch_plane``); select it per process with
``FFTPU_TORCH_DISPATCH_PLANE=fluidframework_tpu_torch.parallel.native_plane``.
Callers flipping planes inside one process (tests) must re-register the
plane they want afterwards.
"""

from __future__ import annotations

import sys as _sys

import torch

from ..models.dispatch import register_dispatch_plane as _register
from ..native import megastep_native
from ..ops import mergetree_kernel as mk
from . import mesh as _mesh

# ----------------------------------------------------- delegated surface
SEG_AXIS = _mesh.SEG_AXIS
doc_mesh = _mesh.doc_mesh
docs_segs_mesh = _mesh.docs_segs_mesh
fleet_doc_axes = _mesh.fleet_doc_axes
shard_docs = _mesh.shard_docs
shard_fleet_state = _mesh.shard_fleet_state


def available() -> bool:
    """True iff the native megastep library is built (building it if g++
    is present — call at startup, not under a serving lock)."""
    return megastep_native.warm()


# ------------------------------------------------------- fleet programs

def _native_megastep(state, ops, payloads, kinds=None):
    """The megastep's native twin; ``kinds`` (the torch program's host
    hint) is accepted and not needed."""
    return megastep_native.megastep(state, ops, payloads)


def _native_compact(state, min_seqs):
    return megastep_native.fleet_compact(state, min_seqs)


def _require_library() -> None:
    if not megastep_native.warm():
        raise RuntimeError(
            "native dispatch plane: libtpumegastep is unavailable (g++ build "
            "failed?); unset FFTPU_TORCH_DISPATCH_PLANE to serve on the torch plane"
        )


def mesh_fleet_program(step_fn, mesh):
    """The plane's program factory.  The two fleet hot-path bodies map to
    their native twins; anything else delegates to the torch plane.

    ``warm()`` runs HERE, at program-build time (engine construction,
    outside any serving lock): the returned callables only ever touch the
    prebuilt library."""
    if step_fn is mk.apply_megastep:
        _require_library()
        return _native_megastep
    if getattr(step_fn, "__name__", "") == "_fleet_compact_body":
        _require_library()
        return _native_compact
    return _mesh.mesh_fleet_program(step_fn, mesh)


def error_count(error) -> int:
    """Docs with a latched error bit, counted on the host (the torch plane
    counts on the device and reads one scalar)."""
    return int(torch.count_nonzero(error.detach().cpu()))


# ------------------------------------------------- seg lanes: loud N/A

_SEG_MSG = (
    "native dispatch plane: segment-parallel lanes are not implemented "
    "(docs-sharded serving only); DocBatchEngine serves every doc on the "
    "fleet path and counts seg_plane_unsupported"
)


def seg_state_specs(*args, **kwargs):
    raise NotImplementedError(_SEG_MSG)


def shard_seg_state(*args, **kwargs):
    raise NotImplementedError(_SEG_MSG)


def mesh_seg_program(*args, **kwargs):
    raise NotImplementedError(_SEG_MSG)


def upload_replicated(*args, **kwargs):
    raise NotImplementedError(_SEG_MSG)


# Self-register (last wins): importing this module selects the native
# plane for engines constructed afterwards.
_register(_sys.modules[__name__])
