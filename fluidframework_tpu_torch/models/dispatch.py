"""Engine-owned dispatch seam: the models -> parallel inversion.

Counterpart of ``fluidframework_tpu/models/dispatch.py``.  The engine
depends on an abstract **dispatch plane** — the object that owns device
placement and the fleet/segment program factories — and the concrete
plane registers itself here when its module loads.

The active plane is whatever called :func:`register_dispatch_plane`
last; when nothing has registered, the default provider,
``fluidframework_tpu_torch.parallel.mesh`` (a mesh of shards on one device), is
imported and registers itself.

The plane's surface is duck-typed; the engine uses ``doc_mesh`` /
``docs_segs_mesh``, ``shard_fleet_state``, ``shard_docs``,
``mesh_fleet_program`` / ``mesh_seg_program``, ``seg_state_specs`` /
``shard_seg_state``, ``error_count`` and ``SEG_AXIS``.
"""

from __future__ import annotations

import importlib

_PLANE = None

DEFAULT_PROVIDER = "fluidframework_tpu_torch.parallel.mesh"


def register_dispatch_plane(plane):
    """Install the concrete dispatch plane (last registration wins)."""
    global _PLANE
    _PLANE = plane
    return plane


def dispatch_plane():
    """The active dispatch plane, loading the default provider on first
    use."""
    if _PLANE is None:
        importlib.import_module(DEFAULT_PROVIDER)
        if _PLANE is None:
            raise RuntimeError(
                f"dispatch provider {DEFAULT_PROVIDER!r} did not register a plane"
            )
    return _PLANE
