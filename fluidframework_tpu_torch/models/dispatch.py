"""Engine-owned dispatch seam: the models -> parallel inversion.

Counterpart of ``fluidframework_tpu/models/dispatch.py``.  The engine
depends on an abstract **dispatch plane** — the object that owns device
placement and the fleet/segment program factories — and the concrete
plane registers itself here when its module loads.

Resolution order:

1. whatever called :func:`register_dispatch_plane` last (importing a
   plane's module registers it);
2. otherwise the provider named by ``FFTPU_TORCH_DISPATCH_PLANE`` (a
   dotted module path of the port, e.g.
   ``fluidframework_tpu_torch.parallel.native_plane``) is imported and
   must register itself;
3. the default provider, ``fluidframework_tpu_torch.parallel.mesh`` (a
   mesh of shards on one device).

The port reads its own variable: the reference's ``FFTPU_DISPATCH_PLANE``
names a module of the JAX package, which the port never imports.

The plane's surface is duck-typed; the engine uses ``doc_mesh`` /
``docs_segs_mesh``, ``shard_fleet_state``, ``shard_docs``,
``mesh_fleet_program`` / ``mesh_seg_program``, ``seg_state_specs`` /
``shard_seg_state``, ``error_count`` and ``SEG_AXIS``.
"""

from __future__ import annotations

import importlib
import os

_PLANE = None

DEFAULT_PROVIDER = "fluidframework_tpu_torch.parallel.mesh"
PROVIDER_ENV = "FFTPU_TORCH_DISPATCH_PLANE"


def register_dispatch_plane(plane):
    """Install the concrete dispatch plane (last registration wins)."""
    global _PLANE
    _PLANE = plane
    return plane


def dispatch_plane():
    """The active dispatch plane, loading the configured provider on first
    use (see the module docstring)."""
    if _PLANE is None:
        provider = os.environ.get(PROVIDER_ENV) or DEFAULT_PROVIDER
        importlib.import_module(provider)
        if _PLANE is None:
            raise RuntimeError(
                f"dispatch provider {provider!r} did not register a plane "
                "(it must call models.dispatch.register_dispatch_plane)"
            )
    return _PLANE
