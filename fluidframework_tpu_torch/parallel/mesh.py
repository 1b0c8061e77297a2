"""The one-device dispatch plane.

Counterpart of ``fluidframework_tpu/parallel/mesh.py`` with the same
duck-typed surface (``models/dispatch.py``), for one card: the doc axis is
not split, so "sharding" a fleet state is placing it on the device, and a
fleet program is the step function called on the device's current stream.
A segment lane runs over a one-shard group (``docs_segs_mesh`` with more
than one shard raises ``NotImplementedError``: multi-shard lanes need
``torch.distributed`` collectives).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.mergetree_kernel import SEG_AXIS, DocState, shard_group, tree_map


@dataclass(frozen=True)
class DeviceMesh:
    """One device; ``shape`` names its axes as the reference mesh does."""

    device: torch.device
    shape: dict = field(default_factory=lambda: {"docs": 1}, hash=False)

    @property
    def seg_shards(self) -> int:
        return int(self.shape.get(SEG_AXIS, 1))


def doc_mesh(device=DEFAULT_DEVICE) -> DeviceMesh:
    """The doc-axis plane over one device."""
    return DeviceMesh(resolve_device(device))


def docs_segs_mesh(device=DEFAULT_DEVICE, seg_shards: int = 1) -> DeviceMesh:
    """The docs x segs plane; this slice supports one segment shard."""
    shard_group(seg_shards)  # raises for more than one shard
    return DeviceMesh(resolve_device(device), {"docs": 1, SEG_AXIS: 1})


def _place(state: DocState, mesh: DeviceMesh) -> DocState:
    return tree_map(
        lambda x: x.to(device=mesh.device, dtype=torch.int32).contiguous(), state
    )


def shard_fleet_state(state: DocState, mesh: DeviceMesh) -> DocState:
    """Place a [D, ...] fleet state on the device."""
    return _place(state, mesh)


def shard_docs(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Place an array with a leading doc dimension."""
    return x.to(mesh.device)


def seg_state_specs(state: DocState) -> DocState:
    """Which leaves of a seg-sharded one-document state split over the
    segment axis ("segs") and which replicate ("rep") — the reference's
    partition specs, kept as the placement contract for a later
    multi-shard plane."""
    s, r = SEG_AXIS, "rep"
    return DocState(
        text=r, text_end=r, nseg=s,
        seg_start=s, seg_len=s, ins_key=s, ins_client=s,
        seg_uid=s, seg_obpre=s,
        rem_keys=(s,) * len(state.rem_keys),
        rem_clients=(s,) * len(state.rem_clients),
        prop_keys=(s,) * len(state.prop_keys),
        prop_vals=(s,) * len(state.prop_vals),
        uid_next=r, ob_key=r, ob_client=r, ob_start_uid=r, ob_end_uid=r,
        ob_start_side=r, ob_end_side=r, ob_ref_seq=r,
        min_seq=r, error=r,
    )


def shard_seg_state(state: DocState, mesh: DeviceMesh) -> DocState:
    """Place a seg-sharded one-document state (one shard: the whole
    layout) on the device."""
    return _place(state, mesh)


def mesh_fleet_program(step_fn, mesh: DeviceMesh):
    """The fleet program for one device: ``step_fn`` itself, called with a
    state and arguments that already live on the device (the staging ring
    uploads them), launching on the current stream."""
    return step_fn


def mesh_seg_program(step_fn, mesh: DeviceMesh, state_specs=None):
    """A segment-lane program: ``step_fn(state, *args, group=...)`` over
    the plane's segment group (one shard)."""
    group = shard_group(mesh.seg_shards)

    def program(state, *args, **kw):
        return step_fn(state, *args, group=group, **kw)

    return program


def error_count(error: torch.Tensor) -> int:
    """Docs with a latched error bit (one scalar read from the device)."""
    return int(torch.count_nonzero(error))


# Dispatch-seam registration: this module IS the default plane.
from ..models.dispatch import register_dispatch_plane as _register  # noqa: E402

_register(sys.modules[__name__])
