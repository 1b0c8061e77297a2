"""The dispatch plane: a mesh of shards on one device.

Counterpart of ``fluidframework_tpu/parallel/mesh.py`` with the same
duck-typed surface (``models/dispatch.py``).  A ``DeviceMesh`` holds one
device per shard and names its axes as the reference mesh does:
``doc_mesh(devices)`` is ``{"docs": n}``, ``docs_segs_mesh(devices,
seg_shards=s)`` is ``{"docs": n // s, "segs": s}``, and cold docs shard over
both axes flattened, so a fleet has ``len(devices)`` shards either way.

Every entry of a mesh names the same device (``["cuda:0"] * 4`` on the
card, ``["cpu"] * 4`` in the tests), the port's counterpart of the
reference's virtual devices:

- a fleet shard is a contiguous block of ``docs_per_shard`` rows of the
  engine's one state tensor (``models/placement.py``), and a fleet program
  is one launch over the whole doc axis;
- a segment lane's shards are the leading axis of one stacked state, its
  collectives reductions over that axis (``mergetree_kernel``'s
  ``StackedShardGroup``).

A mesh over distinct devices raises ``NotImplementedError`` (ROADMAP.md
queue 1 item 14: per-shard state on each card, NCCL collectives for the
segment lanes).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.flight_recorder import span
from ..ops.mergetree_kernel import (
    SEG_AXIS,
    DocState,
    StackedShardGroup,
    seg_stack,
    tree_map,
)

CROSS_CARD_ITEM = (
    "ROADMAP.md queue 1 item 14 (cross-card meshes: per-shard state on its "
    "own card, NCCL collectives for the segment lanes)"
)


@dataclass(frozen=True)
class DeviceMesh:
    """One device per shard; ``shape`` names the axes (their product is
    the shard count)."""

    devices: tuple
    shape: dict = field(hash=False)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def seg_shards(self) -> int:
        return int(self.shape.get(SEG_AXIS, 1))


def _same_device(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card: compare by index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_devices(devices) -> tuple:
    """The shards' devices: one device (a name or ``torch.device``) is a
    one-shard mesh, a sequence one shard per entry.  Every entry must name
    the same device."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = tuple(_same_device(resolve_device(d)) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if any(d != devs[0] for d in devs):
        raise NotImplementedError(
            f"a mesh over distinct devices {sorted({str(d) for d in devs})} is "
            f"not ported: {CROSS_CARD_ITEM}"
        )
    return devs


def doc_mesh(devices=DEFAULT_DEVICE) -> DeviceMesh:
    """The 1-D docs mesh: one fleet shard per entry of ``devices``."""
    devs = _mesh_devices(devices)
    return DeviceMesh(devs, {"docs": len(devs)})


def docs_segs_mesh(devices=DEFAULT_DEVICE, seg_shards: int = 1) -> DeviceMesh:
    """The 2-D docs x segs mesh: a hot document's segments block-shard over
    the ``segs`` columns; cold docs use every shard (both axes flattened).
    ``len(devices)`` must be a multiple of ``seg_shards``."""
    devs = _mesh_devices(devices)
    n = len(devs)
    if seg_shards < 1 or n % seg_shards:
        raise ValueError(
            f"seg_shards={seg_shards} does not divide a {n}-device mesh"
        )
    return DeviceMesh(devs, {"docs": n // seg_shards, SEG_AXIS: seg_shards})


def fleet_doc_axes(mesh: DeviceMesh):
    """The axes a fleet state's doc dimension shards over: ``docs``, or
    both axes flattened on a docs x segs mesh."""
    return ("docs", SEG_AXIS) if SEG_AXIS in mesh.shape else "docs"


def _place(state: DocState, device: torch.device) -> DocState:
    return tree_map(
        lambda x: torch.as_tensor(x).to(device=device, dtype=torch.int32).contiguous(),
        state,
    )


def shard_fleet_state(state: DocState, mesh: DeviceMesh) -> DocState:
    """Place a [capacity, ...] fleet state: shard k's rows are the k-th
    block of ``capacity // n_shards``, all on the mesh's device."""
    return _place(state, mesh.device)


def shard_docs(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Place an array with a leading doc dimension."""
    return x.to(mesh.device)


def upload_replicated(ops: np.ndarray, payloads: np.ndarray, mesh: DeviceMesh) -> tuple:
    """Upload a segment lane's [K, B] op ring whole: every shard applies
    every op to its own segment block (the program broadcasts the ring to
    the shards)."""
    nbytes = ops.nbytes + payloads.nbytes
    with span("upload", kind="seg", shards=mesh.seg_shards, bytes=nbytes):
        return (
            torch.from_numpy(ops).to(mesh.device, non_blocking=False),
            torch.from_numpy(payloads).to(mesh.device, non_blocking=False),
        )


def seg_state_specs(state: DocState) -> DocState:
    """Which leaves of a seg-sharded one-document state split over the
    segment axis ("segs") and which replicate ("rep") — the reference's
    partition specs; the stacked layout (``seg_stack``) follows them."""
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
    """Place a seg-sharded one-document state in the reference's blocked
    layout (``seg_shard_state``) as the lane's stacked state on the mesh's
    device: one row per ``segs`` shard."""
    n = int(np.shape(state.nseg)[0])
    if n != mesh.seg_shards:
        raise ValueError(f"a {n}-shard seg state on a {mesh.seg_shards}-shard segs axis")
    return seg_stack(_place(state, mesh.device))


def mesh_fleet_program(step_fn, mesh: DeviceMesh):
    """The fleet program: ``step_fn`` itself, one launch over the whole doc
    axis (every shard's rows), called with a state and arguments that
    already live on the device, on the current stream."""
    return step_fn


def mesh_seg_program(step_fn, mesh: DeviceMesh, state_specs=None):
    """A segment-lane program: ``step_fn(state, *args, group=...)`` over
    the mesh's ``segs`` axis, its collectives those of the stacked group."""
    group = StackedShardGroup(mesh.seg_shards)

    def program(state, *args, **kw):
        return step_fn(state, *args, group=group, **kw)

    return program


def error_count(error: torch.Tensor) -> int:
    """Docs with a latched error bit (one scalar read from the device)."""
    return int(torch.count_nonzero(error))


# Dispatch-seam registration: this module IS the default plane.
from ..models.dispatch import register_dispatch_plane as _register  # noqa: E402

_register(sys.modules[__name__])
