"""The dispatch plane: a mesh of shards on one device, or one rank a card.

Counterpart of ``fluidframework_tpu/parallel/mesh.py`` with the same
duck-typed surface (``models/dispatch.py``).  A ``DeviceMesh`` holds one
device per shard and names its axes as the reference mesh does:
``doc_mesh(devices)`` is ``{"docs": n}``, ``docs_segs_mesh(devices,
seg_shards=s)`` is ``{"docs": n // s, "segs": s}``, and cold docs shard over
both axes flattened, so a fleet has ``len(devices)`` shards either way.

Two layouts serve the same programs:

- **One device** (no process group): every entry names the same device
  (``["cuda:0"] * 4`` on the card, ``["cpu"] * 4`` in the tests), the
  port's counterpart of the reference's virtual devices.  A fleet shard
  is a contiguous block of ``docs_per_shard`` rows of the engine's one
  state tensor (``models/placement.py``) and a fleet program is one
  launch over the whole doc axis; a segment lane's shards are the leading
  axis of one stacked state, its collectives reductions over that axis
  (``mergetree_kernel``'s ``StackedShardGroup``).
- **One rank a shard** (``group=``, a ``torch.distributed`` group, or
  ``rank_mesh``): the reference's multi-controller form.  Every rank runs
  the same engine on the same sequenced stream and holds only its own
  shard's rows (``shard_fleet_state``, ``shard_docs``, ``shard_seg_state``
  place that block); a fleet program is one launch over those rows, with
  each rank's obliterate gate read from its own rows (the reference's
  per-shard gate).  A segment lane's collectives are those of a
  ``ProcessShardGroup`` over the rank's ``segs`` subgroup (one
  ``dist.new_group`` per docs row, made on every rank in the same order
  when the mesh is built).  NCCL on the cards (``torch.cuda.set_device``
  before ``init_process_group``), gloo on the CPU; the backend comes from
  the group, never from a failure.

On a rank mesh every operation that reads across shards is a collective:
the mesh's ``sum_all``, ``gather_rows``, ``broadcast``, ``gather_objects``,
``broadcast_object`` and ``seg_gather``.  Every rank must make them in the
same order, and none may run while a lock registered with
``forbid_collectives_under`` is held by the calling thread (an engine
registers its ``ckpt_lock``): they raise ``RuntimeError`` there instead of
waiting on a peer under the lock.

Distinct devices without a group raise ``ValueError``: one process cannot
drive several cards' collectives; run one rank a card under
``torch.distributed`` (``init_process_group``) and pass the group.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.flight_recorder import span
from ..ops.mergetree_kernel import (
    SEG_AXIS,
    DocState,
    ProcessShardGroup,
    StackedShardGroup,
    seg_stack,
    tree_map,
)


@dataclass(frozen=True)
class DeviceMesh:
    """One device per shard; ``shape`` names the axes (their product is
    the shard count).  On a rank mesh ``group`` is the process group (one
    rank a shard, shard k on rank k), ``rank`` this process's shard, and
    ``seg_groups`` the ``segs`` subgroup of each docs row."""

    devices: tuple
    shape: dict = field(hash=False)
    group: object = field(default=None, hash=False, compare=False)
    rank: int = 0
    seg_groups: tuple = field(default=(), hash=False, compare=False)
    _guards: list = field(default_factory=list, hash=False, compare=False, repr=False)
    _calls: list = field(default_factory=lambda: [0], hash=False, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        """This process's device: its rank's on a rank mesh."""
        return self.devices[self.rank]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def seg_shards(self) -> int:
        return int(self.shape.get(SEG_AXIS, 1))

    @property
    def calls(self) -> int:
        """The collectives this mesh has made (a segment program's group
        counts its own, ``ProcessShardGroup.calls``)."""
        return self._calls[0]

    @property
    def ranked(self) -> bool:
        """True on a rank mesh (one process a shard)."""
        return self.group is not None

    def row_range(self, capacity: int) -> tuple[int, int]:
        """The slots [lo, hi) of a ``capacity``-row fleet state this process
        holds: every row on one device, the rank's block on a rank mesh."""
        if not self.ranked:
            return 0, capacity
        per = capacity // self.n_shards
        return self.rank * per, (self.rank + 1) * per

    # ------------------------------------------------ rank-mesh collectives
    def forbid_collectives_under(self, lock) -> None:
        """Make every collective of this mesh raise when the calling thread
        holds ``lock`` (an ``RLock``: ``_is_owned``)."""
        self._guards.append(lock)

    def _wire_device(self) -> torch.device:
        """Where the backend reduces: the host for gloo, the rank's card
        for NCCL."""
        import torch.distributed as dist

        return torch.device("cpu") if dist.get_backend(self.group) == "gloo" else self.device

    def _enter(self):
        import torch.distributed as dist

        for lock in self._guards:
            if lock._is_owned():
                raise RuntimeError(
                    "a rank-mesh collective under a lock that forbids them "
                    "(ckpt_lock): release it before the collective"
                )
        self._calls[0] += 1
        return dist

    def sum_all(self, x) -> int:
        """The sum over the ranks of one int (an ``all_reduce``)."""
        dist = self._enter()
        t = torch.tensor([int(x)], dtype=torch.int64, device=self._wire_device())
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return int(t[0])

    def _reduce(self, x: np.ndarray, op: str) -> np.ndarray:
        dist = self._enter()
        t = torch.as_tensor(np.asarray(x, np.int64)).to(self._wire_device())
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=self.group)
        return t.cpu().numpy()

    def min_all(self, x: np.ndarray) -> np.ndarray:
        """The elementwise minimum over the ranks of an int64 vector."""
        return self._reduce(x, "MIN")

    def max_all(self, x: np.ndarray) -> np.ndarray:
        """The elementwise maximum over the ranks of an int64 vector."""
        return self._reduce(x, "MAX")

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` ([rows, ...], the same shape on every
        rank) concatenated in rank order, on ``x``'s device (an
        ``all_gather``)."""
        dist = self._enter()
        y = x.detach().to(self._wire_device(), copy=True).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.n_shards)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts).to(x.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (every rank passes a tensor of
        the same shape and dtype), on ``x``'s device."""
        dist = self._enter()
        y = x.detach().to(self._wire_device(), copy=True).contiguous()
        dist.broadcast(y, src=dist.get_global_rank(self.group, src), group=self.group)
        return y.to(x.device)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        dist = self._enter()
        out = [None] * self.n_shards
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank (the others pass
        anything: ``None``)."""
        dist = self._enter()
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, src),
                                   group=self.group, device=self._wire_device())
        return box[0]

    def seg_group(self):
        """The collectives of this process's ``segs`` axis: the stacked
        group on one device, the rank's ``segs`` subgroup on a rank mesh."""
        if not self.ranked or self.seg_shards == 1:
            return StackedShardGroup(self.seg_shards)  # one device, or no peer
        return ProcessShardGroup(self.seg_groups[self.rank // self.seg_shards])

    def seg_gather(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """A lane leaf's blocks of every rank of this rank's ``segs`` row,
        stacked [seg_shards, ...] (``x`` is the rank's [1, ...] row)."""
        self._enter()
        g = group if group is not None else self.seg_group()
        return g.all_gather(x).squeeze(1)


def _same_device(dev: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` name one card: compare by index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_devices(devices, group) -> tuple:
    """The shards' devices: one device (a name or ``torch.device``) is a
    one-shard mesh, a sequence one shard per entry.  Without a group every
    entry must name the same device; with one, there is one entry a rank
    of the group."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = tuple(_same_device(resolve_device(d)) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        if any(d != devs[0] for d in devs):
            raise ValueError(
                f"a mesh over distinct devices {sorted({str(d) for d in devs})} needs "
                "one process a device: run one rank a card under torch.distributed "
                "(init_process_group) and pass the group (rank_mesh)"
            )
        return devs
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if world != len(devs):
        raise ValueError(
            f"a {len(devs)}-shard mesh over a {world}-rank group: a rank mesh has "
            "one shard a rank"
        )
    return devs


def _seg_subgroups(group, n: int, seg_shards: int) -> tuple:
    """One ``segs`` subgroup a docs row (ranks [r * s, (r + 1) * s) of the
    group), made on every rank in the same order."""
    if group is None or seg_shards == 1:
        return ()
    import torch.distributed as dist

    ranks = dist.get_process_group_ranks(group)
    return tuple(
        dist.new_group([ranks[i] for i in range(r * seg_shards, (r + 1) * seg_shards)])
        for r in range(n // seg_shards)
    )


def _build(devices, shape_of, group, seg_shards: int) -> DeviceMesh:
    devs = _mesh_devices(devices, group)
    n = len(devs)
    if seg_shards < 1 or n % seg_shards:
        raise ValueError(f"seg_shards={seg_shards} does not divide a {n}-device mesh")
    rank = 0
    if group is not None:
        import torch.distributed as dist

        rank = dist.get_rank(group)
    return DeviceMesh(devs, shape_of(n), group=group, rank=rank,
                      seg_groups=_seg_subgroups(group, n, seg_shards))


def doc_mesh(devices=DEFAULT_DEVICE, group=None) -> DeviceMesh:
    """The 1-D docs mesh: one fleet shard per entry of ``devices`` (one a
    rank of ``group`` on a rank mesh)."""
    return _build(devices, lambda n: {"docs": n}, group, 1)


def docs_segs_mesh(devices=DEFAULT_DEVICE, seg_shards: int = 1, group=None) -> DeviceMesh:
    """The 2-D docs x segs mesh: a hot document's segments block-shard over
    the ``segs`` columns; cold docs use every shard (both axes flattened).
    ``len(devices)`` must be a multiple of ``seg_shards``."""
    return _build(devices, lambda n: {"docs": n // seg_shards, SEG_AXIS: seg_shards},
                  group, seg_shards)


def rank_mesh(seg_shards: int = 1, group=None, device=None) -> DeviceMesh:
    """The rank mesh of an initialised process group (the default group
    unless ``group``): one shard a rank, this rank's device
    ``cuda:LOCAL_RANK`` under NCCL or the CPU under gloo unless ``device``
    names one (gloo ranks sharing one card pass ``"cuda:0"``).  A docs x
    segs mesh when ``seg_shards > 1``.  Every rank must call it, in the
    same order as its other mesh constructions."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("rank_mesh needs torch.distributed.init_process_group first")
    group = group if group is not None else dist.group.WORLD
    if device is None:
        if dist.get_backend(group) == "nccl":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        else:
            device = "cpu"
    mine = str(_same_device(resolve_device(device)))
    devices = [None] * dist.get_world_size(group)
    dist.all_gather_object(devices, mine, group=group)
    if seg_shards > 1:
        return docs_segs_mesh(devices, seg_shards, group=group)
    return doc_mesh(devices, group=group)


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
    block of ``capacity // n_shards``; on one device every block, on a
    rank mesh the rank's block alone."""
    lo, hi = mesh.row_range(int(state.nseg.shape[0]))
    if mesh.ranked:
        state = tree_map(lambda x: x[lo:hi], state)
    return _place(state, mesh.device)


def shard_docs(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Place an array with a leading doc dimension (the rank's block of it
    on a rank mesh)."""
    lo, hi = mesh.row_range(int(x.shape[0]))
    return x[lo:hi].to(mesh.device)


def upload_replicated(ops: np.ndarray, payloads: np.ndarray, mesh: DeviceMesh) -> tuple:
    """Upload a segment lane's [K, B] op ring whole: every shard applies
    every op to its own segment block (the program broadcasts the ring to
    the shards; on a rank mesh every rank uploads the ring it built)."""
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
    device: one row per ``segs`` shard, or on a rank mesh the rank's own
    row (its block, with its copy of the replicated leaves)."""
    n = int(np.shape(state.nseg)[0])
    if n != mesh.seg_shards:
        raise ValueError(f"a {n}-shard seg state on a {mesh.seg_shards}-shard segs axis")
    if not mesh.ranked:
        return seg_stack(_place(state, mesh.device))
    c = mesh.rank % mesh.seg_shards
    stacked = seg_stack(tree_map(lambda x: torch.as_tensor(np.asarray(x)), state))
    return _place(tree_map(lambda x: x[c : c + 1], stacked), mesh.device)


def mesh_fleet_program(step_fn, mesh: DeviceMesh):
    """The fleet program: ``step_fn`` itself, one launch over every row
    this process holds (on a rank mesh its own shard's), called with a
    state and arguments that already live on the device, on the current
    stream."""
    return step_fn


def mesh_seg_program(step_fn, mesh: DeviceMesh, state_specs=None):
    """A segment-lane program: ``step_fn(state, *args, group=...)`` over
    the mesh's ``segs`` axis, its collectives those of the stacked group,
    or on a rank mesh of a ``ProcessShardGroup`` over the rank's ``segs``
    subgroup (``program.group`` either way)."""
    group = mesh.seg_group()

    def program(state, *args, **kw):
        if mesh.ranked:
            mesh._enter()  # the lane's collectives: never under a guarded lock
        return step_fn(state, *args, group=group, **kw)

    program.group = group
    return program


def error_count(error: torch.Tensor, mesh: DeviceMesh | None = None) -> int:
    """Docs with a latched error bit: one scalar read from the device, and
    on a rank mesh the sum of every rank's (the reference's per-shard
    reduce)."""
    n = int(torch.count_nonzero(error))
    if mesh is not None and mesh.ranked:
        return mesh.sum_all(n)
    return n


# Dispatch-seam registration: this module IS the default plane.
from ..models.dispatch import register_dispatch_plane as _register  # noqa: E402

_register(sys.modules[__name__])
