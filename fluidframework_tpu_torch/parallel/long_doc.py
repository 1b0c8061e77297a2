"""Segment-axis query plane for one long document.

Counterpart of ``fluidframework_tpu/parallel/long_doc.py``: the document's
flat segment columns block-shard over a segment axis (shard k owns the
k-th contiguous run, ``nseg`` replicated), and every position query is

    global prefix  =  all_gather of shard totals
    local resolve  =  the K1 containment kernel inside the shard
    combine        =  psum of per-shard one-hot results

The state keeps the reference's global layout; each operation views the
per-segment columns as [n, S_local] (shard i is row i, a reshape, no
copy) and runs the collectives of the stacked group
(``mergetree_kernel.StackedShardGroup``) over that axis, so the K1 search
is one call over every shard.  ``make_sharded_ops`` returns the same three
operations as the reference (``visible_length``, ``resolve_positions``,
``mark_range``), each one ``seg_collective`` flight-recorder span with the
reference's labels.
"""

from __future__ import annotations

import torch

from ..observability.flight_recorder import span
from ..ops.mergetree_kernel import (
    SEG_AXIS,
    SEG_COLUMNS,
    DocState,
    StackedShardGroup,
    tree_map,
)
from ..ops.resolve_kernel import resolve_positions as _resolve_kernel
from ..protocol.stamps import NO_REMOVE
from .mesh import DeviceMesh

I32 = torch.int32


def _n_shards(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1))


def shard_doc_state(state: DocState, mesh: DeviceMesh, axis: str = SEG_AXIS) -> DocState:
    """Place a one-document state on the mesh's device, its segment columns
    to be read in ``n`` equal blocks (shard k owns the k-th contiguous
    run); the segment capacity must divide evenly."""
    n = _n_shards(mesh, axis)
    S = state.seg_len.shape[-1]
    if S % n:
        raise ValueError(f"{S} segment slots do not block over {n} shards")
    return tree_map(
        lambda x: torch.as_tensor(x).to(device=mesh.device, dtype=I32).contiguous(), state
    )


def _stacked(s: DocState, n: int) -> DocState:
    """Views of the segment columns as [n, S_local]."""
    out = {}
    for f in DocState._fields:
        v = getattr(s, f)
        if f in SEG_COLUMNS:
            v = tuple(a.view(n, -1) for a in v) if isinstance(v, tuple) else v.view(n, -1)
        out[f] = v
    return DocState(**out)


def _local_vis_lens(s: DocState, ref_seq, client, g) -> torch.Tensor:
    """Per-shard perspective-visible lengths [n, S_local] with GLOBAL
    aliveness (local row k of shard i is global row i * S_local + k
    against the replicated nseg)."""
    n_local = s.seg_len.shape[-1]
    dev = s.seg_len.device
    gidx = g.axis_index(dev)[:, None] * n_local + torch.arange(n_local, dtype=I32, device=dev)
    alive = gidx < s.nseg
    ins_occ = (s.ins_key <= ref_seq) | (s.ins_client == client)
    rem_occ = torch.zeros_like(alive)
    for k, c in zip(s.rem_keys, s.rem_clients):
        rem_occ = rem_occ | (k <= ref_seq) | (c == client)
    vis = alive & ins_occ & ~rem_occ
    return torch.where(vis, s.seg_len, 0)


def _shard_offset(lens: torch.Tensor, g) -> torch.Tensor:
    """Per shard, the sum of EARLIER shards' visible totals (one
    all_gather)."""
    return g.before(g.all_gather(lens.sum(-1, dtype=I32)))


def _global_prefix(lens: torch.Tensor, g) -> torch.Tensor:
    return torch.cumsum(lens, -1, dtype=I32) - lens + _shard_offset(lens, g)[:, None]


def make_sharded_ops(mesh: DeviceMesh, state: DocState, axis: str = SEG_AXIS):
    """(visible_length, resolve_positions, mark_range) for one document
    layout over the mesh's ``axis`` shards (one shard on a mesh without
    that axis)."""
    n_shards = _n_shards(mesh, axis)
    g = StackedShardGroup(n_shards)
    dev = mesh.device

    def _i(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=I32, device=dev)

    def visible_length(s: DocState, ref_seq, client) -> torch.Tensor:
        with span("seg_collective", op="visible_length", shards=n_shards):
            lens = _local_vis_lens(_stacked(s, n_shards), _i(ref_seq), _i(client), g)
            return g.psum(lens.sum(-1, dtype=I32))[0]

    def resolve_positions(s: DocState, positions, ref_seq, client):
        """positions[Q] (perspective-visible coordinates) -> (global
        segment index, offset within segment) per query; the shard-local
        search is one K1 call over every shard."""
        with span("seg_collective", op="resolve", shards=n_shards):
            lens = _local_vis_lens(_stacked(s, n_shards), _i(ref_seq), _i(client), g)
            local_q = _i(positions)[None, :] - _shard_offset(lens, g)[:, None]
            local_idx, offset, hit = _resolve_kernel(lens, local_q)
            n_local = lens.shape[-1]
            global_idx = torch.where(
                hit == 1, g.axis_index(dev)[:, None] * n_local + local_idx, 0
            )
            return (
                g.psum(global_idx.to(I32))[0],
                g.psum(torch.where(hit == 1, offset, 0).to(I32))[0],
            )

    def mark_range(s: DocState, p1, p2, op_key, op_client, ref_seq, client) -> DocState:
        """Remove [p1, p2) under the op's perspective as a purely local mask
        update over whole segments."""
        with span("seg_collective", op="mark_range", shards=n_shards):
            sv = _stacked(s, n_shards)
            lens = _local_vis_lens(sv, _i(ref_seq), _i(client), g)
            prefix = _global_prefix(lens, g)
            in_range = (lens > 0) & (prefix >= _i(p1)) & ((prefix + lens) <= _i(p2))
            key, cl = _i(op_key), _i(op_client)
            new_keys, new_clients = [], []
            taken = torch.zeros_like(in_range)
            for rk, rc in zip(sv.rem_keys, sv.rem_clients):
                free = (rk == NO_REMOVE) & in_range & ~taken
                new_keys.append(torch.where(free, key, rk).reshape(-1))
                new_clients.append(torch.where(free, cl, rc).reshape(-1))
                taken = taken | free
            return s._replace(
                rem_keys=tuple(new_keys), rem_clients=tuple(new_clients)
            )

    return visible_length, resolve_positions, mark_range
