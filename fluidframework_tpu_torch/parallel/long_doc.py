"""Segment-axis query plane for one long document.

Counterpart of ``fluidframework_tpu/parallel/long_doc.py``: the document's
flat segment columns block-shard over a segment axis (shard k owns the
k-th contiguous run, ``nseg`` replicated), and every position query is

    global prefix  =  all_gather of shard totals
    local resolve  =  the K1 containment kernel inside the shard
    combine        =  psum of per-shard one-hot results

This slice runs one shard, where each collective is the identity;
``make_sharded_ops`` returns the same three operations as the reference
(``visible_length``, ``resolve_positions``, ``mark_range``), each one
``seg_collective`` flight-recorder span with the reference's labels.
"""

from __future__ import annotations

import torch

from ..observability.flight_recorder import span
from ..ops.mergetree_kernel import DocState, shard_group
from ..ops.resolve_kernel import resolve_positions as _resolve_kernel
from ..protocol.stamps import NO_REMOVE
from .mesh import DeviceMesh, shard_seg_state

I32 = torch.int32


def shard_doc_state(state: DocState, mesh: DeviceMesh) -> DocState:
    """Place a one-document state with its segment columns over the
    segment axis (one shard: the whole document on the device)."""
    return shard_seg_state(state, mesh)


def _local_vis_lens(s: DocState, ref_seq, client, g) -> torch.Tensor:
    """Per-shard perspective-visible lengths with GLOBAL aliveness (local
    row k is global row shard * S_local + k against the replicated nseg)."""
    n_local = s.seg_len.shape[0]
    gidx = g.axis_index() * n_local + torch.arange(
        n_local, dtype=I32, device=s.seg_len.device
    )
    alive = gidx < s.nseg
    ins_occ = (s.ins_key <= ref_seq) | (s.ins_client == client)
    rem_occ = torch.zeros_like(alive)
    for k, c in zip(s.rem_keys, s.rem_clients):
        rem_occ = rem_occ | (k <= ref_seq) | (c == client)
    vis = alive & ins_occ & ~rem_occ
    return torch.where(vis, s.seg_len, 0)


def _shard_offset(lens: torch.Tensor, g) -> torch.Tensor:
    """Sum of EARLIER shards' visible totals (one all_gather)."""
    totals = g.all_gather(lens.sum(dtype=I32))
    return totals[: g.axis_index()].sum(dtype=I32)


def _global_prefix(lens: torch.Tensor, g) -> torch.Tensor:
    return torch.cumsum(lens, 0, dtype=I32) - lens + _shard_offset(lens, g)


def make_sharded_ops(mesh: DeviceMesh, state: DocState, n_shards: int = 1):
    """(visible_length, resolve_positions, mark_range) for one document
    layout on the plane's device."""
    g = shard_group(n_shards)
    dev = mesh.device

    def _i(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=I32, device=dev)

    def visible_length(s: DocState, ref_seq, client) -> torch.Tensor:
        with span("seg_collective", op="visible_length", shards=n_shards):
            lens = _local_vis_lens(s, _i(ref_seq), _i(client), g)
            return g.psum(lens.sum(dtype=I32))

    def resolve_positions(s: DocState, positions, ref_seq, client):
        """positions[Q] (perspective-visible coordinates) -> (global
        segment index, offset within segment) per query; the shard-local
        search is the K1 kernel."""
        with span("seg_collective", op="resolve", shards=n_shards):
            lens = _local_vis_lens(s, _i(ref_seq), _i(client), g)
            local_q = _i(positions) - _shard_offset(lens, g)
            local_idx, offset, hit = _resolve_kernel(lens, local_q)
            n_local = lens.shape[0]
            global_idx = torch.where(
                hit == 1, g.axis_index() * n_local + local_idx, 0
            )
            return (
                g.psum(global_idx.to(I32)),
                g.psum(torch.where(hit == 1, offset, 0).to(I32)),
            )

    def mark_range(s: DocState, p1, p2, op_key, op_client, ref_seq, client) -> DocState:
        """Remove [p1, p2) under the op's perspective as a purely local mask
        update over whole segments."""
        with span("seg_collective", op="mark_range", shards=n_shards):
            lens = _local_vis_lens(s, _i(ref_seq), _i(client), g)
            prefix = _global_prefix(lens, g)
            in_range = (lens > 0) & (prefix >= _i(p1)) & ((prefix + lens) <= _i(p2))
            key, cl = _i(op_key), _i(op_client)
            new_keys, new_clients = [], []
            taken = torch.zeros_like(in_range)
            for rk, rc in zip(s.rem_keys, s.rem_clients):
                free = (rk == NO_REMOVE) & in_range & ~taken
                new_keys.append(torch.where(free, key, rk))
                new_clients.append(torch.where(free, cl, rc))
                taken = taken | free
            return s._replace(
                rem_keys=tuple(new_keys), rem_clients=tuple(new_clients)
            )

    return visible_length, resolve_positions, mark_range
