"""Columnar SharedMatrix kernel in PyTorch: permutation vectors + cell writes.

Counterpart of ``fluidframework_tpu/ops/matrix_kernel.py``, held byte for
byte against it (every state column, both permutation merge-trees' raw
columns included, and the summary JSON).  Reference parity: matrix.ts
processMessagesCore — position->handle resolution through the permutation
merge-trees under the op's perspective, then LWW or FWW cell conflict
(shouldSetCellBasedOnFWW, matrix.ts:987).

The row and column permutation vectors are the port's merge-tree
(``ops/mergetree_kernel.py``): the text pool stores handle ids instead of
codepoints, and a row/column insert applied at seq S allocates the next
``count`` handles from the replica's counter — identical on every replica
because ops apply in total order.  Cell state is dense [HR, HC] int32
(values host-interned) with the last write's (seq, client) for FWW.

What changes from the reference is the idiom, as in ``mergetree_kernel``:
every function takes a state with a leading matrix axis in place of
``vmap`` (``apply_ops`` is the one-matrix form of ``apply_ops_fleet``), a
Python loop walks the op batch in place of ``lax.scan``, and ``lax.switch``
becomes one masked pass per op kind present at a batch position, with the
kinds read from the host copy of the ops.  A SET_CELL write lands at the
resolved handles as the reference's dropped scatter does: a handle past
the grid (the ``ERR_HANDLE_RANGE`` latch's case) writes nothing.
``apply_ops_fleet.launches`` counts the programs run on a CUDA device, one
per call of either entry point.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, count_launch, resolve_device
from ..protocol.stamps import ALL_ACKED
from . import mergetree_kernel as mk

I32 = torch.int32

ERR_HANDLE_RANGE = 16


class MatrixOpKind:
    NOOP = 0
    INSERT_ROWS = 1
    INSERT_COLS = 2
    REMOVE_ROWS = 3
    REMOVE_COLS = 4
    SET_CELL = 5


# Op row layout (int32[8]):
#   0 kind | 1 seq | 2 client | 3 ref_seq | 4 pos1 | 5 pos2/count | 6 a | 7 b
# SET_CELL: pos1=row pos2=col a=value b=fww_flag
# INSERT_*: pos1=pos  pos2=count
# REMOVE_*: pos1=pos  pos2=count
MATRIX_OP_FIELDS = 8


class MatrixState(NamedTuple):
    rows: mk.DocState
    cols: mk.DocState
    next_row_handle: torch.Tensor  # int32 scalar
    next_col_handle: torch.Tensor  # int32 scalar
    cell_val: torch.Tensor         # int32[HR, HC]
    cell_present: torch.Tensor     # int32[HR, HC]
    cell_seq: torch.Tensor         # int32[HR, HC] last write seq (0 = none)
    cell_client: torch.Tensor      # int32[HR, HC] last write short client
    fww: torch.Tensor              # int32 scalar 0/1
    error: torch.Tensor            # int32 scalar


def tree_map(fn, s: MatrixState) -> MatrixState:
    """Apply ``fn`` to every tensor of a state (both perms included)."""
    return MatrixState(mk.tree_map(fn, s.rows), mk.tree_map(fn, s.cols),
                       *(fn(x) for x in s[2:]))


def init_state(
    max_rows: int = 256,
    max_cols: int = 256,
    max_segments: int = 128,
    remove_slots: int = 4,
    device=DEFAULT_DEVICE,
) -> MatrixState:
    """One empty matrix on ``device``."""
    dev = resolve_device(device)

    def grid(v):
        return torch.full((max_rows, max_cols), v, dtype=I32, device=dev)

    def scalar():
        return torch.zeros((), dtype=I32, device=dev)

    return MatrixState(
        rows=mk.init_state(max_segments, remove_slots, 1, max_rows, device=dev),
        cols=mk.init_state(max_segments, remove_slots, 1, max_cols, device=dev),
        next_row_handle=scalar(), next_col_handle=scalar(),
        cell_val=grid(0), cell_present=grid(0), cell_seq=grid(0), cell_client=grid(-1),
        fww=scalar(), error=scalar(),
    )


def batch_state(state: MatrixState, n: int) -> MatrixState:
    """A fleet of ``n`` copies of one matrix (leading matrix axis)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()), state)


def matrix_row(state: MatrixState, d: int) -> MatrixState:
    """Matrix ``d`` of a fleet, as a one-matrix state (views)."""
    return tree_map(lambda x: x[d], state)


def matrix_state_from_numpy(state, device=DEFAULT_DEVICE) -> MatrixState:
    """A state from a numpy-readable one in ``MatrixState`` field order (a
    reference state: its perms are ``DocState``s), as int32 tensors."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x, np.int32)).to(dev)
    return MatrixState(mk.from_numpy(state[0], dev), mk.from_numpy(state[1], dev),
                       *(t(x) for x in state[2:]))


def _resolve_handle(perm: mk.DocState, pos, ref_seq, client):
    """Position -> handle under each op's perspective (ref adjustPosition),
    [D] in and out; -1 where no visible segment holds ``pos``."""
    vis = mk._visible(perm, ref_seq, client)
    vlen, excl = mk._vis_lengths(perm, vis)
    p = pos[:, None]
    inside = vis & (excl <= p) & (p < excl + vlen)
    k = mk._first_true(inside, torch.zeros_like(pos))
    found = inside.any(-1)
    off = pos - mk._take(excl, k)
    handle = mk._take(perm.text, mk._take(perm.seg_start, k) + off)
    return torch.where(found, handle, -1), found


def _op_row(kind: int, op, pos2, count) -> torch.Tensor:
    """A merge-tree op row [D, 8]: kind, seq, client, ref_seq, pos1 from the
    matrix op; pos2 and the insert's text length as given."""
    z = torch.zeros_like(op[:, 0])
    return torch.stack([torch.full_like(z, kind), op[:, 1], op[:, 2], op[:, 3], op[:, 4],
                        pos2, count, z], -1)


def _perm_insert(perm: mk.DocState, next_handle, op, act):
    """Insert ``count`` handles at pos where ``act``: a merge-tree insert
    whose payload is the next handle ids (capacity = the text pool)."""
    count = op[:, 5]
    T = perm.text.shape[-1]
    payload = next_handle[:, None] + torch.arange(T, dtype=I32, device=op.device)
    ins = _op_row(mk.OpKind.INSERT, op, torch.zeros_like(count), count)
    # Permutation vectors never carry obliterates: ob machinery stays off.
    new_perm = mk._do_insert(perm, ins, payload, False, act)
    return new_perm, next_handle + torch.where(act, count, 0)


def _perm_remove(perm: mk.DocState, op, act):
    rem = _op_row(mk.OpKind.REMOVE, op, op[:, 4] + op[:, 5], torch.zeros_like(op[:, 0]))
    return mk._do_remove(perm, rem, None, act)


def _set_cell(s: MatrixState, op, act) -> MatrixState:
    seq, client, ref_seq = op[:, 1], op[:, 2], op[:, 3]
    value, fww_flag = op[:, 6], op[:, 7]
    HR, HC = s.cell_val.shape[-2:]
    fww = torch.where(act, torch.maximum(s.fww, fww_flag), s.fww)
    rh, rfound = _resolve_handle(s.rows, op[:, 4], ref_seq, client)
    ch, cfound = _resolve_handle(s.cols, op[:, 5], ref_seq, client)
    ok = rfound & cfound
    # The reference reads the last write at jnp's clamped (negative:
    # wrapped) index and drops an out-of-range write, so a read outside the
    # grid only feeds a write that never lands.
    inb = (rh >= 0) & (rh < HR) & (ch >= 0) & (ch < HC)
    flat = (rh.clamp(0, HR - 1) * HC + ch.clamp(0, HC - 1)).long()[:, None]

    def cell(arr):
        return arr.view(arr.shape[0], -1).gather(1, flat)[:, 0]

    last_seq = cell(s.cell_seq)
    last_client = cell(s.cell_client)
    # FWW: first write, same client, or ref_seq >= last write's seq.
    should = torch.where(
        fww > 0, (last_seq == 0) | (last_client == client) | (ref_seq >= last_seq), True)
    write = act & ok & should & inb

    def upd(arr, v):
        arr.view(arr.shape[0], -1).scatter_(
            1, flat, torch.where(write, v, cell(arr)).to(I32)[:, None])
        return arr

    return s._replace(
        cell_val=upd(s.cell_val, value),
        cell_present=upd(s.cell_present, torch.ones_like(value)),
        cell_seq=upd(s.cell_seq, seq),
        cell_client=upd(s.cell_client, client),
        fww=fww,
        error=s.error | torch.where(act & ~ok, ERR_HANDLE_RANGE, 0).to(I32),
    )


def _branch(s: MatrixState, op, kind: int, act) -> MatrixState:
    if kind == MatrixOpKind.INSERT_ROWS:
        rows, nh = _perm_insert(s.rows, s.next_row_handle, op, act)
        over = act & (nh > s.cell_val.shape[-2])
        return s._replace(rows=rows, next_row_handle=nh,
                          error=s.error | torch.where(over, ERR_HANDLE_RANGE, 0).to(I32))
    if kind == MatrixOpKind.INSERT_COLS:
        cols, nh = _perm_insert(s.cols, s.next_col_handle, op, act)
        over = act & (nh > s.cell_val.shape[-1])
        return s._replace(cols=cols, next_col_handle=nh,
                          error=s.error | torch.where(over, ERR_HANDLE_RANGE, 0).to(I32))
    if kind == MatrixOpKind.REMOVE_ROWS:
        return s._replace(rows=_perm_remove(s.rows, op, act))
    if kind == MatrixOpKind.REMOVE_COLS:
        return s._replace(cols=_perm_remove(s.cols, op, act))
    return _set_cell(s, op, act)


def _apply(s: MatrixState, ops: torch.Tensor, kinds: np.ndarray) -> MatrixState:
    s = tree_map(torch.clone, s)  # private: the passes update in place
    # lax.switch clamps the kind into [0, 5]
    kinds = np.clip(kinds, MatrixOpKind.NOOP, MatrixOpKind.SET_CELL)
    for b in range(ops.shape[1]):
        op = ops[:, b]
        col = kinds[:, b]
        for kd in np.unique(col).tolist():
            if kd != MatrixOpKind.NOOP:
                s = _branch(s, op, kd, torch.as_tensor(col == kd, device=ops.device))
    return s


def _host_kinds(ops) -> np.ndarray:
    if isinstance(ops, torch.Tensor):
        return ops[..., 0].cpu().numpy()
    return np.asarray(ops)[..., 0]


def apply_ops_fleet(s: MatrixState, ops, kinds=None) -> MatrixState:
    """Apply ops[D, B, 8] to a fleet of D matrices, in order along B.
    ``kinds``: the host copy of the ops' kinds [D, B], when the caller has
    it (saves a device read)."""
    count_launch(s.error, apply_ops_fleet)
    if kinds is None:
        kinds = _host_kinds(ops)
    ops = mk._as_tensor(ops, s.error.device)
    return _apply(s, ops, np.asarray(kinds))


apply_ops_fleet.launches = 0


def apply_ops(s: MatrixState, ops, kinds=None) -> MatrixState:
    """Apply a [B, 8] batch of sequenced ops to one matrix, in order."""
    count_launch(s.error, apply_ops_fleet)
    if kinds is None:
        kinds = _host_kinds(ops)
    ops = mk._as_tensor(ops, s.error.device)[None]
    out = _apply(tree_map(lambda x: x[None], s), ops, np.asarray(kinds)[None])
    return matrix_row(out, 0)


# ----------------------------------------------------------------------------
# Host views (one matrix)
# ----------------------------------------------------------------------------

def visible_handles(perm: mk.DocState, ref_seq: int = None, view_client: int = -3):
    ref = ALL_ACKED if ref_seq is None else ref_seq
    perm = mk.to_numpy(perm)
    nseg, vis = mk._host_vis(perm, ref, view_client)
    start = perm.seg_start[:nseg]
    length = perm.seg_len[:nseg]
    out = []
    for i in range(nseg):
        if vis[i]:
            out.extend(int(h) for h in perm.text[start[i]: start[i] + length[i]])
    return out


def to_grid(s: MatrixState):
    """Materialized consensus grid (None for unset cells)."""
    rows = visible_handles(s.rows)
    cols = visible_handles(s.cols)
    val = s.cell_val.cpu().numpy()
    present = s.cell_present.cpu().numpy()
    return [
        [int(val[rh, ch]) if present[rh, ch] else None for ch in cols]
        for rh in rows
    ]


# ----------------------------------------------------------------------------
# Summary-record codecs (byte-identical JSON to the reference's)
# ----------------------------------------------------------------------------

def _perm_to_json(perm: mk.DocState) -> dict:
    """Exact dump of a permutation merge-tree (every column: seg layout,
    stamps, uids, remove slots)."""
    out = {}
    for name, arr in mk.to_numpy(perm)._asdict().items():
        if isinstance(arr, tuple):
            out[name] = [a.tolist() for a in arr]
        else:
            out[name] = arr.tolist()
    return out


def _perm_from_json(d: dict, device) -> mk.DocState:
    kw = {}
    for name, val in d.items():
        if name in ("rem_keys", "rem_clients", "prop_keys", "prop_vals"):
            kw[name] = tuple(np.asarray(v, np.int32) for v in val)
        else:
            kw[name] = np.asarray(val, np.int32)
    return mk.from_numpy(mk.DocState(**kw), device)


def state_to_summary(s: MatrixState) -> dict:
    """One matrix -> summary JSON: exact perm dumps + the sparse touched
    cell set + handle counters."""
    val = s.cell_val.cpu().numpy()
    present = s.cell_present.cpu().numpy()
    seq = s.cell_seq.cpu().numpy()
    client = s.cell_client.cpu().numpy()
    touched = np.nonzero((present != 0) | (seq != 0) | (client != -1) | (val != 0))
    return {
        "shape": [int(val.shape[0]), int(val.shape[1])],
        "rows": _perm_to_json(s.rows),
        "cols": _perm_to_json(s.cols),
        "next_row_handle": int(s.next_row_handle),
        "next_col_handle": int(s.next_col_handle),
        "cells": [
            [int(r), int(c), int(val[r, c]), int(present[r, c]),
             int(seq[r, c]), int(client[r, c])]
            for r, c in zip(*touched)
        ],
        "fww": int(s.fww),
    }


def summary_to_state(summary: dict, device=DEFAULT_DEVICE) -> MatrixState:
    """Summary JSON -> a MatrixState identical to the one summarized."""
    dev = resolve_device(device)
    HR, HC = summary["shape"]
    cell_val = np.zeros((HR, HC), np.int32)
    cell_present = np.zeros((HR, HC), np.int32)
    cell_seq = np.zeros((HR, HC), np.int32)
    cell_client = np.full((HR, HC), -1, np.int32)
    for r, c, v, pres, sq, cl in summary["cells"]:
        if not (0 <= r < HR and 0 <= c < HC):
            raise ValueError(f"summary cell ({r},{c}) outside shape {HR}x{HC}")
        cell_val[r, c], cell_present[r, c] = v, pres
        cell_seq[r, c], cell_client[r, c] = sq, cl
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32)).to(dev)
    return MatrixState(
        rows=_perm_from_json(summary["rows"], dev),
        cols=_perm_from_json(summary["cols"], dev),
        next_row_handle=t(summary["next_row_handle"]),
        next_col_handle=t(summary["next_col_handle"]),
        cell_val=t(cell_val), cell_present=t(cell_present),
        cell_seq=t(cell_seq), cell_client=t(cell_client),
        fww=t(summary["fww"]), error=t(0),
    )
