"""The nested columnar forest in PyTorch: SharedTree trunk-commit application.

Counterpart of the nested-forest part of ``fluidframework_tpu/ops/tree_kernel.py``
(``NestedForestState`` and its op layout, ``apply_nested_op`` /
``apply_nested_ops`` / ``apply_nested_megastep`` — K7 — and
``compact_nested`` — K8 — with the host views), held byte for byte against
it: every raw column, padding remnants and the word pool included, and the
per-doc error latch.

Each node is a STABLE row whose place in the tree is its (parent row,
field, sibling index) columns, not its row order.  An op addresses its
target field by a path of up to ``MAX_PATH`` (field, index) steps from the
virtual root; structural edits are masked column arithmetic (insert bumps
sibling indices and appends fresh rows, remove kills a sibling range and
propagates death down the parent chain, move rewrites indices, set writes
the value columns); str/f64 leaf values live in a per-doc append-only word
pool addressed by (offset, vlen); compaction is a stable gather of the live
rows plus a parent remap and a pack of the live pool spans.

What changes from the reference is the idiom, as in ``mergetree_kernel``:

- Every function takes a state with an explicit leading doc axis (``[D, N]``
  row columns, ``[D, P]`` pool, ``[D]`` scalars) in place of ``vmap``, and
  Python loops walk the op ring in place of ``lax.scan``.
  ``init_nested_forest`` returns one document; ``batch_nested`` stacks it.
- ``lax.switch`` over the op kind becomes one pass per kind present at a
  ring position, read from the host-side ring: a kind held by many docs runs
  masked over the batch (``act``), one held by few runs on their gathered
  rows.  Kinds outside [0, 5] clamp into it, as ``lax.switch`` clamps.
- The ``lax.cond`` failure paths keep the whole state (pool and watermarks
  included) and OR error bits into the latch: every write is masked by the
  per-doc commit flag.
- ``argmax`` first hits become explicit index minima, the dropped pool
  scatter a masked ``scatter_add_`` of differences, and every sum and
  cumsum is taken back to int32.
- Path resolution runs only the steps some doc's op needs (the host ring
  holds each op's depth); the steps past an op's depth leave its parent
  unchanged in the reference too.

``apply_nested_megastep.launches`` counts the K7 programs and
``compact_nested.launches`` the K8 programs run on a CUDA device (one per
call of a public entry point).

The module also holds the plain form of the rebase window program (K9's
``rebase_window_kernel``) and, at its end, K11: the flat forest and the
rebase position arithmetic of the reference module's first part
(``rebase_insert_positions``, ``apply_value_sets``, ``apply_forest_ops``
and their doc-batched forms).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, count_launch, resolve_device
from ..protocol.mark_schema import (  # noqa: F401  (TreeMarkKind: re-export)
    DEVICE_CODE_OFFSET,
    K_INSERT,
    K_MODIFY,
    K_REMOVE,
    K_SKIP,
    TreeMarkKind,
)

I32 = torch.int32

MAX_PATH = 6           # path steps per op (target field may sit one deeper)
_TGT = 3 + 2 * MAX_PATH  # target-block base after the path pairs
NESTED_OP_FIELDS = _TGT + 7
# Op row layout (int32[NESTED_OP_FIELDS]):
#  0 kind | 1 seq | 2 depth | 3.._TGT-1 (f_k, i_k) path pairs |
#  _TGT fld | +1 pos | +2 count | +3 dst | +4 value | +5 vkind | +6 ntype

VKIND_NONE = 0
VKIND_INT = 1
# Pooled kinds: the row's value column is an OFFSET into the doc's word pool
# and vlen holds the span length.  For pooled INSERT/SET ops the op's value
# slot carries the word count and the payload row the words.
VKIND_STR = 2    # words = codepoints
VKIND_F64 = 3    # words = the two int32 halves of the float64 bit pattern
VKIND_BOOL = 4   # inline like INT (value column is 0/1)

_POOLED = (VKIND_STR, VKIND_F64)


class NestedOpKind:
    NOOP = 0
    INSERT = 1   # count nodes (one ntype/vkind run) at pos; payload = values
    REMOVE = 2   # count subtrees at pos
    SET = 3      # value of the node at (field, pos)
    MOVE = 4     # count nodes from pos to boundary dst (input coords)
    REPLACE_FIELD = 5  # kill ALL siblings (+ descendants), insert count fresh


_LAST_KIND = NestedOpKind.REPLACE_FIELD

ERR_NODE_OVERFLOW = 1
ERR_FOREST_RANGE = 2
ERR_POOL_OVERFLOW = 4

# A kind held by at most 1/SUBSET_FRACTION of the docs at a ring position
# runs on their gathered rows.  On the tree fleet's ring (``chip_smoke.py``
# ``tree_programs``, 1,024 docs on an H100) gathered passes take less device
# time than masked ones up to a quarter of the docs and more from half.
SUBSET_FRACTION = 4


class NestedForestState(NamedTuple):
    parent: torch.Tensor    # int32[N] parent row id (-1 = virtual root)
    field_id: torch.Tensor  # int32[N] interned field key
    index: torch.Tensor     # int32[N] sibling index within (parent, field)
    ntype: torch.Tensor     # int32[N] interned node type
    value: torch.Tensor     # int32[N] inline value, or pool offset (pooled)
    vkind: torch.Tensor     # int32[N] VKIND_*
    vlen: torch.Tensor      # int32[N] pool span length (pooled kinds only)
    val_seq: torch.Tensor   # int32[N] seq of winning value write
    alive: torch.Tensor     # int32[N] 0/1
    pool: torch.Tensor      # int32[P] append-only word pool (str/f64 values)
    pool_end: torch.Tensor  # int32 scalar pool watermark
    nrow: torch.Tensor      # int32 scalar allocation watermark
    error: torch.Tensor     # int32 scalar bitmask


def tree_map(fn, s: NestedForestState) -> NestedForestState:
    return NestedForestState(*(fn(x) for x in s))


def init_nested_forest(
    capacity: int = 1024, pool_capacity: int = 4096, device=DEFAULT_DEVICE
) -> NestedForestState:
    """One empty document on ``device``."""
    dev = resolve_device(device)
    z = torch.zeros((capacity,), dtype=I32, device=dev)
    return NestedForestState(
        parent=torch.full((capacity,), -1, dtype=I32, device=dev),
        field_id=z, index=z.clone(), ntype=z.clone(), value=z.clone(),
        vkind=z.clone(), vlen=z.clone(), val_seq=z.clone(), alive=z.clone(),
        pool=torch.zeros((pool_capacity,), dtype=I32, device=dev),
        pool_end=torch.zeros((), dtype=I32, device=dev),
        nrow=torch.zeros((), dtype=I32, device=dev),
        error=torch.zeros((), dtype=I32, device=dev),
    )


def batch_nested(proto: NestedForestState, n_docs: int) -> NestedForestState:
    """``n_docs`` copies of a one-document state, stacked on a doc axis."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n_docs,) + (1,) * x.dim()), proto)


def nested_state_from_numpy(leaves, device=DEFAULT_DEVICE) -> NestedForestState:
    """A state from numpy leaves in ``NestedForestState`` field order (the
    reference's leaves read with ``np.asarray``), as int32 tensors."""
    dev = resolve_device(device)
    return NestedForestState(
        *(torch.as_tensor(np.array(x, np.int32)).to(dev) for x in leaves)
    )


def to_numpy(s: NestedForestState) -> NestedForestState:
    return tree_map(lambda x: x.cpu().numpy(), s)


def _own(s: NestedForestState) -> NestedForestState:
    """A private copy: branches update the pool and gathered rows in place."""
    return tree_map(torch.clone, s)


def _bits(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return cond.to(I32) * bit


def _is_pooled(vkind: torch.Tensor) -> torch.Tensor:
    return (vkind == VKIND_STR) | (vkind == VKIND_F64)


# ------------------------------------------------------------ K7: one op

def _resolve_parent(s: NestedForestState, op, n_steps: int):
    """Walk each doc's path steps to its parent row id: (parent, ok);
    parent -1 is the virtual root, -2 a step that found no row.  Runs the
    first ``n_steps`` steps (the deepest op's depth, at most MAX_PATH)."""
    D, N = s.parent.shape
    iota = torch.arange(N, dtype=I32, device=op.device)
    depth = op[:, 2]
    parent = torch.full((D,), -1, dtype=I32, device=op.device)
    ok = torch.ones((D,), dtype=torch.bool, device=op.device)
    live = s.alive == 1
    for k in range(n_steps):
        f, i = op[:, 3 + 2 * k], op[:, 4 + 2 * k]
        active = k < depth
        mask = live & (s.parent == parent[:, None]) & (s.field_id == f[:, None]) & (
            s.index == i[:, None]
        )
        hit = torch.where(mask, iota, N).amin(-1).to(I32)
        found = hit < N
        parent = torch.where(active, torch.where(found, hit, -2), parent)
        ok = ok & (found | ~active)
    return parent, ok


def _kill_with_descendants(s: NestedForestState, target) -> torch.Tensor:
    """Alive column with ``target`` rows dead and death propagated down the
    parent chain (MAX_PATH + 1 levels, the deepest addressable node)."""
    N = s.parent.shape[-1]
    alive = torch.where(target, 0, s.alive)
    pk = s.parent.clamp(0, N - 1).long()
    has_parent = s.parent >= 0
    for _ in range(MAX_PATH + 1):
        parent_dead = has_parent & (alive.gather(1, pk) == 0)
        alive = torch.where(parent_dead, 0, alive)
    return alive


def _pool_write(s: NestedForestState, wlen, payload, commit) -> None:
    """Append ``payload[:wlen]`` at each committing doc's pool watermark, in
    place (the reference drops the writes of docs whose op fails)."""
    P = s.pool.shape[-1]
    W = payload.shape[-1]
    tpos = torch.arange(W, dtype=I32, device=payload.device)
    dst = s.pool_end[:, None] + tpos
    dst = torch.where(dst < 0, dst + P, dst)  # jnp scatter wraps negatives
    valid = commit[:, None] & (tpos < wlen[:, None]) & (dst >= 0) & (dst < P)
    idx = dst.clamp(0, P - 1).long()
    old = s.pool.gather(1, idx)
    s.pool.scatter_add_(1, idx, torch.where(valid, payload - old, 0))


def _fresh_run(s: NestedForestState, commit, count, parent, fld, fresh_index,
               seq, vkind, ntype, wlen, payload, alive, index_others) -> NestedForestState:
    """Allocate ``count`` fresh rows (one vkind/ntype run) at each committing
    doc's row watermark: the row write shared by INSERT and REPLACE_FIELD.
    ``fresh_index(j)`` gives the sibling index of the row at allocation
    offset j; ``index_others`` and ``alive`` are the other rows' columns."""
    N = s.parent.shape[-1]
    W = payload.shape[-1]
    iota = torch.arange(N, dtype=I32, device=payload.device)
    j = iota - s.nrow[:, None]
    fresh = commit[:, None] & (j >= 0) & (j < count[:, None])
    pay = payload.gather(1, j.clamp(0, W - 1).long())
    inline = (vkind == VKIND_INT) | (vkind == VKIND_BOOL)
    row_val = torch.where(
        _is_pooled(vkind)[:, None], s.pool_end[:, None], torch.where(inline[:, None], pay, 0)
    )

    def put(x, col):
        return torch.where(fresh, x, col)

    return s._replace(
        parent=put(parent[:, None], s.parent),
        field_id=put(fld[:, None], s.field_id),
        index=put(fresh_index(j), index_others),
        ntype=put(ntype[:, None], s.ntype),
        value=put(row_val, s.value),
        vkind=put(vkind[:, None], s.vkind),
        vlen=put(wlen[:, None], s.vlen),
        val_seq=put(seq[:, None], s.val_seq),
        alive=put(1, alive),
        pool_end=torch.where(commit, s.pool_end + wlen, s.pool_end),
        nrow=torch.where(commit, s.nrow + count, s.nrow),
    )


def _branch(s: NestedForestState, op, payload, kind: int, act, n_steps: int) -> NestedForestState:
    """One op kind over the docs flagged by ``act``; every other doc keeps
    every column."""
    seq = op[:, 1]
    t = _TGT
    fld, pos, count, dst = op[:, t], op[:, t + 1], op[:, t + 2], op[:, t + 3]
    value, vkind, ntype = op[:, t + 4], op[:, t + 5], op[:, t + 6]
    N = s.parent.shape[-1]
    P = s.pool.shape[-1]
    parent, okp = _resolve_parent(s, op, n_steps)
    sib = (s.alive == 1) & (s.parent == parent[:, None]) & (s.field_id == fld[:, None])
    n_sib = sib.sum(-1, dtype=I32)
    wlen = torch.where(_is_pooled(vkind), value, 0)
    pool_over = s.pool_end + wlen > P
    idx = s.index

    if kind == NestedOpKind.INSERT:
        over = s.nrow + count > N
        bad = ~okp | (pos > n_sib)
        commit = act & okp & ~over & ~bad & ~pool_over
        bits = _bits(over, ERR_NODE_OVERFLOW) | _bits(bad, ERR_FOREST_RANGE) | _bits(
            pool_over, ERR_POOL_OVERFLOW
        )
        _pool_write(s, wlen, payload, commit)
        shifted = torch.where(
            commit[:, None] & sib & (idx >= pos[:, None]), idx + count[:, None], idx
        )
        s = _fresh_run(
            s, commit, count, parent, fld, lambda j: pos[:, None] + j, seq, vkind,
            ntype, wlen, payload, s.alive, shifted,
        )
    elif kind == NestedOpKind.REMOVE:
        bad = ~okp | (pos + count > n_sib)
        commit = act & ~bad
        bits = _bits(bad, ERR_FOREST_RANGE)
        c = commit[:, None]
        end = (pos + count)[:, None]
        target = c & sib & (idx >= pos[:, None]) & (idx < end)
        s = s._replace(
            alive=torch.where(c, _kill_with_descendants(s, target), s.alive),
            index=torch.where(c & sib & (idx >= end), idx - count[:, None], idx),
        )
    elif kind == NestedOpKind.SET:
        hit = sib & (idx == pos[:, None])
        bad = ~okp | ~hit.any(-1)
        commit = act & ~bad & ~pool_over
        bits = _bits(bad, ERR_FOREST_RANGE) | _bits(pool_over, ERR_POOL_OVERFLOW)
        _pool_write(s, wlen, payload, commit)
        new_val = torch.where(_is_pooled(vkind), s.pool_end, value)
        h = hit & commit[:, None]
        s = s._replace(
            value=torch.where(h, new_val[:, None], s.value),
            vkind=torch.where(h, vkind[:, None], s.vkind),
            vlen=torch.where(h, wlen[:, None], s.vlen),
            val_seq=torch.where(h, seq[:, None], s.val_seq),
            pool_end=torch.where(commit, s.pool_end + wlen, s.pool_end),
        )
    elif kind == NestedOpKind.MOVE:
        bad = ~okp | (pos + count > n_sib) | (dst > n_sib)
        commit = act & ~bad
        bits = _bits(bad, ERR_FOREST_RANGE)
        p, n = pos[:, None], count[:, None]
        dstp = torch.where(dst > pos + count, dst - count, torch.minimum(dst, pos))[:, None]
        moved = sib & (idx >= p) & (idx < p + n)
        u = torch.where(idx > p + n - 1, idx - n, idx)
        new_surv = torch.where(u >= dstp, u + n, u)
        new_idx = torch.where(moved, dstp + (idx - p), torch.where(sib, new_surv, idx))
        s = s._replace(index=torch.where(commit[:, None], new_idx, idx))
    else:  # REPLACE_FIELD
        over = s.nrow + count > N
        bad = ~okp
        commit = act & okp & ~over & ~pool_over
        bits = _bits(over, ERR_NODE_OVERFLOW) | _bits(bad, ERR_FOREST_RANGE) | _bits(
            pool_over, ERR_POOL_OVERFLOW
        )
        _pool_write(s, wlen, payload, commit)
        c = commit[:, None]
        alive = torch.where(c, _kill_with_descendants(s, c & sib), s.alive)
        s = _fresh_run(
            s, commit, count, parent, fld, lambda j: j, seq, vkind, ntype, wlen,
            payload, alive, idx,
        )
    # ``bits`` is 0 wherever the op committed.
    return s._replace(error=s.error | torch.where(act, bits, 0))


def _ring_info(ops, host_ops) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (kinds clamped to [0, 5], path depths) of an op ring."""
    if host_ops is None:
        host_ops = ops[..., :3].cpu().numpy() if isinstance(ops, torch.Tensor) else ops
    host_ops = np.asarray(host_ops)
    return np.clip(host_ops[..., 0], 0, _LAST_KIND), host_ops[..., 2]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def _apply_pos(s: NestedForestState, op, payload, kinds: np.ndarray,
               depths: np.ndarray) -> NestedForestState:
    """One ring position over the doc batch (``op[D, F]``, host-side
    ``kinds[D]`` and ``depths[D]``): each kind present runs its pass on
    the docs holding it; NOOP rows are untouched."""
    D = kinds.shape[0]
    kind = None
    for kd in np.unique(kinds).tolist():
        if kd == NestedOpKind.NOOP:
            continue
        rows = np.flatnonzero(kinds == kd)
        n_steps = int(np.clip(depths[rows].max(), 0, MAX_PATH))
        if len(rows) * SUBSET_FRACTION > D:
            if kind is None:
                kind = op[:, 0].clamp(0, _LAST_KIND)
            s = _branch(s, op, payload, kd, kind == kd, n_steps)
            continue
        idx = torch.as_tensor(rows, device=op.device)
        sub = tree_map(lambda x: x.index_select(0, idx), s)
        act = torch.ones((len(rows),), dtype=torch.bool, device=op.device)
        sub = _branch(
            sub, op.index_select(0, idx), payload.index_select(0, idx), kd, act, n_steps
        )
        for x, y in zip(s, sub):
            x.index_copy_(0, idx, y)
    return s


def apply_nested_op(s: NestedForestState, op, payload) -> NestedForestState:
    """Apply one op per doc (``op[D, F]``, ``payload[D, L]``)."""
    return apply_nested_ops(s, _as_tensor(op, s.parent.device)[:, None],
                            _as_tensor(payload, s.parent.device)[:, None])


def apply_nested_ops(s: NestedForestState, ops, payloads, host_ops=None) -> NestedForestState:
    """Apply ``ops[D, B, F]`` (+ ``payloads[D, B, L]``) to a [D, ...] batch,
    in order along B.  ``host_ops``: the same ring as host numpy, when the
    caller has it (saves a device read of the kinds and depths)."""
    count_launch(s.parent, apply_nested_megastep)
    return _apply_ring(s, ops[None], payloads[None],
                       None if host_ops is None else np.asarray(host_ops)[None])


def apply_nested_megastep(s: NestedForestState, ops, payloads, host_ops=None) -> NestedForestState:
    """K7: apply a ``[K, D, B]`` op ring to a [D, ...] forest batch, the K
    slices in order against the carried state (bit-identical to K
    sequential ``apply_nested_ops`` calls).  Error bits latch per doc for
    one readback by the caller."""
    count_launch(s.parent, apply_nested_megastep)
    return _apply_ring(s, ops, payloads, host_ops)


apply_nested_megastep.launches = 0


def _apply_ring(s: NestedForestState, ops, payloads, host_ops) -> NestedForestState:
    dev = s.parent.device
    kinds, depths = _ring_info(ops, host_ops)
    ops = _as_tensor(ops, dev)
    payloads = _as_tensor(payloads, dev)
    s = _own(s)
    for k in range(ops.shape[0]):
        for b in range(ops.shape[2]):
            s = _apply_pos(s, ops[k, :, b], payloads[k, :, b], kinds[k, :, b], depths[k, :, b])
    return s


# ------------------------------------------------------------ K8: compact

def compact_nested(s: NestedForestState) -> NestedForestState:
    """K8: drop dead rows — a stable gather of the live rows to the prefix
    plus a parent remap — and pack the live pooled spans to the front of
    the word pool, rewriting the value offsets.  Precondition (the engine's
    states hold it): ``vlen >= 0`` on live pooled rows."""
    count_launch(s.parent, compact_nested)
    D, N = s.parent.shape
    P = s.pool.shape[-1]
    dev = s.parent.device
    alive = s.alive == 1
    new_id = alive.cumsum(-1, dtype=I32) - 1                # old row -> new row
    n_alive = alive.sum(-1, dtype=I32)
    order = torch.argsort((~alive).to(torch.uint8), dim=-1, stable=True)
    take = torch.arange(N, device=dev) < n_alive[:, None]

    def g(col, fill=0):
        return torch.where(take, col.gather(1, order), fill)

    old_parent = s.parent.gather(1, order)
    remapped = new_id.gather(1, old_parent.clamp(0, N - 1).long())
    parent = torch.where(old_parent < 0, -1, remapped)

    value_g, vkind_g, vlen_g = g(s.value), g(s.vkind), g(s.vlen)
    pooled = take & _is_pooled(vkind_g)
    span = torch.where(pooled, vlen_g, 0)                    # words owned
    ends = span.cumsum(-1, dtype=I32)                        # inclusive ends
    new_off = ends - span                                    # exclusive starts
    total = ends[:, -1] if N > 0 else torch.zeros((D,), dtype=I32, device=dev)
    t = torch.arange(P, dtype=I32, device=dev).expand(D, P).contiguous()
    # The packed row that owns output word t; its old offset plus t's place
    # inside the span is the source word.
    r = torch.searchsorted(ends, t, right=True).clamp(0, N - 1)
    src = value_g.gather(1, r) + (t - new_off.gather(1, r))
    pool = torch.where(t < total[:, None], s.pool.gather(1, src.clamp(0, P - 1).long()), 0)
    return NestedForestState(
        parent=torch.where(take, parent, -1),
        field_id=g(s.field_id), index=g(s.index), ntype=g(s.ntype),
        value=torch.where(pooled, new_off, value_g), vkind=vkind_g, vlen=vlen_g,
        val_seq=g(s.val_seq),
        alive=take.to(I32),
        pool=pool,
        pool_end=total,
        nrow=n_alive,
        error=s.error.clone(),
    )


compact_nested.launches = 0


# ------------------------------------------------------------ host views

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def nested_to_json(s: NestedForestState, field_names: dict[int, str],
                   type_names: dict[int, str]) -> list[dict]:
    """One document's columns (1-D leaves) as the host forest's root-field
    JSON (``forest.Node.to_json`` shape)."""
    nrow = int(_host(s.nrow))
    parent, field_id, index, ntype, value, vkind, vlen, alive = (
        _host(c)[:nrow]
        for c in (s.parent, s.field_id, s.index, s.ntype, s.value, s.vkind, s.vlen, s.alive)
    )
    pool = _host(s.pool)

    # parent -> {field -> [(index, row)]}: one O(N) pass, O(1) per lookup.
    children: dict[int, dict[int, list[tuple[int, int]]]] = {}
    for r in range(nrow):
        if alive[r]:
            children.setdefault(int(parent[r]), {}).setdefault(
                int(field_id[r]), []
            ).append((int(index[r]), r))

    def node_json(r: int) -> dict:
        out: dict = {"t": type_names[int(ntype[r])]}
        v = decode_pooled_value(int(vkind[r]), int(value[r]), int(vlen[r]), pool)
        if v is not None:
            out["v"] = v
        fields = {
            field_names[f]: [node_json(cr) for _i, cr in sorted(rows)]
            for f, rows in children.get(r, {}).items()
        }
        if fields:
            out["f"] = fields
        return out

    return [node_json(r) for _i, r in sorted(children.get(-1, {}).get(0, []))]


def decode_pooled_value(vkind: int, value: int, vlen: int, pool: np.ndarray):
    """Host decode of one row's value columns back to the Python leaf."""
    if vkind == VKIND_INT:
        return int(value)
    if vkind == VKIND_BOOL:
        return bool(value)
    if vkind == VKIND_STR:
        return "".join(chr(int(c)) for c in pool[value : value + vlen])
    if vkind == VKIND_F64:
        lo, hi = int(pool[value]) & 0xFFFFFFFF, int(pool[value + 1]) & 0xFFFFFFFF
        return struct.unpack("<d", struct.pack("<II", lo, hi))[0]
    return None


def encode_pooled_words(v) -> tuple[int, int, list[int] | None]:
    """Python leaf -> (vkind, inline value-or-wordcount, pool words).

    Inverse of ``decode_pooled_value``; bool before int (bool is an int
    subclass), f64 as its two little-endian int32 halves, str as
    codepoints.  Raises ValueError for values the columns cannot carry
    (out-of-int32-range ints, other types): callers route those documents
    to their host fallback."""
    if v is None:
        return VKIND_NONE, 0, None
    if isinstance(v, bool):
        return VKIND_BOOL, int(v), None
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return VKIND_INT, v, None
        raise ValueError(f"int leaf out of int32 range: {v!r}")
    if isinstance(v, float):
        lo, hi = struct.unpack("<ii", struct.pack("<d", v))
        return VKIND_F64, 2, [lo, hi]
    if isinstance(v, str):
        return VKIND_STR, len(v), [ord(c) for c in v]
    raise ValueError(f"unsupported leaf value type: {v!r}")


# ------------------------------------------------------- the rebase window (K9)
#
# The EditManager window fold on integer columns (reference
# ``rebase_window_kernel``): one incoming single-change commit ``c`` folds
# through a window of C in-flight entries ``xs``, each step the mirrored
# bridge pair rebase_pair(c, x) on padded mark columns.  Object payloads
# never ride the columns: every output mark carries a source-index range
# into its ORIGINAL commit's marks (composed across steps for the carried
# c), and the host decode re-attaches payloads from those handles.  What
# the columns cannot express (Modify-vs-Modify collisions, out-of-order
# placements, output overflow, detached-payload Removes that shift) sets a
# per-step invalid flag; the first invalid or ineligible step kills every
# later one, and the host finishes that suffix on the pooled fold.
#
# This is the plain form, batched over a leading window axis W and walking
# the C steps in order: every encoding field carries [W, ...] (the window's
# entries [W, C, ...]).  ``ops/rebase_kernel.py`` holds the hand CUDA
# kernel of the same function and its packed-row wrapper.

REBASE_MAX_MARKS = 12   # M: widest leaf mark list a window entry may carry
REBASE_MAX_DEPTH = 4    # PD: deepest interior [Skip, Modify] path

# Device mark codes (``protocol/mark_schema.py`` ``TreeMarkKind``).
_NOOP, _SKIP, _INSERT, _REMOVE, _MODIFY = 0, 1, 2, 3, 4


class RebaseEnc(NamedTuple):
    """Device encoding of one eligible single-change pooled Commit, with a
    leading window axis: ``dep`` and ``n`` are [W], every other field
    [W, PD(+1)] or [W, M].

    Interior levels 0..dep-1 are exactly [Skip(pos[l]), Modify] chains
    (the nested-commit wire norm); level ``dep`` is the leaf: a flat mark
    list over field ``fld[dep]``, or a value-only NodeChange when
    ``fld[dep] < 0``.  ``val[l]`` flags a value overwrite at level l.
    ``slo/shi`` map each leaf mark to its source-index range in the
    ORIGINAL commit's columns — the object-payload handles."""

    dep: torch.Tensor   # [W]          number of interior levels
    fld: torch.Tensor   # [W, PD+1]    interned field ids; fld[dep] < 0 = value leaf
    pos: torch.Tensor   # [W, PD]      interior skip offsets
    val: torch.Tensor   # [W, PD+1]    value-present flags
    kind: torch.Tensor  # [W, M]       leaf device-coded kinds (0 pads)
    cnt: torch.Tensor   # [W, M]       leaf counts
    det: torch.Tensor   # [W, M]       Remove-with-detached flags
    n: torch.Tensor     # [W]          live leaf marks
    slo: torch.Tensor   # [W, M]       source range lo (original mark index)
    shi: torch.Tensor   # [W, M]       source range hi (inclusive)


class _LegOut(NamedTuple):
    kind: torch.Tensor   # [W, M] rebased mark kinds
    cnt: torch.Tensor    # [W, M]
    lo: torch.Tensor     # [W, M] source range into the leg's own input marks
    hi: torch.Tensor     # [W, M]
    n: torch.Tensor      # [W]
    bad: torch.Tensor    # [W] bool: collision / out-of-order / overflow
    ident: torch.Tensor  # [W] bool: output columnar-equal to the input


class RebaseStepOut(NamedTuple):
    valid: torch.Tensor   # [W, C] bool: this step's result is usable
    id_c: torch.Tensor    # [W, C] bool: c came through bit-identical
    id_x: torch.Tensor    # [W, C] bool: x came through bit-identical
    x: RebaseEnc          # rebased window entries (src into their own marks)
    stage: RebaseEnc      # c after each step (src into the ORIGINAL c)
    x_drop: torch.Tensor  # [W, C, PD+1] int32 value-LWW drops applied to x


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum over the last axis (jnp keeps int32)."""
    return torch.cumsum(x, -1, dtype=I32)


def _gat(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row ``x[w, idx[w, ...]]`` with the index clamped into range."""
    return x.gather(-1, idx.clamp(0, x.shape[-1] - 1).long())


def _cons(k: torch.Tensor, c: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``c`` where the kind is ``a`` or ``b``, 1 at a Modify, else 0."""
    return torch.where((k == a) | (k == b), c, (k == _MODIFY).to(I32))


def _flat_leg(ak, ac, bk, bc, a_after: bool) -> _LegOut:
    """One bridge leg over flat move-free columns [W, M]: rebase a over b.

    Byte-matches mark_pool._rebase_cols: fate runs for b, per-a-mark
    placements, and the sorted gap-and-coalesce emission as one masked
    program."""
    W, M = ak.shape
    dev = ak.device
    a_live = ak != _NOOP
    b_live = bk != _NOOP

    # --- phase 1: fate-run decomposition of b ------------------------------
    consB = _cons(bk, bc, _SKIP, _REMOVE)
    prodB = _cons(bk, bc, _SKIP, _INSERT)
    inE = _csum(consB)
    inS = inE - consB
    outS = _csum(prodB) - prodB
    tail_in = consB.sum(-1, dtype=I32)[:, None]
    tail_out = prodB.sum(-1, dtype=I32)[:, None]
    goneB = b_live & (bk == _REMOVE)
    modB = b_live & (bk == _MODIFY)
    runB = b_live & (consB > 0)

    consA = _cons(ak, ac, _SKIP, _REMOVE)
    a_in = _csum(consA) - consA

    # --- insert-boundary placement (the sided boundary map) ----------------
    p = a_in[:, :, None]                                  # [W, M, 1]
    inS_, inE_, outS_ = inS[:, None, :], inE[:, None, :], outS[:, None, :]
    covB = runB[:, None, :] & (inS_ < p) & (p <= inE_)
    before_run = torch.where(goneB[:, None, :], outS_, outS_ + (p - inS_))
    has_cov = covB.any(-1)
    before = torch.where(covB, before_run, 0).sum(-1, dtype=I32)
    before = torch.where(
        a_in == 0, 0, torch.where(has_cov, before, tail_out + (a_in - tail_in))
    ).to(I32)
    if a_after:
        prods_at = torch.where(
            ((bk == _INSERT) & b_live)[:, None, :] & (inS_ == p), bc[:, None, :], 0
        ).sum(-1, dtype=I32)
        bp = before + prods_at
    else:
        bp = before

    # --- phase 2: node placement as batched segment intersection -----------
    isnode = a_live & ((ak == _REMOVE) | (ak == _MODIFY))
    modA = a_live & (ak == _MODIFY)
    e_a = a_in + consA
    lo = torch.maximum(p, inS_)
    hi = torch.minimum(e_a[:, :, None], inE_)
    overlap = runB[:, None, :] & (hi > lo)
    seg_ok = overlap & isnode[:, :, None] & ~goneB[:, None, :]
    seg_pos = outS_ + (lo - inS_)
    seg_cnt = hi - lo
    coll = (modA[:, :, None] & modB[:, None, :] & overlap).flatten(1).any(-1)
    tlo = torch.maximum(a_in, tail_in)
    tail_ok = isnode & (e_a > tlo)
    tail_pos = tail_out + (tlo - tail_in)
    tail_cnt = e_a - tlo

    # --- atom table: (a-mark j) x (insert | b-run segs | tail), row-major ---
    NS = M + 2
    T = M * NS
    ins_ok = a_live & (ak == _INSERT)
    atom_ok = torch.cat([ins_ok[..., None], seg_ok, tail_ok[..., None]], -1)
    pos_f = torch.cat([bp[..., None], seg_pos, tail_pos[..., None]], -1).reshape(W, T)
    cnt_f = torch.cat([ac[..., None], seg_cnt, tail_cnt[..., None]], -1).reshape(W, T)
    kk = ak[:, :, None].expand(W, M, NS).reshape(W, T)
    j_f = torch.arange(M, dtype=I32, device=dev)[:, None].expand(M, NS).reshape(T)

    # --- phase 3: coalescing emission as prefix passes ----------------------
    ok0 = atom_ok.reshape(W, T) & (cnt_f > 0)
    mc = torch.where(ok0, cnt_f, 0)
    consumed = torch.where(kk == _REMOVE, cnt_f, (kk == _MODIFY).to(I32))
    end_f = pos_f + consumed
    ar = torch.arange(T, dtype=I32, device=dev).expand(W, T)
    lastok = torch.cummax(torch.where(ok0, ar, -1), -1).values
    prev_idx = torch.cat([torch.full((W, 1), -1, dtype=I32, device=dev), lastok[:, :-1]], -1)
    has_prev = prev_idx >= 0
    gap = pos_f - torch.where(has_prev, _gat(end_f, prev_idx), 0)
    prev_kind = torch.where(has_prev, _gat(kk, prev_idx), _NOOP)
    merge = ok0 & (prev_kind == kk) & (gap == 0) & ((kk == _REMOVE) | (kk == _INSERT))
    start = ok0 & ~merge
    wskip = start & (gap > 0)
    grp = _csum(start.to(I32))
    nsk = _csum(wskip.to(I32))
    csum = _csum(mc)
    nsa = torch.cummin(torch.where(start, ar, T).flip(-1), -1).values.flip(-1)
    gend = torch.minimum(
        torch.cat([nsa[:, 1:], torch.full((W, 1), T, dtype=I32, device=dev)], -1) - 1,
        torch.full((), T - 1, dtype=I32, device=dev),
    )
    gsum = _gat(csum, gend) - csum + mc
    ghi = _gat(torch.cummax(torch.where(ok0, j_f, -1), -1).values, gend)
    slot = (grp - 1 + nsk).contiguous()
    out_n = grp[:, -1] + nsk[:, -1]
    srange = torch.arange(M, dtype=I32, device=dev).expand(W, M).contiguous()
    hit = torch.searchsorted(slot, srange, right=False).clamp(max=T - 1)
    sl = slot.gather(-1, hit)
    is_mark = start.gather(-1, hit) & (sl == srange)
    is_skip = wskip.gather(-1, hit) & (sl == srange + 1)
    ok_k = torch.where(is_mark, kk.gather(-1, hit), torch.where(is_skip, _SKIP, 0)).to(I32)
    ok_c = torch.where(is_mark, gsum.gather(-1, hit), torch.where(is_skip, gap.gather(-1, hit), 0)).to(I32)
    ok_lo = torch.where(is_mark, j_f[hit], 0).to(I32)
    ok_hi = torch.where(is_mark, ghi.gather(-1, hit), 0).to(I32)
    bad = coll | (ok0 & (gap < 0)).any(-1) | (out_n > M)
    a_n = a_live.sum(-1, dtype=I32)
    ident = (out_n == a_n) & (ok_k == ak).all(-1) & (ok_c == ac).all(-1)
    return _LegOut(ok_k, ok_c, ok_lo, ok_hi, out_n.to(I32), bad, ident)


def _synth_interior(p: torch.Tensor):
    """[Skip(p), Modify] (or [Modify] at p == 0) as padded [W, M] columns."""
    W = p.shape[0]
    M = REBASE_MAX_MARKS
    kind = torch.zeros((W, M), dtype=I32, device=p.device)
    cnt = torch.zeros_like(kind)
    pos = p > 0
    kind[:, 0] = torch.where(pos, _SKIP, _MODIFY)
    kind[:, 1] = torch.where(pos, _MODIFY, _NOOP)
    cnt[:, 0] = torch.where(pos, p, 1)
    cnt[:, 1] = pos.to(I32)
    return kind, cnt


def _pick(f: torch.Tensor, a: RebaseEnc, b: RebaseEnc) -> RebaseEnc:
    """Field-wise ``where(f, a, b)`` with ``f`` [W] (every field, ``fld``
    included, as the reference's ``tree_map``)."""
    return RebaseEnc(*(
        torch.where(f.view(-1, *([1] * (u.dim() - 1))), u, v) for u, v in zip(a, b)
    ))


def _pair_step(c: RebaseEnc, x: RebaseEnc, elig: torch.Tensor):
    """One mirrored bridge pair rebase_pair(c, x) on [W] encodings.

    Walks the common interior path to the divergence level, then either
    short-circuits (disjoint fields / positions / value-only leaves — the
    identity mask) or runs both flat legs at the diverging field.  Returns
    (c', the step's outputs)."""
    PD = REBASE_MAX_DEPTH
    M = REBASE_MAX_MARKS
    dev = c.dep.device
    li = torch.arange(PD, dtype=I32, device=dev)
    match = (li < c.dep[:, None]) & (li < x.dep[:, None]) & \
        (c.fld[:, :PD] == x.fld[:, :PD]) & (c.pos == x.pos)
    lstar = torch.cumprod(match.to(I32), -1).sum(-1, dtype=I32)
    c_int = lstar < c.dep
    x_int = lstar < x.dep
    f_c = _gat(c.fld, lstar[:, None])[:, 0]
    f_x = _gat(x.fld, lstar[:, None])[:, 0]
    case_d = (f_c < 0) | (f_x < 0)
    case_a = ~case_d & (f_c != f_x)
    engage = ~case_d & ~case_a & ~(c_int & x_int)

    lp = torch.clamp(lstar, max=PD - 1)[:, None]
    pc = _gat(c.pos, lp)[:, 0]
    px = _gat(x.pos, lp)[:, 0]
    sk_c, sc_c = _synth_interior(pc)
    sk_x, sc_x = _synth_interior(px)
    Ak = torch.where(c_int[:, None], sk_c, c.kind)
    Ac = torch.where(c_int[:, None], sc_c, c.cnt)
    Bk = torch.where(x_int[:, None], sk_x, x.kind)
    Bc = torch.where(x_int[:, None], sc_x, x.cnt)

    legC = _flat_leg(Ak, Ac, Bk, Bc, a_after=True)
    legX = _flat_leg(Bk, Bc, Ak, Ac, a_after=False)

    # detached-payload Removes may pass through untouched, never transform
    det_c = ~c_int & (c.det > 0).any(-1) & ~legC.ident
    det_x = ~x_int & (x.det > 0).any(-1) & ~legX.ident
    step_bad = engage & (legC.bad | legX.bad | det_c | det_x)
    step_ok = elig & ~step_bad

    # value LWW along the shared spine (levels 0..lstar)
    lvl = torch.arange(PD + 1, dtype=I32, device=dev)
    drop_x = (c.val > 0) & (x.val > 0) & (lvl <= lstar[:, None])

    # interior fate: did the synthesized Modify survive, and where?
    mi = torch.arange(M, dtype=I32, device=dev)
    surv_c = ((legC.kind == _MODIFY) & (mi < legC.n[:, None])).any(-1)
    surv_x = ((legX.kind == _MODIFY) & (mi < legX.n[:, None])).any(-1)
    npos_c = torch.where(legC.kind[:, 0] == _SKIP, legC.cnt[:, 0], 0)
    npos_x = torch.where(legX.kind[:, 0] == _SKIP, legX.cnt[:, 0], 0)

    def rebuild(side: RebaseEnc, leg: _LegOut, is_int, surv, npos, drops):
        trunc = (is_int & ~surv)[:, None]
        t_dep = torch.where(is_int & ~surv, lstar, side.dep)
        t_pos = torch.where((is_int & surv)[:, None] & (li == lstar[:, None]),
                            npos[:, None], side.pos)
        t_val = torch.where((lvl <= t_dep[:, None]) & ~drops, side.val, 0)
        glo = _gat(side.slo, leg.lo)
        ghi = _gat(side.shi, leg.hi)
        live = mi < leg.n[:, None]
        leaf = ~is_int[:, None]
        t_kind = torch.where(leaf, torch.where(live, leg.kind, 0), side.kind)
        t_cnt = torch.where(leaf, torch.where(live, leg.cnt, 0), side.cnt)
        t_det = torch.where(leaf, torch.where(
            live & (leg.kind == _REMOVE), _gat(side.det, leg.lo), 0), side.det)
        t_n = torch.where(~is_int, leg.n, torch.where(is_int & ~surv, 0, side.n))
        t_slo = torch.where(leaf, torch.where(live, glo, 0), side.slo)
        t_shi = torch.where(leaf, torch.where(live, ghi, 0), side.shi)
        z = lambda t: torch.where(trunc, 0, t).to(I32)
        return RebaseEnc(t_dep.to(I32), side.fld, t_pos.to(I32), t_val.to(I32),
                         z(t_kind), z(t_cnt), z(t_det), t_n.to(I32), z(t_slo), z(t_shi))

    changed_c = engage & torch.where(c_int, ~(surv_c & (npos_c == pc)), ~legC.ident)
    changed_x = engage & torch.where(x_int, ~(surv_x & (npos_x == px)), ~legX.ident)

    new_c = rebuild(c, legC, c_int, surv_c, npos_c, torch.zeros_like(drop_x))
    new_x = rebuild(x, legX, x_int, surv_x, npos_x, drop_x)

    out_c = _pick(step_ok & engage & changed_c, new_c, c)
    # x's value drops apply in EVERY case; marks only when the pair engaged
    base_x = x._replace(val=torch.where(drop_x, 0, x.val).to(I32))
    out_x = _pick(step_ok & engage & changed_x, new_x, base_x)

    any_drop = (drop_x & (x.val > 0)).any(-1)
    id_c = step_ok & ~(engage & changed_c)
    id_x = step_ok & ~(engage & changed_x) & ~any_drop
    return out_c, (step_ok, id_c, id_x, out_x, out_c, drop_x.to(I32))


def rebase_window_kernel(c: RebaseEnc, xs: RebaseEnc, elig: torch.Tensor):
    """Fold W incoming commits through their windows: ``c`` fields [W, ...],
    ``xs`` fields [W, C, ...], ``elig`` [W, C] gating each step (the host
    pads windows and marks host-only entries ineligible).  Prefix validity:
    the first bad or ineligible step kills every later step's ``valid``
    bit.  Returns (final c, per-step ``RebaseStepOut`` with [W, C] leading
    axes).  The plain form of K9: the C steps in order, each masked over
    the W windows (the reference's ``rebase_window_jit`` is W = 1, its
    ``rebase_window_batched`` any W)."""
    C = elig.shape[1]
    elig = elig.to(torch.bool)
    dead = torch.zeros_like(elig[:, 0])
    steps = []
    for i in range(C):
        x = RebaseEnc(*(f[:, i] for f in xs))
        c, out = _pair_step(c, x, elig[:, i] & ~dead)
        dead = dead | ~out[0]
        steps.append(out)
    cols = list(zip(*steps))
    stack = lambda ts: torch.stack(ts, 1)
    encs = lambda es: RebaseEnc(*(stack(f) for f in zip(*es)))
    return c, RebaseStepOut(stack(cols[0]), stack(cols[1]), stack(cols[2]),
                            encs(cols[3]), encs(cols[4]), stack(cols[5]))


def rebase_flat_pair_kernel(ak, ac, bk, bc):
    """Both bridge legs of one flat pair, [M] columns (differential-test
    surface)."""
    strip = lambda leg: _LegOut(*(f[0] for f in leg))
    a = (ak[None], ac[None], bk[None], bc[None])
    return (strip(_flat_leg(*a, a_after=True)),
            strip(_flat_leg(a[2], a[3], a[0], a[1], a_after=False)))


def rebase_enc_from_numpy(enc, device=DEFAULT_DEVICE) -> RebaseEnc:
    """A ``RebaseEnc`` from numpy-readable fields in ``RebaseEnc`` order (a
    reference encoding read with ``np.asarray``), as int32 tensors."""
    dev = resolve_device(device)
    return RebaseEnc(*(torch.as_tensor(np.array(f, np.int32)).to(dev) for f in enc))


# ------------------------------------------------- K11: the flat forest
# Counterpart of the first part of the reference module (:46-331): the
# rebase position arithmetic over one change's [M] mark columns, the LWW
# value chunk, and ``ForestState``, one document's root field of uniform
# leaves as device state, mutated by trunk-coordinate ops.  Plain torch on
# an explicit device, exact against the jnp functions on the raw columns
# and the error latch:
#
# - sums and cumsums are taken back to int32 (``jnp`` keeps int32 and
#   wraps);
# - the reference's gathers clamp (``_take``), its ``.at[pos].set`` wraps
#   a negative index once and drops what is still out of range, and its
#   ``mode="drop"`` scatters drop: the port's scatters write into one
#   extra trailing slot that is cut off;
# - ``lax.switch`` over the op kind (kinds clamped into [0, 4]) and the
#   ``lax.cond`` guards become every branch computed and one
#   ``torch.where`` on the kind and the guard: no host read per op.
#
# Every function works on a leading doc axis ([D, N] columns, [D]
# scalars); the one-doc entry points are that axis at 1, and the
# ``*_fleet`` forms are what ``jax.vmap`` gives the reference's callers.
# Each public entry point that runs device work counts one launch on its
# own ``launches`` when its input lives on a CUDA device.

FOREST_OP_FIELDS = 8
# Forest op row layout (int32[8]):
#   0 kind | 1 seq | 2 pos | 3 count | 4 dst | 5 value | 6..7 unused


class ForestOpKind:
    NOOP = 0
    INSERT = 1   # count nodes at pos, values from the payload row
    REMOVE = 2   # count nodes at pos
    SET = 3      # value at pos
    MOVE = 4     # count nodes from pos to boundary dst (pre-move coords)


def encode_marks(marks, max_marks: int) -> tuple[np.ndarray, np.ndarray]:
    """Columnar encode a host mark list (changeset.py Mark objects) to
    (kinds[M], counts[M]) int32 arrays. Insert counts are content lengths.

    Dispatches on the protocol mark-schema class tag ``m.K`` — no upward
    import of the dds changeset classes."""
    kinds = np.zeros((max_marks,), np.int32)
    counts = np.zeros((max_marks,), np.int32)
    assert len(marks) <= max_marks, "mark list exceeds kernel width"
    for i, m in enumerate(marks):
        k = m.K
        if k == K_SKIP:
            kinds[i], counts[i] = TreeMarkKind.SKIP, m.count
        elif k == K_INSERT:
            kinds[i], counts[i] = TreeMarkKind.INSERT, len(m.content)
        elif k == K_REMOVE:
            kinds[i], counts[i] = TreeMarkKind.REMOVE, m.count
        elif k == K_MODIFY:
            kinds[i], counts[i] = TreeMarkKind.MODIFY, 1
        else:
            raise TypeError(m)
    return kinds, counts


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., clip(idx, 0, n - 1)]`` along the last axis: the reference's
    gathers clip their index (or read only non-negative ones, which a jnp
    gather clamps high)."""
    n = x.shape[-1]
    idx = idx.clamp(0, n - 1).long()
    if idx.dim() < x.dim():
        idx = idx.expand(x.shape[:-1] + idx.shape[-1:])
    return x.gather(-1, idx)


def _mark_geometry(kinds: torch.Tensor, counts: torch.Tensor):
    """Per-mark input-space start offsets and effect sizes.

    input-consuming marks: SKIP/REMOVE consume `count`, MODIFY consumes 1,
    INSERT consumes 0. Returns (in_start[M], ins_len[M], rm_len[M])."""
    consumed = torch.where(
        (kinds == TreeMarkKind.SKIP) | (kinds == TreeMarkKind.REMOVE),
        counts,
        (kinds == TreeMarkKind.MODIFY).to(I32),
    )
    in_start = torch.cumsum(consumed, -1, dtype=I32) - consumed
    ins_len = torch.where(kinds == TreeMarkKind.INSERT, counts, 0)
    rm_len = torch.where(kinds == TreeMarkKind.REMOVE, counts, 0)
    return in_start, ins_len, rm_len


def _rm_below(p: torch.Tensor, in_start, rm_len) -> torch.Tensor:
    """``jnp.clip(p - in_start, 0, rm_len)``: max then min, whatever the
    bounds' order."""
    return torch.minimum((p - in_start.unsqueeze(-2)).clamp_min(0), rm_len.unsqueeze(-2))


def _marks_on(positions, b_kinds, b_counts, device, fn):
    dev = resolve_device(device)
    p, k, c = (_as_tensor(x, dev) for x in (positions, b_kinds, b_counts))
    count_launch(p, fn)
    return p, k, c


def rebase_insert_positions(positions, b_kinds, b_counts, a_after: bool,
                            device=DEFAULT_DEVICE) -> torch.Tensor:
    """Where does each pending INSERT land after change b applies?
    (``positions[..., B]``, ``b_kinds``/``b_counts[..., M]``, int32.)

    Mirrors rebase_marks for a = [Skip(p), Insert(..)]: b's removes pull the
    boundary to the range start; b's inserts at the same boundary shift the
    pending insert right iff the pending one is the later-sequenced side
    (a_after=True, the >= mask) — the host tie-break contract."""
    positions, b_kinds, b_counts = _marks_on(
        positions, b_kinds, b_counts, device, rebase_insert_positions)
    in_start, ins_len, rm_len = _mark_geometry(b_kinds, b_counts)
    p = positions.unsqueeze(-1)  # [B, 1]
    ins_at = in_start.unsqueeze(-2)
    hit = (p >= ins_at) if a_after else (p > ins_at)
    shift = torch.where(hit, ins_len.unsqueeze(-2), 0)
    return (positions + shift.sum(-1, dtype=I32)
            - _rm_below(p, in_start, rm_len).sum(-1, dtype=I32))


rebase_insert_positions.launches = 0


def rebase_node_positions(positions, b_kinds, b_counts,
                          device=DEFAULT_DEVICE) -> tuple[torch.Tensor, torch.Tensor]:
    """Where does each targeted NODE land after change b — and does it
    survive? Mirrors rebase_marks for a = [Skip(p), Modify/Remove(1)]:
    a node inside a b-removed range is dropped (mask 0)."""
    positions, b_kinds, b_counts = _marks_on(
        positions, b_kinds, b_counts, device, rebase_node_positions)
    in_start, ins_len, rm_len = _mark_geometry(b_kinds, b_counts)
    p = positions.unsqueeze(-1)
    at = in_start.unsqueeze(-2)
    # Node positions: a b-insert AT the node's index lands before it (the
    # node's content moves right) — always the >= mask for occupied slots.
    shift = torch.where(p >= at, ins_len.unsqueeze(-2), 0)
    dropped = ((rm_len.unsqueeze(-2) > 0) & (p >= at)
               & (p < (in_start + rm_len).unsqueeze(-2))).any(-1)
    out = (positions + shift.sum(-1, dtype=I32)
           - _rm_below(p, in_start, rm_len).sum(-1, dtype=I32))
    return out, (~dropped).to(I32)


rebase_node_positions.launches = 0


class ChunkState(NamedTuple):
    """One numeric column of a uniform chunk, with per-row attribution."""

    values: torch.Tensor   # int32[N] ([D, N] batched)
    val_seq: torch.Tensor  # int32[N] seq of winning write


def init_chunk(values, device=DEFAULT_DEVICE) -> ChunkState:
    v = _as_tensor(values, resolve_device(device))
    return ChunkState(values=v, val_seq=torch.zeros_like(v))


def _value_sets(s: ChunkState, idx, vals, seqs) -> ChunkState:
    """The LWW pass over [D, N] columns and [D, B] writes."""
    D, n = s.values.shape
    dev = s.values.device
    idx, vals, seqs = (_as_tensor(x, dev) for x in (idx, vals, seqs))
    valid = idx >= 0
    # Lanes the reference's scatter drops (padding, idx >= n) go to slot n.
    tgt = torch.where(valid & (idx < n), idx, n).long()
    best = torch.zeros((D, n + 1), dtype=I32, device=dev).scatter_reduce_(
        1, tgt, torch.where(valid, seqs, 0), "amax")[:, :n]
    win = valid & (seqs == _take(best, torch.where(valid, idx, 0)))
    win_idx = torch.where(win, tgt, n)
    pad = torch.zeros((D, 1), dtype=I32, device=dev)
    values = torch.cat([s.values, pad], 1).scatter_(1, win_idx, vals)[:, :n]
    val_seq = torch.cat([s.val_seq, pad], 1).scatter_(1, win_idx, seqs)[:, :n]
    return ChunkState(values=values, val_seq=val_seq)


def apply_value_sets(s: ChunkState, idx, vals, seqs) -> ChunkState:
    """Apply a sequenced batch of value overwrites in ONE scatter pass: for
    rows hit multiple times the highest-seq write wins (LWW by total order),
    matching sequential host application exactly (``idx``/``vals``/``seqs``
    int32[B]; ``idx < 0`` pads; seqs distinct and > 0).

    Determinism: the winner per row is picked first with a commutative
    scatter-MAX of seqs, and only winning lanes scatter values."""
    count_launch(s.values, apply_value_sets)
    out = _value_sets(ChunkState(s.values[None], s.val_seq[None]),
                      *(_as_tensor(x, s.values.device)[None] for x in (idx, vals, seqs)))
    return ChunkState(out.values[0], out.val_seq[0])


apply_value_sets.launches = 0


def apply_value_sets_fleet(s: ChunkState, idx, vals, seqs) -> ChunkState:
    """``apply_value_sets`` over a doc axis: ``[D, N]`` columns, ``[D, B]``
    writes, one program."""
    count_launch(s.values, apply_value_sets_fleet)
    return _value_sets(s, idx, vals, seqs)


apply_value_sets_fleet.launches = 0


def batched_value_engine(n_docs: int):
    """The D-doc batched form (the reference's ``jit(vmap(apply_value_sets))``):
    a callable over ``[n_docs, N]`` states and ``[n_docs, B]`` writes."""

    def engine(s: ChunkState, idx, vals, seqs) -> ChunkState:
        if s.values.shape[0] != n_docs:
            raise ValueError(f"state has {s.values.shape[0]} docs, the engine {n_docs}")
        return apply_value_sets_fleet(s, idx, vals, seqs)

    return engine


class ForestState(NamedTuple):
    values: torch.Tensor   # int32[N] leaf value column ([D, N] batched)
    val_seq: torch.Tensor  # int32[N] seq of last write (attribution)
    nnode: torch.Tensor    # int32 scalar live node count ([D] batched)
    error: torch.Tensor    # int32 scalar bitmask


def init_forest(capacity: int = 1024, device=DEFAULT_DEVICE) -> ForestState:
    """One empty document on ``device``."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=dev)
    return ForestState(values=z(capacity), val_seq=z(capacity), nnode=z(), error=z())


def batch_forest(proto: ForestState, n_docs: int) -> ForestState:
    """``n_docs`` copies of a one-document forest, stacked on a doc axis."""
    return ForestState(*(x.unsqueeze(0).repeat((n_docs,) + (1,) * x.dim()) for x in proto))


def _forest_gather(s: ForestState, src: torch.Tensor, n_new) -> ForestState:
    """Rebuild the columns through a source-index map (-1 = fresh slot,
    filled by the caller afterwards)."""
    take = src >= 0
    return s._replace(
        values=torch.where(take, _take(s.values, src), 0),
        val_seq=torch.where(take, _take(s.val_seq, src), 0),
        nnode=n_new,
    )


def _forest_step(s: ForestState, op: torch.Tensor, payload: torch.Tensor) -> ForestState:
    """One op per doc over [D, N] columns (``op[D, 8]``, ``payload[D, P]``):
    the five ``lax.switch`` branches computed together, the committing one
    selected per doc."""
    N = s.values.shape[-1]
    kind = op[:, 0].clamp(0, ForestOpKind.MOVE)
    seq, pos, count, dst, value = (op[:, i:i + 1] for i in range(1, 6))
    n = s.nnode[:, None]
    idx = torch.arange(N, dtype=I32, device=op.device)[None]
    is_ins, is_rm, is_set, is_mv = (
        kind == k for k in (ForestOpKind.INSERT, ForestOpKind.REMOVE,
                            ForestOpKind.SET, ForestOpKind.MOVE))

    # INSERT: count fresh slots at pos, values from the payload row.
    over = (n + count > N)[:, 0]
    bad_ins = (pos > n)[:, 0]
    src_ins = torch.where(idx < pos, idx, torch.where(idx < pos + count, -1, idx - count))
    fresh = is_ins[:, None] & (idx >= pos) & (idx < pos + count)
    pay = _take(payload, idx - pos)
    # REMOVE: close the gap.
    bad_rm = (pos + count > n)[:, 0]
    src_rm = torch.where(idx < pos, idx, idx + count)
    # MOVE: the remove map composed with the insert map at the post-remove
    # boundary dst'.
    bad_mv = ((pos + count > n) | (dst > n))[:, 0]
    dstp = torch.where(dst > pos + count, dst - count, torch.minimum(dst, pos))
    in_block = (idx >= dstp) & (idx < dstp + count)
    u = torch.where(idx < dstp, idx, idx - count)      # rank among survivors
    surv = torch.where(u < pos, u, u + count)          # survivor rank -> old idx
    src_mv = torch.where(in_block, pos + (idx - dstp), surv)
    # SET: ``.at[pos].set`` wraps a negative pos once and drops the rest.
    bad_set = (pos >= n)[:, 0]
    at = torch.where(pos < 0, pos + N, pos)

    src = torch.where(is_ins[:, None], src_ins, torch.where(
        is_rm[:, None], src_rm, torch.where(is_mv[:, None], src_mv, idx)))
    n_new = torch.where(is_ins, s.nnode + count[:, 0],
                        torch.where(is_rm, s.nnode - count[:, 0], s.nnode))
    out = _forest_gather(s, src, n_new)
    hit = is_set[:, None] & (idx == at)
    values = torch.where(fresh, pay, torch.where(hit, value, out.values))
    val_seq = torch.where(fresh | hit, seq, out.val_seq)

    ok = ((is_ins & ~(over | bad_ins)) | (is_rm & ~bad_rm)
          | (is_set & ~bad_set) | (is_mv & ~bad_mv))
    fail_bits = torch.where(
        is_ins, over.to(I32) * ERR_NODE_OVERFLOW | bad_ins.to(I32) * ERR_FOREST_RANGE,
        (is_rm | is_set | is_mv).to(I32) * ERR_FOREST_RANGE)
    return ForestState(
        values=torch.where(ok[:, None], values, s.values),
        val_seq=torch.where(ok[:, None], val_seq, s.val_seq),
        nnode=torch.where(ok, out.nnode, s.nnode),
        error=s.error | torch.where(ok, 0, fail_bits),
    )


def _forest_ops(s: ForestState, ops, payloads) -> ForestState:
    """``ops[D, B, 8]`` in order along B (the reference's ``lax.scan``)."""
    dev = s.values.device
    ops, payloads = _as_tensor(ops, dev), _as_tensor(payloads, dev)
    for b in range(ops.shape[1]):
        s = _forest_step(s, ops[:, b], payloads[:, b])
    return s


def _one_doc(s: ForestState) -> ForestState:
    return ForestState(*(x[None] for x in s))


def _doc0(s: ForestState) -> ForestState:
    return ForestState(*(x[0] for x in s))


def apply_forest_op(s: ForestState, op, payload) -> ForestState:
    """Apply one trunk-coordinate structural/value op (``op[8]``,
    ``payload[P]``) to one document."""
    count_launch(s.values, apply_forest_op)
    dev = s.values.device
    return _doc0(_forest_step(_one_doc(s), _as_tensor(op, dev)[None],
                              _as_tensor(payload, dev)[None]))


apply_forest_op.launches = 0


def apply_forest_ops(s: ForestState, ops, payloads) -> ForestState:
    """Apply a [B]-op batch (``ops[B, 8]``, ``payloads[B, P]``) to one
    document in order; ``apply_forest_ops_fleet`` batches over docs."""
    count_launch(s.values, apply_forest_ops)
    dev = s.values.device
    return _doc0(_forest_ops(_one_doc(s), _as_tensor(ops, dev)[None],
                             _as_tensor(payloads, dev)[None]))


apply_forest_ops.launches = 0


def apply_forest_ops_fleet(s: ForestState, ops, payloads) -> ForestState:
    """``apply_forest_ops`` over a doc axis (the reference's
    ``vmap(apply_forest_ops)``): ``[D, N]`` columns, ``[D]`` scalars,
    ``ops[D, B, 8]``, ``payloads[D, B, P]``."""
    count_launch(s.values, apply_forest_ops_fleet)
    return _forest_ops(s, ops, payloads)


apply_forest_ops_fleet.launches = 0


def forest_values(s: ForestState) -> np.ndarray:
    """Host view of one document's live value column."""
    n = int(s.nnode)
    return s.values.cpu().numpy()[:n]
