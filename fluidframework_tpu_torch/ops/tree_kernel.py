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
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, count_launch, resolve_device

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
