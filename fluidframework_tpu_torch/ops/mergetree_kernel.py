"""Columnar merge-tree kernel in PyTorch: sequenced-op application.

Counterpart of ``fluidframework_tpu/ops/mergetree_kernel.py``, held byte
for byte against it (every raw state column, padding slots included, and
the per-doc error latch).  The state is the same flat int32 SoA; what
changes is the idiom:

- Every kernel function takes a state with an explicit leading doc axis
  (``[D, S]`` per-segment columns, ``[D]`` per-doc scalars) in place of
  ``vmap``, and Python loops walk the op ring in place of ``lax.scan``.
  ``init_state`` returns one document (as the reference does);
  ``batch_state`` stacks it to a fleet.
- ``lax.switch`` over the op kind becomes one masked pass per op kind
  present at that ring position: each branch folds the per-doc mask
  ``act = (kind == KIND)`` into every write it makes, so a doc whose op
  is another kind (or a NOOP) keeps every column unchanged.  The kinds
  come from the host-side ring, so a branch no doc uses at that position
  is skipped without a device sync.
- jnp's clamped gathers become ``_take`` (indices clamped into range), the
  dropped text scatter becomes a masked ``scatter_add_`` on the text pool,
  ``argmax`` first-hit rules become explicit index minima, and every
  cumsum/sum is taken back to int32 so int32 wrap matches.
- The text pool, and the rows of a branch run on a gathered subset of
  docs, are updated in place.  Every public apply entry copies what it
  updates in place once on entry, so the caller's state is never mutated.
- One document's programs (``apply_op``, reconnect's K5: ``restamp``,
  ``drop_squashed``, ``strip_stamp``) take unbatched leaves, as the
  reference's do; ``apply_op`` and ``drop_squashed`` run the batched code
  over a D = 1 batch (``one_doc_batch``).

The segment-parallel lane (``apply_megastep_seg``) routes its containment
searches through the K1 kernel (``ops.resolve_kernel``) and its named-axis
collectives through a shard group: ``StackedShardGroup`` when the lane's
shards are the leading axis of one stacked state on one device,
``ProcessShardGroup`` when each shard is one rank of a ``torch.distributed``
group (one rank a card).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, count_launch, resolve_device
from ..protocol.messages import SIDE_AFTER, SIDE_BEFORE
from ..protocol.stamps import ALL_ACKED, LOCAL_BASE, NO_REMOVE
from .resolve_kernel import resolve_positions

I32 = torch.int32
BIG = 2**31 - 1

# Error flag bits.
ERR_SEG_OVERFLOW = 1
ERR_TEXT_OVERFLOW = 2
ERR_REM_OVERFLOW = 4
ERR_POS_RANGE = 8
ERR_OB_OVERFLOW = 16

# Error classes the engine's recovery branches on: capacity bits are
# recoverable by growing the implicated axis and replaying; anything else
# (ERR_POS_RANGE alone) means the op stream itself is malformed and the
# document leaves the device batch (quarantine).
ERR_CAPACITY_MASK = (
    ERR_SEG_OVERFLOW | ERR_TEXT_OVERFLOW | ERR_REM_OVERFLOW | ERR_OB_OVERFLOW
)


def is_capacity_error(bits: int) -> bool:
    """True iff the latched bits are recoverable by growth + replay (any
    capacity bit: ERR_POS_RANGE beside one is usually a cascade that
    replay at grown capacity resolves)."""
    return bits != 0 and (bits & ERR_CAPACITY_MASK) != 0


def is_poison_error(bits: int) -> bool:
    """True iff the bits indicate a malformed op stream (quarantine lane)."""
    return bits != 0 and (bits & ERR_CAPACITY_MASK) == 0

# Marker codepoints (the reserved plane of dds/markers.py, a protocol
# contract): positions but no text in the host text view.
from ..protocol.marker_plane import MARKER_CP_BASE, MARKER_CP_END  # noqa: E402


class OpKind:
    NOOP = 0
    INSERT = 1
    REMOVE = 2
    ANNOTATE = 3
    ACK = 4
    OBLITERATE = 5  # always sided: plain {pos1,pos2} encodes as (pos1,B)..(pos2-1,A)


# Op row layout (int32[OP_FIELDS]):
#   0 kind | 1 key | 2 client | 3 ref_seq | 4 pos1 | 5 pos2 | 6 a | 7 b
# a/b meaning per kind: INSERT a=text_len, REMOVE -, ANNOTATE a=prop_slot
# b=value, ACK a=local_seq b=seq, OBLITERATE a=side1 b=side2.
OP_FIELDS = 8


class DocState(NamedTuple):
    """SoA replica state for one document, or [D, ...] for a doc batch."""

    text: torch.Tensor         # int32[T] codepoint pool (append-only)
    text_end: torch.Tensor     # int32 scalar
    nseg: torch.Tensor         # int32 scalar: live segment count
    seg_start: torch.Tensor    # int32[S] offset into text pool
    seg_len: torch.Tensor      # int32[S]
    ins_key: torch.Tensor      # int32[S] insert stamp key
    ins_client: torch.Tensor   # int32[S] insert short client id
    seg_uid: torch.Tensor      # int32[S] stable identity (obliterate anchors)
    seg_obpre: torch.Tensor    # int32[S] newest concurrent ob key at insert (-1)
    rem_keys: tuple            # R x int32[S] remove stamp keys (NO_REMOVE empty)
    rem_clients: tuple         # R x int32[S]
    prop_keys: tuple           # P x int32[S] LWW stamp key per prop (-1 unset)
    prop_vals: tuple           # P x int32[S]
    uid_next: torch.Tensor     # int32 scalar
    ob_key: torch.Tensor       # int32[OB]
    ob_client: torch.Tensor    # int32[OB]
    ob_start_uid: torch.Tensor  # int32[OB]
    ob_end_uid: torch.Tensor    # int32[OB]
    ob_start_side: torch.Tensor  # int32[OB]
    ob_end_side: torch.Tensor    # int32[OB]
    ob_ref_seq: torch.Tensor     # int32[OB]
    min_seq: torch.Tensor      # int32 scalar (collab-window floor)
    error: torch.Tensor        # int32 scalar bitmask


def tree_map(fn, state: DocState, *rest: DocState) -> DocState:
    """Apply ``fn`` leaf-wise (tuple fields element-wise)."""
    out = []
    for i, v in enumerate(state):
        others = [r[i] for r in rest]
        if isinstance(v, tuple):
            out.append(tuple(fn(a, *(o[j] for o in others)) for j, a in enumerate(v)))
        else:
            out.append(fn(v, *others))
    return DocState(*out)


def leaves(state: DocState) -> list:
    """Flat leaf list in field order (tuple fields expanded)."""
    out = []
    for v in state:
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


def init_state(
    max_segments: int = 512,
    remove_slots: int = 4,
    prop_slots: int = 4,
    text_capacity: int = 8192,
    ob_slots: int = 8,
    device=DEFAULT_DEVICE,
) -> DocState:
    """One empty document on ``device``."""
    dev = resolve_device(device)
    S, R, P, T, OB = max_segments, remove_slots, prop_slots, text_capacity, ob_slots

    def full(n, v):
        return torch.full((n,), v, dtype=I32, device=dev)

    def scalar():
        return torch.zeros((), dtype=I32, device=dev)

    return DocState(
        text=full(T, 0),
        text_end=scalar(),
        nseg=scalar(),
        seg_start=full(S, 0),
        seg_len=full(S, 0),
        ins_key=full(S, 0),
        ins_client=full(S, -1),
        seg_uid=full(S, -1),
        seg_obpre=full(S, -1),
        rem_keys=tuple(full(S, NO_REMOVE) for _ in range(R)),
        rem_clients=tuple(full(S, -1) for _ in range(R)),
        prop_keys=tuple(full(S, -1) for _ in range(P)),
        prop_vals=tuple(full(S, 0) for _ in range(P)),
        uid_next=scalar(),
        ob_key=full(OB, -1),
        ob_client=full(OB, -1),
        ob_start_uid=full(OB, -1),
        ob_end_uid=full(OB, -1),
        ob_start_side=full(OB, 0),
        ob_end_side=full(OB, 0),
        ob_ref_seq=full(OB, -1),
        min_seq=scalar(),
        error=scalar(),
    )


def batch_state(state: DocState, n_docs: int) -> DocState:
    """A fleet of ``n_docs`` copies of one document ([D, ...] leaves)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((n_docs,) + (1,) * x.dim()), state)


def doc_row(state: DocState, d: int) -> DocState:
    """Document ``d`` of a fleet, as a one-document state (views)."""
    return tree_map(lambda x: x[d], state)


def to_numpy(state: DocState) -> DocState:
    """Every leaf as a host numpy array (tensors or numpy accepted)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x),
        state,
    )


def from_numpy(state: DocState, device=DEFAULT_DEVICE) -> DocState:
    """Every leaf as an int32 tensor on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda x: torch.tensor(np.asarray(x, np.int32), device=dev), state
    )


# ------------------------------------------------------------ host encoders

def make_noop(op_fields: int = OP_FIELDS) -> np.ndarray:
    return np.zeros((op_fields,), np.int32)


def encode_insert(
    pos: int,
    text: str,
    op_key: int,
    op_client: int,
    ref_seq: int,
    max_insert_len: int,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """One insert as (op_row, payload) pairs, chunking long text.  Chunks
    share the op's stamp and are emitted BACK-TO-FRONT, all at ``pos``:
    with the >=-tiebreak each later chunk lands immediately before the
    previous one, so the final order is the original text order."""
    out: list[tuple[np.ndarray, np.ndarray]] = []
    for i in reversed(range(0, len(text), max_insert_len)):
        chunk = text[i : i + max_insert_len]
        payload = np.zeros((max_insert_len,), np.int32)
        payload[: len(chunk)] = [ord(ch) for ch in chunk]
        op = np.array(
            [OpKind.INSERT, op_key, op_client, ref_seq, pos, 0, len(chunk), 0],
            np.int32,
        )
        out.append((op, payload))
    return out


def encode_obliterate(
    pos1: int, side1: int, pos2: int, side2: int,
    op_key: int, op_client: int, ref_seq: int,
) -> np.ndarray:
    """A sided obliterate op row.  The plain wire form {pos1, pos2} encodes
    as ``encode_obliterate(pos1, SIDE_BEFORE, pos2-1, SIDE_AFTER)``."""
    return np.array(
        [OpKind.OBLITERATE, op_key, op_client, ref_seq, pos1, pos2, side1, side2],
        np.int32,
    )


def encode_insert_batch(
    pos: np.ndarray,
    texts: list[str],
    op_keys: np.ndarray,
    op_clients: np.ndarray,
    ref_seqs: np.ndarray,
    max_insert_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``encode_insert`` over N inserts: ``(ops[M, 8],
    payloads[M, L], owner[M])``, row-for-row identical to mapping
    ``encode_insert`` over the inputs (back-to-front chunk order included)."""
    n = len(texts)
    L = max_insert_len
    lens = np.fromiter((len(t) for t in texts), np.int64, n)
    nchunks = -(-lens // L)
    m = int(nchunks.sum())
    ops = np.zeros((m, OP_FIELDS), np.int32)
    payloads = np.zeros((m, L), np.int32)
    owner = np.repeat(np.arange(n), nchunks)
    if m == 0:
        return ops, payloads, owner
    row0 = np.concatenate(([0], np.cumsum(nchunks)[:-1]))
    local = np.arange(m) - np.repeat(row0, nchunks)
    chunk_idx = np.repeat(nchunks, nchunks) - 1 - local
    chunk_start = chunk_idx * L
    chunk_len = np.minimum(L, np.repeat(lens, nchunks) - chunk_start)
    ops[:, 0] = OpKind.INSERT
    ops[:, 1] = np.repeat(np.asarray(op_keys, np.int64), nchunks)
    ops[:, 2] = np.repeat(np.asarray(op_clients, np.int64), nchunks)
    ops[:, 3] = np.repeat(np.asarray(ref_seqs, np.int64), nchunks)
    ops[:, 4] = np.repeat(np.asarray(pos, np.int64), nchunks)
    ops[:, 6] = chunk_len
    codes = np.frombuffer(
        "".join(texts).encode("utf-32-le"), dtype=np.uint32
    ).astype(np.int32)
    text_off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    src_base = np.repeat(text_off, nchunks) + chunk_start
    row = np.repeat(np.arange(m), chunk_len)
    within = np.arange(int(chunk_len.sum())) - np.repeat(
        np.concatenate(([0], np.cumsum(chunk_len)[:-1])), chunk_len
    )
    payloads[row, within] = codes[np.repeat(src_base, chunk_len) + within]
    return ops, payloads, owner


def encode_obliterate_batch(
    pos1: np.ndarray,
    side1: np.ndarray,
    pos2: np.ndarray,
    side2: np.ndarray,
    op_keys: np.ndarray,
    op_clients: np.ndarray,
    ref_seqs: np.ndarray,
) -> np.ndarray:
    """Vectorized ``encode_obliterate``: N sided obliterates -> ops[N, 8]."""
    n = len(op_keys)
    ops = np.empty((n, OP_FIELDS), np.int32)
    ops[:, 0] = OpKind.OBLITERATE
    ops[:, 1] = op_keys
    ops[:, 2] = op_clients
    ops[:, 3] = ref_seqs
    ops[:, 4] = pos1
    ops[:, 5] = pos2
    ops[:, 6] = side1
    ops[:, 7] = side2
    return ops


# --------------------------------------------------------------- primitives

def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


def _any_tree(masks) -> torch.Tensor:
    return functools.reduce(torch.logical_or, masks)


def _min_tree(arrays) -> torch.Tensor:
    return functools.reduce(torch.minimum, arrays)


def _take(arr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row ``arr[d, k[d]]`` with k clamped into range — jnp's gather
    rule (``k = nseg`` on a full doc reads the last slot, never faults)."""
    k = k.clamp(0, arr.shape[-1] - 1).long()
    return arr.gather(-1, k.unsqueeze(-1)).squeeze(-1)


def _put(arr: torch.Tensor, k: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Per-row ``arr[d, k[d]] = val[d]`` (k in range), as a new tensor."""
    return arr.scatter(-1, k.long().unsqueeze(-1), val.to(arr.dtype).unsqueeze(-1))


def _first_true(mask: torch.Tensor, default) -> torch.Tensor:
    """Index of the first set bit along the last axis, else ``default``
    (jnp.argmax's first-hit rule on a bool mask, made explicit)."""
    idx = torch.where(mask, _iota(mask.shape[-1], mask.device), BIG).amin(-1)
    return torch.where(idx == BIG, default, idx)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """jnp.argmax over the last axis: the first index of the maximum."""
    hit = x == x.amax(-1, keepdim=True)
    return torch.where(hit, _iota(x.shape[-1], x.device), BIG).amin(-1)


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """jnp.argmin over the last axis: the first index of the minimum."""
    hit = x == x.amin(-1, keepdim=True)
    return torch.where(hit, _iota(x.shape[-1], x.device), BIG).amin(-1)


def _err(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(I32)


def _alive(s: DocState) -> torch.Tensor:
    return _iota(s.seg_len.shape[-1], s.seg_len.device) < s.nseg[:, None]


def _visible(s: DocState, ref_seq, client) -> torch.Tensor:
    """Perspective mask over segments (ref perspective.ts isSegmentPresent);
    ``ref_seq``/``client`` are per-doc [D]."""
    r = ref_seq[:, None]
    c = client[:, None]
    ins_occ = (s.ins_key <= r) | (s.ins_client == c)
    rem_occ = _any_tree(
        [(k <= r) | (cl == c) for k, cl in zip(s.rem_keys, s.rem_clients)]
    )
    return _alive(s) & ins_occ & ~rem_occ


def _vis_lengths(s: DocState, vis) -> tuple[torch.Tensor, torch.Tensor]:
    vlen = torch.where(vis, s.seg_len, 0)
    excl = torch.cumsum(vlen, -1, dtype=I32) - vlen  # exclusive prefix
    return vlen, excl


def _shift_right(arr, k, newval, do):
    """Rows with ``do``: a slot opened at k ([..k-1] keep, [k]=newval,
    [k+1..] shifted right); other rows unchanged.  ``arr`` is [D, S], or
    [C, D, S] for C columns at once (``newval`` then [C, D])."""
    idx = _iota(arr.shape[-1], arr.device)
    kk = k[:, None]
    prev = torch.cat([arr[..., :1], arr[..., :-1]], dim=-1)
    moved = torch.where(idx == kk, newval[..., None], prev)
    return torch.where(do[:, None] & (idx >= kk), moved, arr)


class _NewSeg(NamedTuple):
    seg_start: torch.Tensor
    seg_len: torch.Tensor
    ins_key: torch.Tensor
    ins_client: torch.Tensor
    seg_uid: torch.Tensor
    seg_obpre: torch.Tensor
    rem_keys: tuple
    rem_clients: tuple
    prop_keys: tuple
    prop_vals: tuple


def _seg_columns(s) -> list:
    """The per-segment columns of a state (or the fields of a ``_NewSeg``),
    in field order."""
    return [s.seg_start, s.seg_len, s.ins_key, s.ins_client, s.seg_uid, s.seg_obpre,
            *s.rem_keys, *s.rem_clients, *s.prop_keys, *s.prop_vals]


def _shift_fields(s: DocState, k, do, new: _NewSeg) -> DocState:
    """``_shift_right`` of every per-segment column, stacked to one
    [C, D, S] tensor: a slot opens in a handful of launches whatever the
    slot counts."""
    R, P = len(s.rem_keys), len(s.prop_keys)
    vals = torch.stack(_seg_columns(new)).to(I32)
    out = _shift_right(torch.stack(_seg_columns(s)), k, vals, do).unbind(0)
    return s._replace(
        seg_start=out[0], seg_len=out[1], ins_key=out[2], ins_client=out[3],
        seg_uid=out[4], seg_obpre=out[5],
        rem_keys=out[6 : 6 + R], rem_clients=out[6 + R : 6 + 2 * R],
        prop_keys=out[6 + 2 * R : 6 + 2 * R + P], prop_vals=out[6 + 2 * R + P :],
        nseg=s.nseg + _i32(do),
    )


def _open_slot(s: DocState, k, do, new: _NewSeg) -> DocState:
    """Where ``do``: shift every per-segment column right at ``k`` and write
    the new segment there.  Capacity overflow latches ERR_SEG_OVERFLOW."""
    S = s.seg_len.shape[-1]
    overflow = do & (s.nseg >= S)
    s = _shift_fields(s, k, do & ~overflow, new)
    return s._replace(error=s.error | _err(overflow, ERR_SEG_OVERFLOW))


def _split_seg(s: DocState, k, off, right_uid) -> _NewSeg:
    """The right half of segment ``k`` split at offset ``off`` (every
    column read in one gather of the stacked columns)."""
    R, P = len(s.rem_keys), len(s.prop_keys)
    cols = torch.stack(_seg_columns(s))
    idx = k.clamp(0, cols.shape[-1] - 1).long()[None, :, None].expand(cols.shape[0], -1, 1)
    row = cols.gather(-1, idx).squeeze(-1).unbind(0)
    return _NewSeg(
        seg_start=row[0] + off,
        seg_len=row[1] - off,
        ins_key=row[2],
        ins_client=row[3],
        seg_uid=right_uid,
        seg_obpre=row[5],
        rem_keys=row[6 : 6 + R],
        rem_clients=row[6 + R : 6 + 2 * R],
        prop_keys=row[6 + 2 * R : 6 + 2 * R + P],
        prop_vals=row[6 + 2 * R + P :],
    )


def _finish_split(s2: DocState, k, do, trim, new_len, old_uid, right_uid) -> DocState:
    """Trim the left half at ``k`` (where ``trim``; the write happens even
    when the shift was cancelled by overflow — the reference's left-trim),
    allocate the right half's uid and move After-side obliterate anchors."""
    moved_start = do[:, None] & (s2.ob_start_uid == old_uid[:, None]) & (
        s2.ob_start_side == SIDE_AFTER
    )
    moved_end = do[:, None] & (s2.ob_end_uid == old_uid[:, None]) & (
        s2.ob_end_side == SIDE_AFTER
    )
    return s2._replace(
        seg_len=_put(s2.seg_len, k, torch.where(trim, new_len, _take(s2.seg_len, k))),
        uid_next=s2.uid_next + _i32(do),
        ob_start_uid=torch.where(moved_start, right_uid[:, None], s2.ob_start_uid),
        ob_end_uid=torch.where(moved_end, right_uid[:, None], s2.ob_end_uid),
    )


def _ensure_boundary(s: DocState, pos, ref_seq, client, act) -> DocState:
    """Split the segment containing ``pos`` strictly inside it, on the docs
    in ``act``: after this, ``pos`` falls on a segment boundary of the
    perspective-visible sequence."""
    vis = _visible(s, ref_seq, client)
    vlen, excl = _vis_lengths(s, vis)
    p = pos[:, None]
    mid = vis & (excl < p) & (p < excl + vlen) & act[:, None]
    k = _first_true(mid, 0)
    do = mid.any(-1)
    off = pos - _take(excl, k)
    old_uid = _take(s.seg_uid, k)
    right_uid = s.uid_next
    s2 = _open_slot(s, k + 1, do, _split_seg(s, k, off, right_uid))
    return _finish_split(s2, k, do, do, off, old_uid, right_uid)


# ------------------------------------------------------------- op branches

def _tiebreak(s: DocState, op_key) -> torch.Tensor:
    """Reference breakTie (mergeTree.ts:1811) as a per-segment mask; equal
    keys (>=) win the tie."""
    rem0 = _min_tree(s.rem_keys)
    key = op_key[:, None]
    rem_clause = (rem0 < LOCAL_BASE) & (rem0 > key)
    return (key >= s.ins_key) | rem_clause


def _ob_anchor_indices(s: DocState):
    """Per obliterate slot: segment indices of its start/end anchor uids
    ([D, OB] each) plus found masks."""
    alive = _alive(s)[:, None, :]
    m_start = (s.ob_start_uid[:, :, None] == s.seg_uid[:, None, :]) & alive
    m_end = (s.ob_end_uid[:, :, None] == s.seg_uid[:, None, :]) & alive
    return (
        _first_true(m_start, 0), m_start.any(-1),
        _first_true(m_end, 0), m_end.any(-1),
    )


def _obliterate_swallow(s: DocState, anchors, k, key, client, ref_seq):
    """The insert-time obliterate rule (ref mergeTree.ts blockInsert
    :1647-1745): whether the segment landing at index ``k`` is swallowed by
    concurrent obliterates, and with which remove stamps.  Returns
    (rem_keys, rem_clients, obpre, overflow), each per doc."""
    R = len(s.rem_keys)
    OB = s.ob_key.shape[-1]
    used = s.ob_key >= 0
    s_idx, s_found, e_idx, e_found = anchors
    kk = k[:, None]
    inside = used & s_found & e_found & (s_idx < kk) & (e_idx >= kk)
    concurrent = inside & (s.ob_key > ref_seq[:, None])
    others = concurrent & (s.ob_client != client[:, None])
    any_conc = concurrent.any(-1)
    conc_keys = torch.where(concurrent, s.ob_key, -1)
    newest_i = _argmax_first(conc_keys)
    newest_key = _take(conc_keys, newest_i)
    newest_client = _take(s.ob_client, newest_i)
    acked_conc = concurrent & (s.ob_key < LOCAL_BASE)
    any_acked = acked_conc.any(-1)
    na_keys = torch.where(acked_conc, s.ob_key, -1)
    na_i = _argmax_first(na_keys)
    na_key = _take(na_keys, na_i)
    na_client = _take(s.ob_client, na_i)
    unacked_conc = concurrent & (s.ob_key >= LOCAL_BASE)
    ou_keys = torch.where(unacked_conc, s.ob_key, NO_REMOVE)
    ou_i = _argmin_first(ou_keys)
    mark = others.any(-1) & any_conc & (newest_client != client)
    include_acked = ~any_acked | (na_key == newest_key) | (na_client != client)
    is_oldest_unacked = unacked_conc & (_iota(OB, s.ob_key.device) == ou_i[:, None])
    cand = mark[:, None] & (
        (others & acked_conc & include_acked[:, None]) | is_oldest_unacked
    )
    ckeys = torch.where(cand, s.ob_key, NO_REMOVE)
    rem_k, rem_c = [], []
    for _ in range(R):
        i = _argmin_first(ckeys)
        kv = _take(ckeys, i)
        rem_k.append(kv)
        rem_c.append(torch.where(kv < NO_REMOVE, _take(s.ob_client, i), -1))
        ckeys = _put(ckeys, i, torch.full_like(kv, NO_REMOVE))
    overflow = (ckeys < NO_REMOVE).any(-1)
    obpre = torch.where(any_conc, newest_key, -1)
    return tuple(rem_k), tuple(rem_c), obpre, overflow


def _no_obliterate_swallow(s: DocState):
    """Empty obliterate table: the new segment is never swallowed."""
    R = len(s.rem_keys)
    D = s.nseg.shape[0]
    no = torch.full((D,), NO_REMOVE, dtype=I32, device=s.nseg.device)
    neg = torch.full((D,), -1, dtype=I32, device=s.nseg.device)
    return (
        tuple(no for _ in range(R)),
        tuple(neg for _ in range(R)),
        neg,
        torch.zeros((D,), dtype=torch.bool, device=s.nseg.device),
    )


def _write_payload(s: DocState, payload, text_len, wr_doc) -> torch.Tensor:
    """Copy each doc's payload row into its text pool at ``text_end`` where
    ``wr_doc``, IN PLACE (the dropped scatter ``text.at[dst].set(payload,
    mode="drop")``).  Dropped lanes add zero at a clamped index, so
    duplicate indices are harmless; a written lane's index is unique."""
    T = s.text.shape[-1]
    L = payload.shape[-1]
    tpos = _iota(L, payload.device)
    wr = wr_doc[:, None] & (tpos < text_len[:, None])
    idx = (s.text_end[:, None] + tpos).clamp(0, T - 1).long()
    cur = s.text.gather(-1, idx)
    s.text.scatter_add_(-1, idx, torch.where(wr, payload - cur, 0).to(I32))
    return s.text


def _new_segment(s: DocState, key, client, text_len, swallow) -> _NewSeg:
    rem_k, rem_c, obpre, _over = swallow
    P = len(s.prop_keys)
    neg = torch.full_like(key, -1)
    zero = torch.zeros_like(key)
    return _NewSeg(
        seg_start=s.text_end,
        seg_len=text_len,
        ins_key=key,
        ins_client=client,
        seg_uid=s.uid_next,
        seg_obpre=obpre,
        rem_keys=rem_k,
        rem_clients=rem_c,
        prop_keys=tuple(neg for _ in range(P)),
        prop_vals=tuple(zero for _ in range(P)),
    )


def _do_insert(s: DocState, op, payload, ob_flag: bool, act) -> DocState:
    pos, key, client, ref_seq = op[:, 4], op[:, 1], op[:, 2], op[:, 3]
    text_len = op[:, 6]
    s = _ensure_boundary(s, pos, ref_seq, client, act)
    vis = _visible(s, ref_seq, client)
    vlen, excl = _vis_lengths(s, vis)
    total = vlen.sum(-1, dtype=I32)
    stop = _alive(s) & (excl >= pos[:, None]) & ((vlen > 0) | _tiebreak(s, key))
    k = _first_true(stop, s.nseg)
    T = s.text.shape[-1]
    text_over = s.text_end + text_len > T
    text = _write_payload(s, payload, text_len, act & ~text_over)
    swallow = (
        _obliterate_swallow(s, _ob_anchor_indices(s), k, key, client, ref_seq)
        if ob_flag else _no_obliterate_swallow(s)
    )
    ok = act & ~text_over & (pos <= total)
    s = _open_slot(s, k, ok, _new_segment(s, key, client, text_len, swallow))
    return s._replace(
        text=text,
        text_end=s.text_end + torch.where(ok, text_len, 0),
        uid_next=s.uid_next + _i32(ok),
        error=s.error
        | _err(act & text_over, ERR_TEXT_OVERFLOW)
        | _err(act & (pos > total), ERR_POS_RANGE)
        | _err(ok & swallow[3], ERR_REM_OVERFLOW),
    )


def _mark_range(s: DocState, op, act) -> tuple[DocState, torch.Tensor]:
    """Split at both boundaries; return the mask of visible segments inside."""
    pos1, pos2, client, ref_seq = op[:, 4], op[:, 5], op[:, 2], op[:, 3]
    s = _ensure_boundary(s, pos1, ref_seq, client, act)
    s = _ensure_boundary(s, pos2, ref_seq, client, act)
    vis = _visible(s, ref_seq, client)
    vlen, excl = _vis_lengths(s, vis)
    total = vlen.sum(-1, dtype=I32)
    mark = (
        vis & (excl >= pos1[:, None]) & (excl + vlen <= pos2[:, None])
        & (vlen > 0) & act[:, None]
    )
    s = s._replace(error=s.error | _err(act & (pos2 > total), ERR_POS_RANGE))
    return s, mark


def _splice_remove_stamp(s: DocState, mark, key, client):
    """A remove stamp into the first free slot of every marked segment;
    returns (rem_keys, rem_clients, overflow)."""
    rem_keys = list(s.rem_keys)
    rem_clients = list(s.rem_clients)
    placed = torch.zeros_like(mark)
    kk = key[:, None]
    cc = client[:, None]
    for r in range(len(rem_keys)):
        sel = mark & (rem_keys[r] == NO_REMOVE) & ~placed
        rem_keys[r] = torch.where(sel, kk, rem_keys[r])
        rem_clients[r] = torch.where(sel, cc, rem_clients[r])
        placed = placed | sel
    return tuple(rem_keys), tuple(rem_clients), (mark & ~placed).any(-1)


def _do_remove(s: DocState, op, payload, act) -> DocState:
    key, client = op[:, 1], op[:, 2]
    s, mark = _mark_range(s, op, act)
    rem_keys, rem_clients, overflow = _splice_remove_stamp(s, mark, key, client)
    return s._replace(
        rem_keys=rem_keys,
        rem_clients=rem_clients,
        error=s.error | _err(overflow, ERR_REM_OVERFLOW),
    )


def _annotate_marked(s: DocState, mark, op) -> DocState:
    """The annotate LWW write against a mark mask (per-(segment, prop) by
    stamp key; ties go to the later-applied op)."""
    key, prop_slot, value = op[:, 1:2], op[:, 6:7], op[:, 7:8]
    prop_keys = list(s.prop_keys)
    prop_vals = list(s.prop_vals)
    for p in range(len(prop_keys)):
        win = (prop_slot == p) & mark & (key >= prop_keys[p])
        prop_keys[p] = torch.where(win, key, prop_keys[p])
        prop_vals[p] = torch.where(win, value, prop_vals[p])
    return s._replace(prop_keys=tuple(prop_keys), prop_vals=tuple(prop_vals))


def _do_annotate(s: DocState, op, payload, act) -> DocState:
    s, mark = _mark_range(s, op, act)
    return _annotate_marked(s, mark, op)


def _obliterate_visit(s: DocState, vis, key, client, ref_seq):
    """The obliterate marking visit rule (ref mergeTree.ts:2990-3001): a
    remote obliterate visits every window segment except those dead in both
    views; a local one marks exactly its perspective's visible segments.
    Returns (visit, skip) masks."""
    kk = key[:, None]
    cc = client[:, None]
    rem_min = _min_tree(s.rem_keys)
    has_acked_rem = rem_min < LOCAL_BASE
    is_local_ins = s.ins_key >= LOCAL_BASE
    ins_conc = ~((s.ins_key <= ref_seq[:, None]) | (s.ins_client == cc))
    same_client_stamp = _any_tree(
        [
            (c == cc) & (k > s.ins_key) & (k <= kk)
            for k, c in zip(s.rem_keys, s.rem_clients)
        ]
    )
    visit = torch.where(
        kk >= LOCAL_BASE,
        vis,
        ~has_acked_rem | vis | is_local_ins | (ins_conc & ~same_client_stamp),
    )
    skip = (s.ins_key >= LOCAL_BASE) & (s.seg_obpre >= LOCAL_BASE) & (kk < LOCAL_BASE)
    return visit, skip


def _record_obliterate(s: DocState, rec, key, client, start_uid, end_uid,
                       side1, side2, ref_seq):
    """Write the obliterate into the first free window-table slot where
    ``rec``.  Returns (state, has_free)."""
    free = s.ob_key < 0
    slot = _first_true(free, 0)
    has_free = free.any(-1)
    rec = rec & has_free

    def put(arr, val):
        return _put(arr, slot, torch.where(rec, val, _take(arr, slot)))

    return s._replace(
        ob_key=put(s.ob_key, key),
        ob_client=put(s.ob_client, client),
        ob_start_uid=put(s.ob_start_uid, start_uid),
        ob_end_uid=put(s.ob_end_uid, end_uid),
        ob_start_side=put(s.ob_start_side, side1),
        ob_end_side=put(s.ob_end_side, side2),
        ob_ref_seq=put(s.ob_ref_seq, ref_seq),
    ), has_free


def _do_obliterate(s: DocState, op, payload, act) -> DocState:
    """Sided obliterate (ref mergeTree.ts obliterateRangeSided:2083): mark
    every not-yet-removed segment in the anchor window and record the
    obliterate for insert-time swallowing."""
    key, client, ref_seq = op[:, 1], op[:, 2], op[:, 3]
    pos1, pos2, side1, side2 = op[:, 4], op[:, 5], op[:, 6], op[:, 7]
    start_pos = pos1 + side1
    end_pos = pos2 + side2
    vis = _visible(s, ref_seq, client)
    vlen, _excl = _vis_lengths(s, vis)
    total = vlen.sum(-1, dtype=I32)
    valid = (0 <= pos1) & (pos1 <= pos2) & (pos2 < total) & (start_pos <= end_pos)
    s = _ensure_boundary(s, torch.where(valid, start_pos, 0), ref_seq, client, act)
    s = _ensure_boundary(s, torch.where(valid, end_pos, 0), ref_seq, client, act)
    vis = _visible(s, ref_seq, client)
    vlen, excl = _vis_lengths(s, vis)
    p1 = pos1[:, None]
    p2 = pos2[:, None]
    cont_s = vis & (excl <= p1) & (p1 < excl + vlen)
    cont_e = vis & (excl <= p2) & (p2 < excl + vlen)
    s_idx = _first_true(cont_s, s.nseg)
    e_idx = _first_true(cont_e, s.nseg)
    lo = s_idx + _i32(side1 == SIDE_AFTER)
    hi = e_idx - _i32(side2 == SIDE_BEFORE)
    idx = _iota(s.seg_len.shape[-1], s.seg_len.device)
    visit, skip = _obliterate_visit(s, vis, key, client, ref_seq)
    mark = (
        (valid & act)[:, None] & _alive(s) & (idx >= lo[:, None])
        & (idx <= hi[:, None]) & visit & ~skip
    )
    rem_keys, rem_clients, rem_over = _splice_remove_stamp(s, mark, key, client)
    s, has_free = _record_obliterate(
        s, valid & act, key, client, _take(s.seg_uid, s_idx),
        _take(s.seg_uid, e_idx), side1, side2, ref_seq,
    )
    return s._replace(
        rem_keys=rem_keys,
        rem_clients=rem_clients,
        error=s.error
        | _err(act & ~valid, ERR_POS_RANGE)
        | _err(act & valid & ~has_free, ERR_OB_OVERFLOW)
        | _err(rem_over, ERR_REM_OVERFLOW),
    )


def _do_ack(s: DocState, op, payload, act) -> DocState:
    """Convert pending stamps (localSeq) to the acked seq; optionally
    re-stamp the client id (op[2] >= 0) and the obliterate's recorded
    refSeq (op[3] >= 0)."""
    local_seq, seq = op[:, 6:7], op[:, 7:8]
    new_client, new_ref = op[:, 2:3], op[:, 3:4]
    a = act[:, None]
    local_key = LOCAL_BASE + local_seq
    ins_hit = (s.ins_key == local_key) & a
    ob_hit = (s.ob_key == local_key) & a
    rw_c = new_client >= 0
    return s._replace(
        ins_key=torch.where(ins_hit, seq, s.ins_key),
        ins_client=torch.where(ins_hit & rw_c, new_client, s.ins_client),
        rem_keys=tuple(torch.where((k == local_key) & a, seq, k) for k in s.rem_keys),
        rem_clients=tuple(
            torch.where((k == local_key) & a & rw_c, new_client, c)
            for k, c in zip(s.rem_keys, s.rem_clients)
        ),
        prop_keys=tuple(torch.where((k == local_key) & a, seq, k) for k in s.prop_keys),
        ob_key=torch.where(ob_hit, seq, s.ob_key),
        ob_client=torch.where(ob_hit & rw_c, new_client, s.ob_client),
        ob_ref_seq=torch.where(ob_hit & (new_ref >= 0), new_ref, s.ob_ref_seq),
        seg_obpre=torch.where((s.seg_obpre == local_key) & a, seq, s.seg_obpre),
    )


def _host_kinds(ops) -> np.ndarray:
    """Op kinds as host numpy (a device sync when ``ops`` lives on the card;
    the engine passes its host ring's kinds instead)."""
    if isinstance(ops, torch.Tensor):
        return ops[..., 0].cpu().numpy()
    return np.asarray(ops)[..., 0]


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def _ob_table_nonempty(s: DocState) -> bool:
    """The device half of the obliterate gate: one host sync, counted on
    ``apply_megastep.ob_gate_syncs``."""
    apply_megastep.ob_gate_syncs += 1
    return bool((s.ob_key >= 0).any())


def _branch(s: DocState, op, payload, kind: int, ob_flag: bool, act) -> DocState:
    if kind == OpKind.INSERT:
        return _do_insert(s, op, payload, ob_flag, act)
    if kind == OpKind.REMOVE:
        return _do_remove(s, op, payload, act)
    if kind == OpKind.ANNOTATE:
        return _do_annotate(s, op, payload, act)
    if kind == OpKind.ACK:
        return _do_ack(s, op, payload, act)
    return _do_obliterate(s, op, payload, act)


# A branch held by at most 1/SUBSET_FRACTION of the docs runs on their
# gathered rows only.  On the config-3 fleet (10,000 docs, Zipf traffic)
# this split beat both single routes on one H100: all-masked was 1.1-1.4x
# slower per step, all-gathered about 10% slower with 1.09 GB more peak
# memory (PERF.md, section 6).  Values between were not measured.
SUBSET_FRACTION = 4


def _apply_op(s: DocState, op, payload, kinds: np.ndarray, ob_flag: bool) -> DocState:
    """One ring position: each kind present (host-side ``kinds[D]``) runs
    its branch on the docs holding it; NOOP rows are untouched.  A branch
    held by many docs runs masked over the whole batch; one held by few
    runs on their gathered rows, written back in place (``s`` is private
    to the calling apply entry)."""
    D = kinds.shape[0]
    kind = op[:, 0]
    for kd in np.unique(kinds).tolist():
        if not OpKind.INSERT <= kd <= OpKind.OBLITERATE:
            continue
        if kd == OpKind.OBLITERATE and not ob_flag:
            continue  # the reference's gated-off branch is the identity
        rows = np.flatnonzero(kinds == kd)
        if len(rows) * SUBSET_FRACTION > D:
            s = _branch(s, op, payload, kd, ob_flag, kind == kd)
            continue
        idx = torch.as_tensor(rows, device=op.device)
        sub = tree_map(lambda x: x.index_select(0, idx), s)
        act = torch.ones((len(rows),), dtype=torch.bool, device=op.device)
        sub = _branch(
            sub, op.index_select(0, idx), payload.index_select(0, idx), kd, ob_flag, act
        )
        for x, y in zip(leaves(s), leaves(sub)):
            x.index_copy_(0, idx, y)
    return s


def _own(s: DocState) -> DocState:
    """A private copy: the apply loop updates leaves in place."""
    return tree_map(torch.clone, s)


def apply_ops(s: DocState, ops, payloads, ob_flag=None) -> DocState:
    """Apply ops[D, B, 8] (+ payloads[D, B, L]) to a [D, ...] batch, in
    order along B.  ``ob_flag`` (one scalar for the whole batch, as the
    reference computes it outside vmap) defaults to: any doc's obliterate
    table nonempty, or any op in the batch an OBLITERATE."""
    dev = s.nseg.device
    kinds = _host_kinds(ops)
    ops = _as_tensor(ops, dev)
    payloads = _as_tensor(payloads, dev)
    if ob_flag is None:
        ob_flag = bool((kinds == OpKind.OBLITERATE).any()) or _ob_table_nonempty(s)
    s = _own(s)
    for b in range(ops.shape[1]):
        s = _apply_op(s, ops[:, b], payloads[:, b], kinds[:, b], ob_flag)
    return s


def apply_megastep(s: DocState, ops, payloads, kinds=None) -> DocState:
    """Apply a [K, D, B] op ring to a [D, ...] batch: a loop over the K
    slices, each an ``apply_ops`` over the doc axis.  Each slice's
    obliterate gate is the reference's whole-batch scalar, re-evaluated
    from the carried state: host-known when the slice holds an
    OBLITERATE, else one device read of the obliterate tables (counted on
    ``ob_gate_syncs``; the slices whose gate opened on ``ob_gate_opens``).

    ops: int32[K, D, B, 8]; payloads: int32[K, D, B, L] (host numpy or
    tensors); ``kinds``: the host-side int[K, D, B] op kinds, when the
    caller has them (saves a device read of the ring)."""
    count_launch(s.nseg, apply_megastep)
    dev = s.nseg.device
    if kinds is None:
        kinds = _host_kinds(ops)
    ops = _as_tensor(ops, dev)
    payloads = _as_tensor(payloads, dev)
    s = _own(s)
    for k in range(ops.shape[0]):
        flag = bool((kinds[k] == OpKind.OBLITERATE).any()) or _ob_table_nonempty(s)
        apply_megastep.ob_gate_opens += flag
        for b in range(ops.shape[2]):
            s = _apply_op(s, ops[k, :, b], payloads[k, :, b], kinds[k, :, b], flag)
    return s


apply_megastep.ob_gate_syncs = 0
apply_megastep.ob_gate_opens = 0  # slices whose gate opened
apply_megastep.launches = 0


def one_doc_batch(s: DocState) -> DocState:
    """One document's state as a D = 1 batch (views, no copy)."""
    return tree_map(lambda x: x.unsqueeze(0), s)


def apply_op(s: DocState, op, payload, ob_flag=None) -> DocState:
    """Apply one op row (int32[8]) and its payload row (int32[L]) to ONE
    document (unbatched leaves), as a D = 1 batch of the batched branches.
    ``ob_flag`` gates the obliterate machinery as the reference's does: it
    must be True whenever the obliterate table may be nonempty or the op
    is an OBLITERATE (a caller that tracks its obliterates on the host
    passes it).  Left None it is the reference's per-doc gate, decided on
    the host: only an insert reads the table (one device read), an
    obliterate sets it, and the other kinds never look at it."""
    count_launch(s.nseg, apply_op)
    dev = s.nseg.device
    kind = int(op[0])
    if not OpKind.INSERT <= kind <= OpKind.OBLITERATE:
        return s
    s1 = one_doc_batch(s)
    if kind == OpKind.INSERT:  # the one branch that writes in place (text)
        s1 = s1._replace(text=s1.text.clone())
    if ob_flag is None:
        ob_flag = kind == OpKind.OBLITERATE or (
            kind == OpKind.INSERT and _ob_table_nonempty(s1)
        )
    op1 = _as_tensor(op, dev).reshape(1, -1)
    p1 = _as_tensor(payload, dev).reshape(1, -1)
    act = torch.ones((1,), dtype=torch.bool, device=dev)
    return doc_row(_branch(s1, op1, p1, kind, bool(ob_flag), act), 0)


apply_op.launches = 0


# -------------------------------------------------------------- compaction

def set_min_seq(s: DocState, min_seq) -> DocState:
    """Advance each doc's collab-window floor (``min_seq[D]``) and release
    obliterates at or below it (ref Obliterates.setMinSeq)."""
    new_min = torch.maximum(s.min_seq, _as_tensor(min_seq, s.min_seq.device))
    expired = (s.ob_key >= 0) & (s.ob_key < LOCAL_BASE) & (s.ob_key <= new_min[:, None])
    return s._replace(min_seq=new_min, ob_key=torch.where(expired, -1, s.ob_key))


def _anchored_mask(s: DocState) -> torch.Tensor:
    """Segments anchoring a live obliterate ([D, OB, S] uid match)."""
    used = (s.ob_key >= 0)[:, :, None]
    uid = s.seg_uid[:, None, :]
    return (
        ((uid == s.ob_start_uid[:, :, None]) | (uid == s.ob_end_uid[:, :, None]))
        & used
    ).any(1)


def _gather_keep(s: DocState, keep) -> DocState:
    """Stable-compact the per-segment columns down to the kept ones, dead
    slots filled with the ``_SEG_FILL`` conventions."""
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    n_keep = keep.sum(-1, dtype=I32)
    live = _iota(keep.shape[-1], keep.device) < n_keep[:, None]

    def g(arr, fill):
        return torch.where(live, arr.gather(-1, order), fill)

    return s._replace(
        seg_start=g(s.seg_start, 0),
        seg_len=g(s.seg_len, 0),
        ins_key=g(s.ins_key, 0),
        ins_client=g(s.ins_client, -1),
        seg_uid=g(s.seg_uid, -1),
        seg_obpre=g(s.seg_obpre, -1),
        rem_keys=tuple(g(a, NO_REMOVE) for a in s.rem_keys),
        rem_clients=tuple(g(a, -1) for a in s.rem_clients),
        prop_keys=tuple(g(a, -1) for a in s.prop_keys),
        prop_vals=tuple(g(a, 0) for a in s.prop_vals),
        nseg=n_keep,
    )


def compact(s: DocState, ob_flag=None) -> DocState:
    """Evict segments whose winning remove is acked at or below min_seq
    (reference zamboni.ts:33), keeping segments that anchor a live
    obliterate.  ``ob_flag`` gates the [D, OB, S] anchor match (default:
    one device read of the obliterate tables)."""
    count_launch(s.nseg, compact)
    return _compact(s, ob_flag)


compact.launches = 0


def _compact(s: DocState, ob_flag=None) -> DocState:
    if ob_flag is None:
        ob_flag = bool((s.ob_key >= 0).any())
    alive = _alive(s)
    rem0 = _min_tree(s.rem_keys)
    dead = alive & (rem0 < LOCAL_BASE) & (rem0 <= s.min_seq[:, None])
    anchored = _anchored_mask(s) if ob_flag else torch.zeros_like(alive)
    return _gather_keep(s, alive & ~(dead & ~anchored))


# ------------------------------------------------------------- K5 (reconnect)
#
# The device half of reconnect regeneration (dds/kernel_backend.py
# ``KernelMergeTree.regenerate_pending``): the host plans the re-minted
# wire ops from a snapshot, these re-stamp exactly the affected segments.
# Each takes and returns ONE document's state (unbatched leaves).


def drop_squashed(s: DocState) -> DocState:
    """Drop squashed segments: a pending insert later covered by a pending
    remove (under squash resubmission the pair cancels and the segment
    never materializes remotely).  Obliterate anchors stay."""
    count_launch(s.nseg, drop_squashed)
    s1 = one_doc_batch(s)
    alive = _alive(s1)
    pend_ins = s1.ins_key >= LOCAL_BASE
    pend_rem = _any_tree([(k >= LOCAL_BASE) & (k < NO_REMOVE) for k in s1.rem_keys])
    squashed = alive & pend_ins & pend_rem
    return doc_row(_gather_keep(s1, alive & ~(squashed & ~_anchored_mask(s1))), 0)


drop_squashed.launches = 0


def strip_stamp(s: DocState, key: int) -> DocState:
    """Erase every trace of the stamp ``key``: remove slots stamped with it
    revert to NO_REMOVE / client -1 and its obliterate record is freed (a
    pending op retired without resubmission)."""
    count_launch(s.nseg, strip_stamp)
    hits = [k == key for k in s.rem_keys]
    return s._replace(
        rem_keys=tuple(torch.where(h, NO_REMOVE, k) for h, k in zip(hits, s.rem_keys)),
        rem_clients=tuple(torch.where(h, -1, c) for h, c in zip(hits, s.rem_clients)),
        ob_key=torch.where(s.ob_key == key, -1, s.ob_key),
    )


strip_stamp.launches = 0


def restamp(s: DocState, mask, old_key: int, new_key: int, new_client: int,
            do_ins: bool, do_rem: bool, do_prop: bool, do_ob: bool) -> DocState:
    """Rewrite stamp ``old_key`` -> ``new_key`` on the segments selected by
    ``mask`` (bool[S]), per stamp class (insert / remove / prop /
    obliterate record; a class whose flag is off keeps its columns).
    ``new_client`` < 0 keeps clients.  ``seg_obpre`` follows an obliterate
    record's rewrite on every segment, masked or not."""
    count_launch(s.nseg, restamp)
    mask = torch.as_tensor(mask, device=s.nseg.device).bool()
    rw_c = new_client >= 0
    out = {}
    if do_ins:
        hit = mask & (s.ins_key == old_key)
        out["ins_key"] = torch.where(hit, new_key, s.ins_key)
        if rw_c:
            out["ins_client"] = torch.where(hit, new_client, s.ins_client)
    if do_rem:
        hits = [mask & (k == old_key) for k in s.rem_keys]
        out["rem_keys"] = tuple(torch.where(h, new_key, k) for h, k in zip(hits, s.rem_keys))
        if rw_c:
            out["rem_clients"] = tuple(
                torch.where(h, new_client, c) for h, c in zip(hits, s.rem_clients)
            )
    if do_prop:
        out["prop_keys"] = tuple(
            torch.where(mask & (k == old_key), new_key, k) for k in s.prop_keys
        )
    if do_ob:
        hit = s.ob_key == old_key
        out["ob_key"] = torch.where(hit, new_key, s.ob_key)
        if rw_c:
            out["ob_client"] = torch.where(hit, new_client, s.ob_client)
        out["seg_obpre"] = torch.where(s.seg_obpre == old_key, new_key, s.seg_obpre)
    return s._replace(**out)


restamp.launches = 0


# ------------------------------------------------- segment-parallel lane
#
# One hot document's per-segment columns block-shard over a segment axis:
# shard k owns the k-th contiguous run of the global segment order, ``nseg``
# is one live count per shard, and the text pool, scalars and obliterate
# table are replicated.  Per op: an all_gather of per-shard visible totals
# turns local prefixes into global coordinates, a shard-local containment
# search (the K1 kernel) finds candidates, and pmin/psum combine them.
# Mutations are owner-local.
#
# The lane's n shards are the leading (batch) axis of one STACKED state:
# per-segment columns [n, S_local] (row i is shard i's block), ``nseg``
# [n], and every replicated leaf held as n copies ([n, T] text, [n]
# scalars, [n, OB] obliterate table), as each of the reference's shards
# holds one.  The collectives reduce over that axis (``StackedShardGroup``)
# — what ``jax.vmap(..., axis_name=)`` does to the reference's shard_map
# body — so one op step is one pass over all n shards, and one K1 call
# searches all of them.  ``seg_stack``/``seg_unstack`` convert to and from
# the reference's blocked global layout (per-segment [n * S_local]).

SEG_AXIS = "segs"


class StackedShardGroup:
    """The named-axis collectives of a segment axis of ``size`` shards held
    as the leading axis of a stacked state: ``all_gather(x[n, ...])`` gives
    every shard the [n, ...] stack (``out[j, i] = x[j]``), ``psum`` and
    ``pmin`` reduce over the shards and broadcast back, and
    ``axis_index`` is ``arange(n)``.  ``rows``: the shards this process
    holds (all of them)."""

    def __init__(self, size: int = 1) -> None:
        if size < 1:
            raise ValueError(f"a segment axis needs at least one shard, got {size}")
        self.size = size
        self.rows = size

    def axis_index(self, device) -> torch.Tensor:
        return _iota(self.size, device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(1).expand(x.shape[0], *x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(0, keepdim=True).expand_as(x)

    def before(self, gathered: torch.Tensor) -> torch.Tensor:
        """Per shard, the sum of the EARLIER shards' entries of an
        ``all_gather`` result (the reference's ``where(arange < my, x, 0)``
        sum)."""
        n = gathered.shape[0]
        dev = gathered.device
        earlier = _iota(n, dev)[:, None] < self.axis_index(dev)[None, :]
        return torch.where(earlier, gathered, 0).sum(0, dtype=I32)


class ProcessShardGroup(StackedShardGroup):
    """The same collectives over a ``torch.distributed`` process group of
    ``size`` ranks, each holding ONE shard: the stacked layout with a
    leading axis of 1 (``rows``).  ``axis_index`` is the rank's index in
    the group, ``all_gather(x[1, ...])`` gives ``[size, 1, ...]``, and
    ``psum`` / ``pmin`` are ``all_reduce`` SUM / MIN; every value is
    int32.  NCCL reduces the rank's own card tensors; gloo reduces host
    tensors, so on gloo each collective copies through the host (chosen by
    the group's backend).  ``calls`` counts the collectives made."""

    def __init__(self, group=None) -> None:
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rows = 1
        self.index = dist.get_rank(group)
        self.host = dist.get_backend(group) == "gloo"
        self.calls = 0

    def axis_index(self, device) -> torch.Tensor:
        return torch.full((1,), self.index, dtype=I32, device=device)

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``x`` where the backend reduces."""
        return x.detach().to("cpu" if self.host else x.device, copy=True).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        y = self._wire(x)
        parts = [torch.empty_like(y) for _ in range(self.size)]
        self._dist.all_gather(parts, y, group=self.group)
        return torch.stack(parts).to(x.device)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self.calls += 1
        y = self._wire(x)
        self._dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MIN)


def shard_group(n_shards: int = 1) -> StackedShardGroup:
    """The collectives of an ``n_shards``-wide segment axis."""
    return StackedShardGroup(n_shards)


def _seg_prefix(s: DocState, vis, g):
    """Hop 1: (vlen, excl_global, total, char_off)."""
    vlen = torch.where(vis, s.seg_len, 0)
    totals = g.all_gather(vlen.sum(-1, dtype=I32))  # [n_shards, n]
    char_off = g.before(totals)
    excl = torch.cumsum(vlen, -1, dtype=I32) - vlen + char_off[:, None]
    return vlen, excl, totals.sum(0, dtype=I32), char_off


def _seg_index_base(s: DocState, g):
    """Hop 1b: (idx_off, nseg_total) of each shard."""
    counts = g.all_gather(s.nseg)  # [n_shards, n]
    return g.before(counts), counts.sum(0, dtype=I32)


def _seg_first_true(mask, idx_off, default, g):
    """Hop 2: global index of the first set bit across shards, else
    ``default`` (pmin of the per-shard candidates)."""
    has = mask.any(-1)
    cand = torch.where(has, idx_off + _first_true(mask, 0), BIG)
    best = g.pmin(cand)
    return torch.where(best == BIG, default, best)


def _seg_contains(vlen, q_local, strict: bool):
    """Shard-local containment search through the K1 kernel, one call over
    every shard: (local index, hit), each [n, Q], of the visible segment
    containing each local-coordinate query of ``q_local[n, Q]``; ``strict``
    excludes boundary hits (the split predicate)."""
    idx, off, hit = resolve_positions(vlen, q_local)
    hit = hit != 0
    if strict:
        hit = hit & (off > 0)
    return idx, hit


def _open_slot_seg(s: DocState, k, do, new: _NewSeg, g) -> DocState:
    """Owner-local ``_open_slot``: ``do`` holds on the owning shard only;
    shard overflow latches ERR_SEG_OVERFLOW on every shard (psum)."""
    S = s.seg_len.shape[-1]
    overflow = do & (s.nseg >= S)
    s = _shift_fields(s, k, do & ~overflow, new)
    return s._replace(error=s.error | g.psum(_err(overflow, ERR_SEG_OVERFLOW)))


def _ensure_boundary_seg(s: DocState, pos, ref_seq, client, g) -> DocState:
    """Distributed ``_ensure_boundary``: the containing segment is strictly
    inside at most one shard, which splits locally; the uid allocation and
    anchor moves replay on every shard."""
    vis = _visible(s, ref_seq, client)
    vlen, excl, _total, char_off = _seg_prefix(s, vis, g)
    k, hit = _seg_contains(vlen, (pos - char_off)[:, None], strict=True)
    k, hit = k[:, 0], hit[:, 0]
    do = g.psum(_i32(hit)) > 0
    off = pos - _take(excl, k)
    old_uid = g.psum(torch.where(hit, _take(s.seg_uid, k), 0))
    right_uid = s.uid_next
    s2 = _open_slot_seg(s, k + 1, hit, _split_seg(s, k, off, right_uid), g)
    return _finish_split(s2, k, do, hit, off, old_uid, right_uid)


def _ob_anchor_indices_seg(s: DocState, idx_off, g):
    """``_ob_anchor_indices`` in global coordinates (psum of the per-shard
    one-hots; uids are globally unique)."""
    ls, fs, le, fe = _ob_anchor_indices(s)
    off = idx_off[:, None]
    return (
        g.psum(torch.where(fs, off + ls, 0)), g.psum(_i32(fs)) > 0,
        g.psum(torch.where(fe, off + le, 0)), g.psum(_i32(fe)) > 0,
    )


def _do_insert_seg(s: DocState, op, payload, ob_flag: bool, g) -> DocState:
    pos, key, client, ref_seq = op[:, 4], op[:, 1], op[:, 2], op[:, 3]
    text_len = op[:, 6]
    s = _ensure_boundary_seg(s, pos, ref_seq, client, g)
    vis = _visible(s, ref_seq, client)
    vlen, excl, total, _off = _seg_prefix(s, vis, g)
    idx_off, nseg_total = _seg_index_base(s, g)
    stop = _alive(s) & (excl >= pos[:, None]) & ((vlen > 0) | _tiebreak(s, key))
    k_g = _seg_first_true(stop, idx_off, nseg_total, g)
    append = k_g >= nseg_total
    # Appends land on the LAST shard (global order is the concatenation).
    last = g.axis_index(append.device) == g.size - 1
    is_owner = torch.where(
        append, last, (idx_off <= k_g) & (k_g < idx_off + s.nseg)
    )
    k_local = torch.where(append, s.nseg, k_g - idx_off)
    T = s.text.shape[-1]
    text_over = s.text_end + text_len > T
    text = _write_payload(s, payload, text_len, ~text_over)
    swallow = (
        _obliterate_swallow(
            s, _ob_anchor_indices_seg(s, idx_off, g), k_g, key, client, ref_seq
        )
        if ob_flag else _no_obliterate_swallow(s)
    )
    ok = ~text_over & (pos <= total)
    s = _open_slot_seg(
        s, k_local, ok & is_owner, _new_segment(s, key, client, text_len, swallow), g
    )
    return s._replace(
        text=text,
        text_end=s.text_end + torch.where(ok, text_len, 0),
        uid_next=s.uid_next + _i32(ok),
        error=s.error
        | _err(text_over, ERR_TEXT_OVERFLOW)
        | _err(pos > total, ERR_POS_RANGE)
        | _err(ok & swallow[3], ERR_REM_OVERFLOW),
    )


def _mark_range_seg(s: DocState, op, g):
    pos1, pos2, client, ref_seq = op[:, 4], op[:, 5], op[:, 2], op[:, 3]
    s = _ensure_boundary_seg(s, pos1, ref_seq, client, g)
    s = _ensure_boundary_seg(s, pos2, ref_seq, client, g)
    vis = _visible(s, ref_seq, client)
    vlen, excl, total, _off = _seg_prefix(s, vis, g)
    mark = vis & (excl >= pos1[:, None]) & (excl + vlen <= pos2[:, None]) & (vlen > 0)
    s = s._replace(error=s.error | _err(pos2 > total, ERR_POS_RANGE))
    return s, mark


def _do_remove_seg(s: DocState, op, payload, g) -> DocState:
    key, client = op[:, 1], op[:, 2]
    s, mark = _mark_range_seg(s, op, g)
    rem_keys, rem_clients, over_l = _splice_remove_stamp(s, mark, key, client)
    overflow = g.psum(_i32(over_l)) > 0
    return s._replace(
        rem_keys=rem_keys,
        rem_clients=rem_clients,
        error=s.error | _err(overflow, ERR_REM_OVERFLOW),
    )


def _do_annotate_seg(s: DocState, op, payload, g) -> DocState:
    s, mark = _mark_range_seg(s, op, g)
    return _annotate_marked(s, mark, op)


def _do_obliterate_seg(s: DocState, op, payload, g) -> DocState:
    """Distributed ``_do_obliterate``: anchors resolve with the two hops,
    the visit/skip masks and the splice are local, and the window record
    replays on every shard from the psum-broadcast anchor uids."""
    key, client, ref_seq = op[:, 1], op[:, 2], op[:, 3]
    pos1, pos2, side1, side2 = op[:, 4], op[:, 5], op[:, 6], op[:, 7]
    start_pos = pos1 + side1
    end_pos = pos2 + side2
    vis = _visible(s, ref_seq, client)
    _vlen, _excl, total, _off = _seg_prefix(s, vis, g)
    valid = (0 <= pos1) & (pos1 <= pos2) & (pos2 < total) & (start_pos <= end_pos)
    s = _ensure_boundary_seg(s, torch.where(valid, start_pos, 0), ref_seq, client, g)
    s = _ensure_boundary_seg(s, torch.where(valid, end_pos, 0), ref_seq, client, g)
    vis = _visible(s, ref_seq, client)
    vlen, _excl2, _t2, char_off = _seg_prefix(s, vis, g)
    idx_off, nseg_total = _seg_index_base(s, g)
    q = torch.stack([pos1, pos2], -1) - char_off[:, None]
    k, h = _seg_contains(vlen, q, strict=False)
    (ks, ke), (hs, he) = k.unbind(-1), h.unbind(-1)
    s_found = g.psum(_i32(hs)) > 0
    e_found = g.psum(_i32(he)) > 0
    s_idx = torch.where(s_found, g.psum(torch.where(hs, idx_off + ks, 0)), nseg_total)
    e_idx = torch.where(e_found, g.psum(torch.where(he, idx_off + ke, 0)), nseg_total)
    start_uid = g.psum(torch.where(hs, _take(s.seg_uid, ks), 0))
    end_uid = g.psum(torch.where(he, _take(s.seg_uid, ke), 0))
    lo = s_idx + _i32(side1 == SIDE_AFTER)
    hi = e_idx - _i32(side2 == SIDE_BEFORE)
    gidx = idx_off[:, None] + _iota(s.seg_len.shape[-1], s.seg_len.device)
    visit, skip = _obliterate_visit(s, vis, key, client, ref_seq)
    mark = (
        valid[:, None] & _alive(s) & (gidx >= lo[:, None]) & (gidx <= hi[:, None])
        & visit & ~skip
    )
    rem_keys, rem_clients, over_l = _splice_remove_stamp(s, mark, key, client)
    rem_over = g.psum(_i32(over_l)) > 0
    s, has_free = _record_obliterate(
        s, valid, key, client, start_uid, end_uid, side1, side2, ref_seq
    )
    return s._replace(
        rem_keys=rem_keys,
        rem_clients=rem_clients,
        error=s.error
        | _err(~valid, ERR_POS_RANGE)
        | _err(valid & ~has_free, ERR_OB_OVERFLOW)
        | _err(rem_over, ERR_REM_OVERFLOW),
    )


def _apply_op_seg(s: DocState, op, payload, kind: int, ob_flag: bool, g) -> DocState:
    """One op of the seg lane (a one-document program: the host kind picks
    the branch, as ``lax.switch`` does for a single document).  The
    ``_do_*_seg`` branches read nothing back to the host: every
    cross-shard value is a collective's result, left on the device."""
    if kind == OpKind.INSERT:
        return _do_insert_seg(s, op, payload, ob_flag, g)
    if kind == OpKind.REMOVE:
        return _do_remove_seg(s, op, payload, g)
    if kind == OpKind.ANNOTATE:
        return _do_annotate_seg(s, op, payload, g)
    if kind == OpKind.ACK:
        return _do_ack(s, op, payload, torch.ones_like(s.nseg, dtype=torch.bool))
    if kind == OpKind.OBLITERATE and ob_flag:
        return _do_obliterate_seg(s, op, payload, g)
    return s


def _seg_group(s: DocState, group):
    """The lane's group, checked against the shard rows ``s`` holds: all n
    for a stacked group, one for a rank of a process group."""
    n = s.nseg.shape[0]
    g = group if group is not None else StackedShardGroup(n)
    if g.rows != n:
        raise ValueError(f"a group holding {g.rows} of {g.size} shards over a {n}-row state")
    return g


def apply_megastep_seg(s: DocState, ops, payloads, group=None, kinds=None) -> DocState:
    """Segment-parallel megastep: apply a [K, B] op ring to ONE seg-sharded
    document (a loop over the K slices with the reference's per-slice
    obliterate gate), every shard at once.  ``s`` is the stacked lane state
    (``seg_stack``): per-segment columns [n, S_local], ``nseg`` [n], the
    replicated leaves as n copies; ops/payloads are one replicated [K, B]
    ring, broadcast to every shard.  On a ``ProcessShardGroup`` ``s`` is
    this rank's one row and every rank must make this call with the same
    ring: each host branch below reads only replicated values (the ring's
    kinds, the replicated obliterate table), so every rank meets the same
    collectives in the same order."""
    count_launch(s.nseg, apply_megastep_seg)
    g = _seg_group(s, group)
    dev = s.nseg.device
    if kinds is None:
        kinds = _host_kinds(ops)
    ops = _as_tensor(ops, dev)
    payloads = _as_tensor(payloads, dev)
    n = g.rows
    st = _own(s)
    for k in range(ops.shape[0]):
        # Replicated: the host ring's kinds, and ob_key (a replicated leaf).
        flag = bool((kinds[k] == OpKind.OBLITERATE).any()) or _ob_table_nonempty(st)
        for b in range(ops.shape[1]):
            st = _apply_op_seg(  # int(kinds[...]): the replicated host ring
                st, ops[k, b].expand(n, -1), payloads[k, b].expand(n, -1),
                int(kinds[k, b]), flag, g,
            )
    return st


apply_megastep_seg.launches = 0


def compact_seg(s: DocState, min_seq, group=None) -> DocState:
    """Zamboni on the stacked seg layout: replicated ``set_min_seq``, then
    a shard-local stable compaction (order is preserved within each shard,
    so the global concatenation order is preserved)."""
    count_launch(s.nseg, compact_seg)
    g = _seg_group(s, group)
    m = _as_tensor(min_seq, s.nseg.device).reshape(1).expand(g.rows)
    return _compact(set_min_seq(s, m))


compact_seg.launches = 0


def seg_occupancy(state: DocState) -> np.ndarray:
    """Per-shard live segment counts (the occupancy gauge), of a blocked or
    stacked seg state."""
    nseg = state.nseg
    if isinstance(nseg, torch.Tensor):
        nseg = nseg.cpu().numpy()
    return np.asarray(nseg).astype(np.int64)


# ----------------------------------------------------- host-side seg packing

# Dead-slot fill per per-segment field, shared by seg_shard_state and
# seg_gather_state; the compaction gather's conventions, so gather-after-
# shard is the identity.
_SEG_FILL = {
    "seg_start": 0, "seg_len": 0, "ins_key": 0, "ins_client": -1,
    "seg_uid": -1, "seg_obpre": -1,
    "rem_keys": NO_REMOVE, "rem_clients": -1,
    "prop_keys": -1, "prop_vals": 0,
}


# The per-segment columns.
SEG_COLUMNS = frozenset(_SEG_FILL)


def _seg_map(state: DocState, column, replicated) -> DocState:
    """``column`` on the per-segment columns, ``replicated`` on the
    replicated leaves; ``nseg`` (one live count a shard) as it is."""
    out = {}
    for f in DocState._fields:
        v = getattr(state, f)
        fn = (lambda x: x) if f == "nseg" else column if f in SEG_COLUMNS else replicated
        out[f] = tuple(fn(a) for a in v) if isinstance(v, tuple) else fn(v)
    return DocState(**out)


def seg_stack(state: DocState) -> DocState:
    """The reference's blocked seg layout (per-segment [n * S_local],
    ``nseg`` [n], replicated leaves once) as the lane's stacked state:
    per-segment [n, S_local] by a reshape, every replicated leaf copied to
    n rows, on the input tensors' device."""
    n = int(state.nseg.shape[0])
    return _seg_map(
        state, lambda x: x.reshape(n, -1),
        lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()),
    )


def seg_replica_mismatch(state: DocState) -> list[str]:
    """The replicated leaves whose n copies in a stacked state disagree
    (empty when the replication invariant holds)."""
    bad = []
    for f in DocState._fields:
        v = getattr(state, f)
        if f == "nseg" or f in SEG_COLUMNS:
            continue
        for i, a in enumerate(v if isinstance(v, tuple) else (v,)):
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            if not (a == a[:1]).all():
                bad.append(f if not isinstance(v, tuple) else f"{f}{i}")
    return bad


def seg_unstack(state: DocState) -> DocState:
    """Inverse of ``seg_stack``: the blocked global layout, with row 0 of
    every replicated leaf as its logical value."""
    return _seg_map(state, lambda x: x.reshape(-1), lambda x: x[0])


def _blocked(state: DocState) -> DocState:
    """A seg state in the blocked layout, unstacking a stacked one."""
    return seg_unstack(state) if np.ndim(state.text) == 2 else state


def _seg_repack(state: DocState, pack) -> dict:
    out = {}
    for f, fill in _SEG_FILL.items():
        v = getattr(state, f)
        out[f] = (
            tuple(pack(a, fill) for a in v)
            if isinstance(v, tuple) else pack(v, fill)
        )
    return out


def seg_shard_state(
    state: DocState,
    n_shards: int,
    s_local: int | None = None,
    text_capacity: int | None = None,
) -> DocState:
    """Host re-block of a one-document state into the seg-sharded layout:
    live segments split into ``n_shards`` balanced contiguous runs,
    per-segment columns [n_shards * s_local], ``nseg`` int32[n_shards];
    text pool, scalars and obliterate table copied verbatim.  Returns CPU
    tensors; the plane's ``shard_seg_state`` places them."""
    state = to_numpy(state)
    nseg = int(state.nseg)
    S_old = state.seg_len.shape[0]
    if s_local is None:
        s_local = -(-S_old // n_shards)
    base, extra = divmod(nseg, n_shards)
    counts = [base + (1 if i < extra else 0) for i in range(n_shards)]
    if max(counts) > s_local:
        raise ValueError(
            f"{nseg} live segments do not block into {n_shards} shards of "
            f"{s_local} slots"
        )
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))

    def blk(arr: np.ndarray, fill: int) -> np.ndarray:
        out = np.full((n_shards * s_local,), fill, np.int32)
        for i in range(n_shards):
            out[i * s_local : i * s_local + counts[i]] = arr[
                starts[i] : starts[i] + counts[i]
            ]
        return out

    T_old = state.text.shape[0]
    T = text_capacity if text_capacity is not None else T_old
    if T < int(state.text_end):
        raise ValueError(f"text_capacity {T} < text_end {int(state.text_end)}")
    text = np.zeros((T,), np.int32)
    keep = min(T, T_old)
    text[:keep] = state.text[:keep]
    return from_numpy(state._replace(
        text=text,
        nseg=np.asarray(counts, np.int32),
        **_seg_repack(state, blk),
    ), device="cpu")


def seg_gather_state(state: DocState, max_segments: int | None = None) -> DocState:
    """Inverse of ``seg_shard_state``: the per-shard live prefixes
    concatenated back into one document in global segment order (a stacked
    lane state gathers through ``seg_unstack``)."""
    state = to_numpy(_blocked(state))
    counts = state.nseg.astype(np.int64)
    n_shards = int(counts.shape[0])
    s_local = state.seg_len.shape[0] // n_shards
    total = int(counts.sum())
    S = max_segments if max_segments is not None else state.seg_len.shape[0]
    if total > S:
        raise ValueError(f"{total} live segments exceed capacity {S}")

    def gat(arr: np.ndarray, fill: int) -> np.ndarray:
        out = np.full((S,), fill, np.int32)
        w = 0
        for i in range(n_shards):
            c = int(counts[i])
            out[w : w + c] = arr[i * s_local : i * s_local + c]
            w += c
        return out

    return from_numpy(state._replace(
        nseg=np.asarray(total, np.int32),
        **_seg_repack(state, gat),
    ), device="cpu")


def seg_rebalance_state(
    state: DocState, s_local: int | None = None, text_capacity: int | None = None
) -> DocState:
    """Re-block a seg-sharded state evenly (gather + re-shard; order- and
    byte-preserving); a stacked lane state is unstacked first."""
    state = _blocked(state)
    n_shards = int(state.nseg.shape[0])
    if s_local is None:
        s_local = state.seg_len.shape[0] // n_shards
    return seg_shard_state(seg_gather_state(state), n_shards, s_local, text_capacity)


# ------------------------------------------------------------ host views

def canonical_doc(state: DocState) -> dict:
    """The live content of a one-document state as numpy (padding slots
    excluded) — the byte-identity surface of the segment lane."""
    state = to_numpy(state)
    n = int(state.nseg)
    te = int(state.text_end)
    out = {
        "text": state.text[:te].copy(),
        "text_end": te,
        "nseg": n,
        "uid_next": int(state.uid_next),
        "min_seq": int(state.min_seq),
        "error": int(state.error),
        "ob_key": state.ob_key.copy(),
        "ob_client": state.ob_client.copy(),
        "ob_start_uid": state.ob_start_uid.copy(),
        "ob_end_uid": state.ob_end_uid.copy(),
        "ob_start_side": state.ob_start_side.copy(),
        "ob_end_side": state.ob_end_side.copy(),
        "ob_ref_seq": state.ob_ref_seq.copy(),
    }
    for name in (
        "seg_start", "seg_len", "ins_key", "ins_client", "seg_uid", "seg_obpre"
    ):
        out[name] = getattr(state, name)[:n].copy()
    for name in ("rem_keys", "rem_clients", "prop_keys", "prop_vals"):
        for i, a in enumerate(getattr(state, name)):
            out[f"{name}{i}"] = a[:n].copy()
    return out


def _host_vis(s: DocState, ref_seq: int, view_client: int):
    nseg = int(s.nseg)
    ins_key = s.ins_key[:nseg]
    ins_client = s.ins_client[:nseg]
    rem_keys = np.stack([a[:nseg] for a in s.rem_keys])
    rem_clients = np.stack([a[:nseg] for a in s.rem_clients])
    ins_occ = (ins_key <= ref_seq) | (ins_client == view_client)
    # Padding slots (NO_REMOVE / client -1) never match: a pure observer
    # legitimately views as client -1.
    rem_valid = rem_keys != NO_REMOVE
    rem_occ = (
        rem_valid & ((rem_keys <= ref_seq) | (rem_clients == view_client))
    ).any(axis=0)
    return nseg, ins_occ & ~rem_occ


def visible_text(
    s: DocState, ref_seq: int = ALL_ACKED, view_client: int = -3,
    raw: bool = False,
) -> str:
    """The perspective-visible text of one document, on the host (marker
    codepoints filtered unless ``raw``)."""
    s = to_numpy(s)
    nseg, vis = _host_vis(s, ref_seq, view_client)
    start = s.seg_start[:nseg]
    length = s.seg_len[:nseg]
    parts = [
        "".join(
            chr(c)
            for c in s.text[start[i] : start[i] + length[i]]
            if raw or not MARKER_CP_BASE <= c < MARKER_CP_END
        )
        for i in range(nseg)
        if vis[i]
    ]
    return "".join(parts)


def visible_length(s: DocState, ref_seq: int = ALL_ACKED, view_client: int = -3) -> int:
    """Perspective-visible character count of one document."""
    s = to_numpy(s)
    nseg, vis = _host_vis(s, ref_seq, view_client)
    length = s.seg_len[:nseg]
    return int(length[vis[:nseg]].sum()) if nseg else 0


def annotations(
    s: DocState, ref_seq: int = ALL_ACKED, view_client: int = -3
) -> list[dict[int, int]]:
    """Per visible character: {prop_slot: value}."""
    s = to_numpy(s)
    nseg, vis = _host_vis(s, ref_seq, view_client)
    length = s.seg_len[:nseg]
    prop_keys = np.stack([a[:nseg] for a in s.prop_keys])
    prop_vals = np.stack([a[:nseg] for a in s.prop_vals])
    out: list[dict[int, int]] = []
    for i in range(nseg):
        if not vis[i]:
            continue
        props = {
            p: int(prop_vals[p, i])
            for p in range(prop_keys.shape[0])
            if prop_keys[p, i] >= 0
        }
        out.extend(props for _ in range(length[i]))
    return out
