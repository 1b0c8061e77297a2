"""Host adapter: a SharedString replica on the merge-tree device programs.

The port of ``fluidframework_tpu/dds/kernel_backend.py``.  Two halves:

- the summary codec (``_Seg``, ``_Ob``, ``pull_segments``,
  ``pull_obliterates``, ``state_to_summary``, ``summary_to_state``,
  ``summary_to_state_host``, ``state_geometry``): the checkpoint/restore
  primitives of the fleet engine.  Any packed one-document state — a batch
  row, an overflow lane, a restored checkpoint — round-trips through the
  same summary schema as ``RefMergeTree.export_summary``, and a summary
  written by either package restores in the other.  Every value in a
  summary is a Python int or str, so ``json.dumps`` gives the same bytes
  as the reference's.
- ``KernelMergeTree``: the full merge-tree backend protocol over one
  document's ``DocState`` on ``device`` — the backend a
  ``SharedStringChannel`` takes in place of ``RefMergeTree`` (the channel
  boundary).  Ops apply on the device (``mk.apply_op``, one call an op
  row); queries are host walks over a snapshot of the live columns, pulled
  once per state change; reconnect regeneration plans the re-minted ops
  on the host and re-stamps the affected segments on the device (K5:
  ``mk.restamp``, ``mk.drop_squashed``, ``mk.strip_stamp``).

States may hold torch tensors on any device or numpy arrays: the readers
pull them to the host once (``mk.to_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import mergetree_kernel as mk
from ..protocol.stamps import (
    ALL_ACKED,
    LOCAL_BASE,
    NO_REMOVE,
    NON_COLLAB_CLIENT,
    acked as _acked,
)


@dataclass
class _Seg:
    """Host mirror of one device segment (decoded columnar row)."""

    uid: int
    length: int
    ins_key: int
    ins_client: int
    obpre: int
    removes: list[tuple[int, int]]            # sorted (key, client)
    props: dict[int, tuple[int, int]] = field(default_factory=dict)  # slot -> (val, key)
    text: str | None = None

    def visible(self, ref_seq: int, view_client: int) -> bool:
        if not (self.ins_key <= ref_seq or self.ins_client == view_client):
            return False
        return not any(
            k <= ref_seq or c == view_client for k, c in self.removes
        )


@dataclass
class _Ob:
    """Host mirror of one obliterate-table record."""

    slot: int
    key: int
    client: int
    start_uid: int
    start_side: int
    end_uid: int
    end_side: int
    ref_seq: int


# ---------------------------------------------------------------------------
# Standalone DocState <-> host snapshot / summary converters.  These are the
# checkpoint/restore primitives shared by the single-doc backend below and
# the batched engines (models/doc_batch_engine.py): any packed ``DocState``
# row — batch slot, overflow lane, or restored checkpoint — round-trips
# through the same summary JSON schema as RefMergeTree.export_summary.
# ---------------------------------------------------------------------------


def pull_segments(state: mk.DocState, with_text: bool = False) -> list[_Seg]:
    """Pull the live segment rows of one DocState off device as host records."""
    s = mk.to_numpy(state)
    nseg = int(s.nseg)
    seg_uid = np.asarray(s.seg_uid)[:nseg]
    seg_len = np.asarray(s.seg_len)[:nseg]
    ins_key = np.asarray(s.ins_key)[:nseg]
    ins_client = np.asarray(s.ins_client)[:nseg]
    obpre = np.asarray(s.seg_obpre)[:nseg]
    rem_k = np.stack([np.asarray(a)[:nseg] for a in s.rem_keys]) if nseg else None
    rem_c = np.stack([np.asarray(a)[:nseg] for a in s.rem_clients]) if nseg else None
    prop_k = np.stack([np.asarray(a)[:nseg] for a in s.prop_keys]) if nseg else None
    prop_v = np.stack([np.asarray(a)[:nseg] for a in s.prop_vals]) if nseg else None
    texts: list[str | None] = [None] * nseg
    if with_text and nseg:
        pool = np.asarray(s.text)
        start = np.asarray(s.seg_start)[:nseg]
        texts = [
            "".join(chr(c) for c in pool[start[i] : start[i] + seg_len[i]])
            for i in range(nseg)
        ]
    out: list[_Seg] = []
    for i in range(nseg):
        removes = sorted(
            (int(rem_k[r, i]), int(rem_c[r, i]))
            for r in range(rem_k.shape[0])
            if rem_k[r, i] != NO_REMOVE
        )
        props = {
            p: (int(prop_v[p, i]), int(prop_k[p, i]))
            for p in range(prop_k.shape[0])
            if prop_k[p, i] >= 0
        }
        out.append(
            _Seg(
                uid=int(seg_uid[i]),
                length=int(seg_len[i]),
                ins_key=int(ins_key[i]),
                ins_client=int(ins_client[i]),
                obpre=int(obpre[i]),
                removes=removes,
                props=props,
                text=texts[i],
            )
        )
    return out


def pull_obliterates(state: mk.DocState) -> list[_Ob]:
    s = mk.to_numpy(state)
    keys = np.asarray(s.ob_key)
    out = []
    for i in range(keys.shape[0]):
        if keys[i] >= 0:
            out.append(
                _Ob(
                    slot=i,
                    key=int(keys[i]),
                    client=int(np.asarray(s.ob_client)[i]),
                    start_uid=int(np.asarray(s.ob_start_uid)[i]),
                    start_side=int(np.asarray(s.ob_start_side)[i]),
                    end_uid=int(np.asarray(s.ob_end_uid)[i]),
                    end_side=int(np.asarray(s.ob_end_side)[i]),
                    ref_seq=int(np.asarray(s.ob_ref_seq)[i]),
                )
            )
    return out


def state_to_summary(
    state: mk.DocState,
    prop_names: dict[int, object] | None = None,
    slice_keys: set[int] | None = None,
) -> dict:
    """One document's DocState -> summary JSON (identical schema to
    RefMergeTree.export_summary).  ``prop_names`` maps kernel prop slot ->
    property id; missing slots keep their slot number as the id."""
    state = mk.to_numpy(state)
    segs = pull_segments(state, with_text=True)
    prop_names = prop_names or {}
    out_segs = []
    for seg in segs:
        if not _acked(seg.ins_key) or any(not _acked(k) for k, _c in seg.removes):
            raise RuntimeError("summarize with pending merge-tree state")
        out_segs.append(
            {
                "text": seg.text,
                "ins": [seg.ins_key, seg.ins_client],
                "removes": [[k, c] for k, c in seg.removes],
                "props": {
                    str(prop_names.get(p, p)): [v, k]
                    for p, (v, k) in sorted(seg.props.items())
                },
            }
        )
    uid_index = {seg.uid: i for i, seg in enumerate(segs)}
    obs = []
    for ob in sorted(pull_obliterates(state), key=lambda o: o.key):
        if not _acked(ob.key):
            raise RuntimeError("summarize with pending merge-tree state")
        obs.append(
            {
                "key": ob.key,
                "client": ob.client,
                "start": uid_index.get(ob.start_uid, -1),
                "startSide": ob.start_side,
                "end": uid_index.get(ob.end_uid, -1),
                "endSide": ob.end_side,
                "refSeq": ob.ref_seq,
            }
        )
    live = {k for seg in segs for k, _c in seg.removes} | {o["key"] for o in obs}
    return {
        "segments": out_segs,
        "obliterates": obs,
        "minSeq": int(state.min_seq),
        "sliceKeys": sorted((slice_keys or set()) & live),
    }


def summary_to_state(
    summary: dict, geometry: dict, slot_for, device=DEFAULT_DEVICE
) -> mk.DocState:
    """Summary JSON -> a fresh DocState packed at ``geometry`` (the
    checkpoint-restore and grow-replay base).  ``slot_for(prop_id)`` interns
    a property id to a kernel prop slot — callers keep their own table so
    later ops encode against the same slots.  Raises ValueError when the
    summary does not fit the geometry (callers grow and retry).  The state
    is one document on ``device``."""
    return mk.from_numpy(
        summary_to_state_host(summary, geometry, slot_for), device=device
    )


def summary_to_state_host(summary: dict, geometry: dict, slot_for) -> mk.DocState:
    """``summary_to_state`` with the leaves left as HOST numpy arrays: the
    batched parallel restore packs many docs' rows host-side, stacks them,
    and ships ONE transfer + ONE scatter dispatch instead of a per-doc
    device round-trip (``DocBatchEngine.restore_from_checkpoints``).
    Byte-identical content to ``summary_to_state`` by construction (that
    wrapper is ``mk.from_numpy`` over this)."""
    S = geometry["max_segments"]
    T = geometry["text_capacity"]
    R = geometry["remove_slots"]
    P = geometry["prop_slots"]
    OB = geometry["ob_slots"]
    entries = summary["segments"]
    obs = summary.get("obliterates", [])
    if any("attr" in e for e in entries):
        raise ValueError(
            "kernel state cannot carry attribution override runs; "
            "load this summary into the oracle backend"
        )
    if len(entries) > S:
        raise ValueError(f"summary has {len(entries)} segments > capacity {S}")
    if len(obs) > OB:
        raise ValueError(f"summary has {len(obs)} obliterates > capacity {OB}")

    text_pool = np.zeros((T,), np.int32)
    seg_start = np.zeros((S,), np.int32)
    seg_len = np.zeros((S,), np.int32)
    ins_key = np.zeros((S,), np.int32)
    ins_client = np.full((S,), -1, np.int32)
    seg_uid = np.full((S,), -1, np.int32)
    rem_keys = np.full((R, S), NO_REMOVE, np.int32)
    rem_clients = np.full((R, S), -1, np.int32)
    prop_keys = np.full((P, S), -1, np.int32)
    prop_vals = np.zeros((P, S), np.int32)
    end = 0
    for i, e in enumerate(entries):
        txt = e["text"]
        if end + len(txt) > T:
            raise ValueError("summary text exceeds pool capacity")
        text_pool[end : end + len(txt)] = [ord(ch) for ch in txt]
        seg_start[i] = end
        seg_len[i] = len(txt)
        end += len(txt)
        ins_key[i] = e["ins"][0]
        ins_client[i] = e["ins"][1]
        seg_uid[i] = i
        if len(e["removes"]) > R:
            raise ValueError("summary removes exceed remove slots")
        for r, (k, c) in enumerate(e["removes"]):
            rem_keys[r, i] = k
            rem_clients[r, i] = c
        for p_str, (v, k) in e["props"].items():
            slot = slot_for(int(p_str))
            prop_keys[slot, i] = k
            prop_vals[slot, i] = v

    ob_key = np.full((OB,), -1, np.int32)
    ob_client = np.full((OB,), -1, np.int32)
    ob_start_uid = np.full((OB,), -1, np.int32)
    ob_end_uid = np.full((OB,), -1, np.int32)
    ob_start_side = np.zeros((OB,), np.int32)
    ob_end_side = np.zeros((OB,), np.int32)
    ob_ref_seq = np.full((OB,), -1, np.int32)
    for j, o in enumerate(obs):
        ob_key[j] = o["key"]
        ob_client[j] = o["client"]
        ob_start_uid[j] = o["start"]
        ob_end_uid[j] = o["end"]
        ob_start_side[j] = o["startSide"]
        ob_end_side[j] = o["endSide"]
        ob_ref_seq[j] = o["refSeq"]

    return mk.DocState(
        text=text_pool,
        text_end=np.asarray(end, np.int32),
        nseg=np.asarray(len(entries), np.int32),
        seg_start=seg_start,
        seg_len=seg_len,
        ins_key=ins_key,
        ins_client=ins_client,
        seg_uid=seg_uid,
        seg_obpre=np.full((S,), -1, np.int32),
        rem_keys=tuple(rem_keys[r] for r in range(R)),
        rem_clients=tuple(rem_clients[r] for r in range(R)),
        prop_keys=tuple(prop_keys[p] for p in range(P)),
        prop_vals=tuple(prop_vals[p] for p in range(P)),
        uid_next=np.asarray(len(entries), np.int32),
        ob_key=ob_key,
        ob_client=ob_client,
        ob_start_uid=ob_start_uid,
        ob_end_uid=ob_end_uid,
        ob_start_side=ob_start_side,
        ob_end_side=ob_end_side,
        ob_ref_seq=ob_ref_seq,
        min_seq=np.asarray(summary["minSeq"], np.int32),
        error=np.zeros((), np.int32),
    )


def state_geometry(state: mk.DocState) -> dict[str, int]:
    """The capacity axes of a packed DocState (engine geometry dict shape)."""
    return {
        "max_segments": int(state.seg_len.shape[0]),
        "text_capacity": int(state.text.shape[0]),
        "remove_slots": len(state.rem_keys),
        "prop_slots": len(state.prop_keys),
        "ob_slots": int(state.ob_key.shape[0]),
    }


def pull_live(state: mk.DocState) -> mk.DocState:
    """One document's state on the host, its per-segment columns cut to the
    live prefix and its text pool to ``text_end`` (every host reader above
    reads no further).  From a device: two reads — the two counts, then
    every live column in one transfer."""
    if not isinstance(state.nseg, torch.Tensor):
        return mk.to_numpy(state)
    n, te = torch.stack([state.nseg, state.text_end]).tolist()
    R, P = len(state.rem_keys), len(state.prop_keys)
    seg_cols = [state.seg_start, state.seg_len, state.ins_key, state.ins_client,
                state.seg_uid, state.seg_obpre, *state.rem_keys, *state.rem_clients,
                *state.prop_keys, *state.prop_vals]
    ob_cols = [state.ob_key, state.ob_client, state.ob_start_uid, state.ob_end_uid,
               state.ob_start_side, state.ob_end_side, state.ob_ref_seq]
    scalars = torch.stack([state.uid_next, state.min_seq, state.error])
    flat = torch.cat([c[:n] for c in seg_cols] + [state.text[:te]] + ob_cols
                     + [scalars]).cpu().numpy()
    OB = state.ob_key.shape[-1]
    segs = [flat[i * n : (i + 1) * n] for i in range(len(seg_cols))]
    at = len(seg_cols) * n
    text = flat[at : at + te]
    at += te
    obs = [flat[at + i * OB : at + (i + 1) * OB] for i in range(len(ob_cols))]
    uid_next, min_seq, error = flat[at + len(ob_cols) * OB :]
    return mk.DocState(
        text=text, text_end=np.asarray(te, np.int32), nseg=np.asarray(n, np.int32),
        seg_start=segs[0], seg_len=segs[1], ins_key=segs[2], ins_client=segs[3],
        seg_uid=segs[4], seg_obpre=segs[5],
        rem_keys=tuple(segs[6 : 6 + R]), rem_clients=tuple(segs[6 + R : 6 + 2 * R]),
        prop_keys=tuple(segs[6 + 2 * R : 6 + 2 * R + P]),
        prop_vals=tuple(segs[6 + 2 * R + P :]),
        uid_next=np.asarray(uid_next), ob_key=obs[0], ob_client=obs[1],
        ob_start_uid=obs[2], ob_end_uid=obs[3], ob_start_side=obs[4],
        ob_end_side=obs[5], ob_ref_seq=obs[6], min_seq=np.asarray(min_seq),
        error=np.asarray(error),
    )


def _excl(x: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum (int64)."""
    c = np.cumsum(x, dtype=np.int64)
    return c - x


class KernelMergeTree:
    """Single-doc merge-tree replica on the device programs.

    Runs on ``device`` (default the card; a machine without one raises,
    and the CPU is used only when the caller passes ``device="cpu"``).
    The device state is ``state`` (one document's leaves); every
    replacement bumps ``_gen``, which keys the host snapshot of the live
    columns (``pull_live``), the segment records and the marker cache, so
    a run of queries against an unchanged replica costs one readback."""

    def __init__(
        self,
        max_segments: int = 512,
        remove_slots: int = 4,
        prop_slots: int = 4,
        text_capacity: int = 8192,
        max_insert_len: int = 64,
        ob_slots: int = 8,
        local_client: int = -3,
        device=DEFAULT_DEVICE,
    ) -> None:
        self.device = resolve_device(device)
        self._gen = 0
        self._snap_cache: tuple | None = None
        self._segs_cache: tuple | None = None
        self.state = mk.init_state(
            max_segments, remove_slots, prop_slots, text_capacity, ob_slots,
            device=self.device,
        )
        self.max_insert_len = max_insert_len
        self.local_client = local_client
        self._empty_payload = np.zeros((max_insert_len,), np.int32)
        # Host-interned property ids -> kernel prop slots.
        self._prop_slot: dict[int, int] = {}
        # Stamp keys minted by regenerate_pending during a reconnect replay
        # (see mergetree_ref.RefMergeTree._regenerated_keys).
        self._regenerated_keys: set[int] = set()
        # Obliterate stamp keys, outliving the window record — mirrors
        # RefMergeTree.slice_keys so summaries stay schema-identical
        # across backends (v2 sliceKeys field).
        self.slice_keys: set[int] = set()
        # Wire ops re-minted by regenerate_pending (a gauge; the reference
        # keeps none).
        self.regenerated = 0
        # The collab window's floor as this replica last read or set it
        # (the host half of the obliterate gate, ``_ob_flag``).
        self._min_seq = 0

    @property
    def state(self) -> mk.DocState:
        return self._state

    @state.setter
    def state(self, value: mk.DocState) -> None:
        self._state = value
        self._gen += 1

    # ------------------------------------------------------------------ utils
    def _op(self, kind, key=0, client=-1, ref_seq=0, pos1=0, pos2=0, a=0, b=0):
        return np.array(
            [kind, key, client, ref_seq, pos1, pos2, a, b], np.int32
        )

    def _ob_flag(self) -> bool:
        """The obliterate gate from the host: every live obliterate record
        carries a key in ``slice_keys`` (pending, or acked above the
        collab window's floor, which expires it), so no key there above
        ``_min_seq`` means an empty table.  ``_min_seq`` may lag the
        state's (it is the last floor this replica read or set), which
        only leaves the gate on."""
        return max(self.slice_keys, default=self._min_seq) > self._min_seq

    def _step(self, op, payload=None) -> None:
        p = self._empty_payload if payload is None else payload
        self.state = mk.apply_op(
            self.state, op, p,
            ob_flag=op[0] == mk.OpKind.OBLITERATE or self._ob_flag(),
        )

    def check_errors(self) -> int:
        return int(self.state.error)

    def _slot_for(self, prop: int) -> int:
        if prop not in self._prop_slot:
            slot = len(self._prop_slot)
            if slot >= len(self.state.prop_keys):
                raise ValueError(f"out of prop slots for prop id {prop}")
            self._prop_slot[prop] = slot
        return self._prop_slot[prop]

    # --------------------------------------------------------------- snapshot
    def _snap(self) -> mk.DocState:
        """The live columns on the host, pulled once per state."""
        if self._snap_cache is None or self._snap_cache[0] != self._gen:
            self._snap_cache = (self._gen, pull_live(self.state))
        return self._snap_cache[1]

    def _segs(self, with_text: bool = False) -> list[_Seg]:
        """The live segment rows as host records (cached per state; a list
        with text serves a request without)."""
        c = self._segs_cache
        if c is None or c[0] != self._gen or (with_text and not c[1]):
            c = self._segs_cache = (self._gen, with_text, pull_segments(self._snap(), with_text))
        return c[2]

    def _obs(self) -> list[_Ob]:
        return pull_obliterates(self._snap())

    def _vis(self, ref_seq: int, view_client: int) -> np.ndarray:
        return mk._host_vis(self._snap(), ref_seq, view_client)[1]

    def _stamp_uids(self, op_key: int, op_client: int) -> dict[int, int]:
        """uid -> number of remove slots carrying exactly (op_key, op_client)."""
        s = self._snap()
        n = int(s.nseg)
        if n == 0:
            return {}
        counts = np.zeros((n,), np.int64)
        for k, c in zip(s.rem_keys, s.rem_clients):
            counts += (k[:n] == op_key) & (c[:n] == op_client)
        uid = s.seg_uid[:n]
        return {int(uid[i]): int(counts[i]) for i in np.flatnonzero(counts)}

    # ---------------------------------------------------------------- backend
    def apply_insert(self, pos, text, op_key, op_client, ref_seq) -> list[int]:
        """Apply an insert; returns the uids of the created segments (the
        channel's converged-event handles)."""
        # An insert chunk fails iff one of these latches (ERR_REM_OVERFLOW
        # can accompany a SUCCESSFUL insert — swallow-candidate overflow);
        # once any is latched the state is unreliable, so stop attributing.
        fail_bits = mk.ERR_SEG_OVERFLOW | mk.ERR_TEXT_OVERFLOW | mk.ERR_POS_RANGE
        uids: list[int] = []
        for op, payload in mk.encode_insert(
            pos, text, op_key, op_client, ref_seq, self.max_insert_len
        ):
            self._step(op, payload)
            error, uid_next = torch.stack([self.state.error, self.state.uid_next]).tolist()
            if error & fail_bits == 0:
                # The new segment's uid is always the last allocation of the
                # chunk's apply (the boundary split allocates first).
                uids.append(uid_next - 1)
        return uids

    def apply_remove(self, pos1, pos2, op_key, op_client, ref_seq) -> list[int]:
        before = self._stamp_uids(op_key, op_client)
        self._step(
            self._op(
                mk.OpKind.REMOVE, key=op_key, client=op_client, ref_seq=ref_seq,
                pos1=pos1, pos2=pos2,
            )
        )
        after = self._stamp_uids(op_key, op_client)
        return [u for u, n in after.items() if n > before.get(u, 0)]

    def apply_obliterate(self, pos1, side1, pos2, side2, op_key, op_client, ref_seq) -> list[int]:
        before = self._stamp_uids(op_key, op_client)
        self._step(
            mk.encode_obliterate(pos1, side1, pos2, side2, op_key, op_client, ref_seq)
        )
        self.slice_keys.add(op_key)
        after = self._stamp_uids(op_key, op_client)
        return [u for u, n in after.items() if n > before.get(u, 0)]

    def apply_annotate(self, pos1, pos2, prop, value, op_key, op_client, ref_seq) -> None:
        self._step(
            self._op(
                mk.OpKind.ANNOTATE, key=op_key, client=op_client, ref_seq=ref_seq,
                pos1=pos1, pos2=pos2, a=self._slot_for(prop), b=value,
            )
        )

    def ack(self, local_seq, seq, client=None, ref_seq=None):
        """Convert pending stamps with this localSeq to the acked seq
        (re-stamping client id / obliterate refSeq when given — see
        mergetree_ref.RefMergeTree.ack).  Returns (inserted_uids,
        removed_uids) for the channel's converged events."""
        local_key = LOCAL_BASE + local_seq
        self._regenerated_keys.discard(local_key)
        if local_key in self.slice_keys:
            self.slice_keys.discard(local_key)
            self.slice_keys.add(seq)
        s = self._snap()
        n = int(s.nseg)
        ins_uids: list[int] = []
        rem_uids: list[int] = []
        if n:
            uid = s.seg_uid[:n]
            rem_hit = np.zeros((n,), bool)
            for k in s.rem_keys:
                rem_hit |= k[:n] == local_key
            ins_uids = [int(u) for u in uid[s.ins_key[:n] == local_key]]
            rem_uids = [int(u) for u in uid[rem_hit]]
        self._step(
            self._op(
                mk.OpKind.ACK,
                client=-1 if client is None else client,
                ref_seq=-1 if ref_seq is None else ref_seq,
                a=local_seq, b=seq,
            )
        )
        return ins_uids, rem_uids

    def update_min_seq(self, min_seq) -> None:
        """Advance the collab window and run zamboni (K3, over one doc)."""
        self._min_seq = int(self.state.min_seq)
        if min_seq > self._min_seq:
            batch = mk.set_min_seq(mk.one_doc_batch(self.state), [min_seq])
            self._min_seq = min_seq
            self.state = mk.doc_row(mk.compact(batch, self._ob_flag()), 0)

    # ------------------------------------------------------------------ views
    def visible_text(
        self,
        ref_seq: int = ALL_ACKED,
        view_client: int | None = None,
        raw: bool = False,
    ) -> str:
        vc = self.local_client if view_client is None else view_client
        return mk.visible_text(self._snap(), ref_seq, vc, raw=raw)

    def visible_length(self, ref_seq: int = ALL_ACKED, view_client: int | None = None) -> int:
        vc = self.local_client if view_client is None else view_client
        return mk.visible_length(self._snap(), ref_seq, vc)

    def annotations(self, ref_seq: int = ALL_ACKED, view_client: int | None = None):
        vc = self.local_client if view_client is None else view_client
        raw = mk.annotations(self._snap(), ref_seq, vc)
        inv = {v: k for k, v in self._prop_slot.items()}
        return [{inv[p]: v for p, v in d.items()} for d in raw]

    def marker_scan(
        self, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ) -> list[tuple[int, int, dict]]:
        """Visible markers as (position, refType, {prop_id: value_id}) —
        same shape as RefMergeTree.marker_scan (markers are ordinary
        1-char segments in the columns; only this host query decodes
        them).  Cached per mutation generation, so repeated queries
        against an unchanged replica (id lookup, tile search) cost one
        readback, and the cache never pins a superseded state."""
        from .markers import is_marker_text, marker_ref_type

        vc = self.local_client if view_client is None else view_client
        gen = self._gen
        cached = getattr(self, "_marker_cache", None)
        if cached is not None and cached[0] == (gen, ref_seq, vc):
            return cached[1]
        inv = {v: k for k, v in self._prop_slot.items()}
        out: list[tuple[int, int, dict]] = []
        pos = 0
        for seg in self._segs(with_text=True):
            if not seg.visible(ref_seq, vc):
                continue
            if is_marker_text(seg.text):
                out.append((
                    pos,
                    marker_ref_type(seg.text),
                    {inv[p]: v for p, (v, _k) in seg.props.items()},
                ))
            pos += seg.length
        self._marker_cache = ((gen, ref_seq, vc), out)
        return out

    def attribution_runs(
        self, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ):
        """Run-length insert attribution over the visible text: the device
        columns ins_key/ins_client are the attribution data.  Same shape as
        RefMergeTree.attribution_runs: [(start, key)], key = acked seq or
        {"type": "local"}."""
        vc = self.local_client if view_client is None else view_client
        runs: list[tuple[int, object]] = []
        pos = 0
        for seg in self._segs():
            if not seg.visible(ref_seq, vc):
                continue
            key = (
                seg.ins_key if seg.ins_key < LOCAL_BASE else {"type": "local"}
            )
            if not runs or runs[-1][1] != key:
                runs.append((pos, key))
            pos += seg.length
        return runs

    def attribution_at(
        self, pos: int, ref_seq: int = ALL_ACKED, view_client: int | None = None
    ):
        from .mergetree_ref import attribution_key_at

        vc = self.local_client if view_client is None else view_client
        if not 0 <= pos < self.visible_length(ref_seq, vc):
            raise ValueError(f"attribution offset {pos} out of range")
        return attribution_key_at(self.attribution_runs(ref_seq, vc), pos)

    # ----------------------------------------------------- converged queries
    # mergetree_ref's converged-coordinate walks (the coordinates interval
    # collections and undo ranges live in), as prefix sums over the live
    # columns: each walk's running offsets are exclusive cumsums of the
    # lengths it advances by.

    @staticmethod
    def _flatten_uids(segs) -> set[int]:
        out: set[int] = set()
        for x in segs:
            if isinstance(x, (list, tuple, set)):
                out.update(int(u) for u in x)
            else:
                out.add(int(x))
        return out

    def _lengths(self) -> np.ndarray:
        s = self._snap()
        return s.seg_len[: int(s.nseg)].astype(np.int64)

    def _uid_in(self, uids) -> np.ndarray:
        s = self._snap()
        return np.isin(s.seg_uid[: int(s.nseg)], np.fromiter(uids, np.int64))

    def converged_position(self, pos: int, ref_seq: int, view_client: int) -> int:
        length = self._lengths()
        p_len = np.where(self._vis(ref_seq, view_client), length, 0)
        c_vis = self._vis(ALL_ACKED, NON_COLLAB_CLIENT)
        c_len = np.where(c_vis, length, 0)
        p_incl = np.cumsum(p_len)
        # The walk stops at the first segment whose perspective span
        # holds ``pos``.
        i = int(np.searchsorted(p_incl, pos, side="right"))
        if i < len(length):
            rem = pos - int(p_incl[i] - p_len[i])
            return int(_excl(c_len)[i]) + (rem if c_vis[i] else 0)
        if pos == int(p_len.sum()):
            return int(c_len.sum())
        raise ValueError(f"position {pos} beyond perspective-visible length")

    def converged_insert_ranges(self, segs) -> list[tuple[int, int]]:
        length = self._lengths()
        c_vis = self._vis(ALL_ACKED, NON_COLLAB_CLIENT)
        pos = _excl(np.where(c_vis, length, 0))
        hit = c_vis & self._uid_in(self._flatten_uids(segs))
        return [(int(pos[i]), int(length[i])) for i in np.flatnonzero(hit)]

    def converged_removed_ranges(self, segs, op_key: int) -> list[tuple[int, int]]:
        s = self._snap()
        n = int(s.nseg)
        length = self._lengths()
        ins_acked = s.ins_key[:n] < LOCAL_BASE
        rk = np.stack([k[:n] for k in s.rem_keys])
        acked_rem = (rk != NO_REMOVE) & (rk < LOCAL_BASE)
        newly = self._uid_in(self._flatten_uids(segs)) & (~acked_rem | (rk == op_key)).all(0)
        alive = ~acked_rem.any(0)
        pos = _excl(np.where(ins_acked & (newly | alive), length, 0))
        return [(int(pos[i]), int(length[i])) for i in np.flatnonzero(ins_acked & newly)]

    def converged_to_local(self, pos: int) -> int:
        length = self._lengths()
        c_vis = self._vis(ALL_ACKED, NON_COLLAB_CLIENT)
        l_vis = self._vis(ALL_ACKED, self.local_client)
        c_len = np.where(c_vis, length, 0)
        l_len = np.where(l_vis, length, 0)
        hit = np.flatnonzero(c_vis & (pos < np.cumsum(c_len)))
        if hit.size:
            i = hit[0]
            loc = int(_excl(l_len)[i])
            return loc + (pos - int(_excl(c_len)[i])) if l_vis[i] else loc
        return int(l_len.sum())

    def converged_spans_to_local(self, start: int, end: int) -> list[tuple[int, int]]:
        length = self._lengths()
        c_vis = self._vis(ALL_ACKED, NON_COLLAB_CLIENT)
        l_vis = self._vis(ALL_ACKED, self.local_client)
        conv = _excl(np.where(c_vis, length, 0))
        loc = _excl(np.where(l_vis, length, 0))
        o1 = np.maximum(start, conv)
        o2 = np.minimum(end, conv + length)
        spans: list[list[int]] = []
        for i in np.flatnonzero(c_vis & l_vis & (o1 < o2)):
            s0 = int(loc[i] + (o1[i] - conv[i]))
            e0 = int(loc[i] + (o2[i] - conv[i]))
            if spans and spans[-1][1] == s0:
                spans[-1][1] = e0
            else:
                spans.append([s0, e0])
        return [(s, e) for s, e in spans]

    # --------------------------------------------------------------- reconnect
    def _squashed(self, seg: _Seg) -> bool:
        return not _acked(seg.ins_key) and any(
            not _acked(k) for k, _c in seg.removes
        )

    def _occurred_before(self, key: int, max_key: int) -> bool:
        return _acked(key) or key < max_key or key in self._regenerated_keys

    def _visible_at_prefix(
        self, seg: _Seg, max_key: int, exclude_key: int, squash: bool = False
    ) -> bool:
        if squash and self._squashed(seg):
            return False
        if not self._occurred_before(seg.ins_key, max_key):
            return False
        return not any(
            self._occurred_before(key, max_key) and key != exclude_key
            for key, _client in seg.removes
        )

    def _restamp(
        self, uids: set[int] | None, old_key: int, fresh_key: int,
        new_client: int | None, cls: str, live_uid: np.ndarray | None = None,
    ) -> None:
        """Device-side selective re-stamp of one plan's segments (K5).
        ``live_uid``: the live uid column, when the caller holds it (a
        restamp never moves a segment, so one read serves every plan)."""
        S = self.state.seg_len.shape[0]
        if uids is None:
            mask = np.ones((S,), bool)
        else:
            if live_uid is None:
                s = self._snap()
                live_uid = s.seg_uid[: int(s.nseg)]
            mask = np.zeros((S,), bool)
            mask[: live_uid.shape[0]] = np.isin(live_uid, np.fromiter(uids, np.int64))
        self.state = mk.restamp(
            self.state,
            mask,
            old_key,
            fresh_key,
            -1 if new_client is None else new_client,
            cls == "ins",
            cls in ("rem", "ob"),
            cls == "prop",
            cls == "ob",
        )

    def regenerate_pending(
        self,
        local_seq: int,
        new_local_seq,
        squash: bool = False,
        new_client: int | None = None,
    ) -> list[tuple[int, dict]]:
        """Re-mint the pending op with this localSeq against current state
        (ref client.ts regeneratePendingOp:1452; the host plan mirrors
        mergetree_ref.RefMergeTree.regenerate_pending step for step, the
        re-stamping runs on the device)."""
        out = self._regenerate(local_seq, new_local_seq, squash, new_client)
        self.regenerated += len(out)
        return out

    def _regenerate(self, local_seq, new_local_seq, squash, new_client):
        key = LOCAL_BASE + local_seq
        ob = next((o for o in self._obs() if o.key == key), None)
        if ob is not None:
            return self._regenerate_obliterate(ob, key, new_local_seq, squash, new_client)

        segs = self._segs(with_text=True)
        inv_prop = {v: k for k, v in self._prop_slot.items()}
        # (kind, pos1, pos2, payload, {uids}) collected before re-stamping.
        plans: list[tuple[int, int, int, object, set[int]]] = []

        # Pending insert: contiguous run of segments carrying this ins stamp.
        ins_segs: list[_Seg] = []
        pos = 0
        ins_pos = -1
        for seg in segs:
            if seg.ins_key == key and not (squash and self._squashed(seg)):
                if ins_pos < 0:
                    ins_pos = pos
                ins_segs.append(seg)
            if self._visible_at_prefix(seg, key, exclude_key=-1, squash=squash):
                pos += seg.length
        if ins_pos >= 0:
            from .markers import regenerated_insert_spec

            spec = regenerated_insert_spec([
                (s.text, {
                    str(inv_prop[p]): v
                    for p, (v, k) in s.props.items()
                    if k == key
                })
                for s in ins_segs
            ])
            plans.append((0, ins_pos, -1, spec, {s.uid for s in ins_segs}))

        # Pending remove / annotate: maximal visible runs carrying the stamp.
        pos = 0
        rem_run: tuple[int, int, set[int]] | None = None
        ann_run: tuple[int, int, dict, set[int]] | None = None

        def flush_remove() -> None:
            nonlocal rem_run
            if rem_run is not None:
                plans.append((1, rem_run[0], rem_run[1], None, rem_run[2]))
            rem_run = None

        def flush_annotate() -> None:
            nonlocal ann_run
            if ann_run is not None:
                plans.append((2, ann_run[0], ann_run[1], ann_run[2], ann_run[3]))
            ann_run = None

        for seg in segs:
            if not self._visible_at_prefix(seg, key, exclude_key=key, squash=squash):
                continue  # invisible: breaks neither runs nor position space
            if any(k == key for k, _c in seg.removes):
                if rem_run is None:
                    rem_run = (pos, pos + seg.length, {seg.uid})
                else:
                    rem_run = (rem_run[0], pos + seg.length, rem_run[2] | {seg.uid})
            else:
                flush_remove()
            props = {
                str(inv_prop[p]): v for p, (v, k) in seg.props.items() if k == key
            }
            if props:
                if ann_run is None or props != ann_run[2]:
                    flush_annotate()
                    ann_run = (pos, pos + seg.length, props, {seg.uid})
                else:
                    ann_run = (ann_run[0], pos + seg.length, props, ann_run[3] | {seg.uid})
            else:
                flush_annotate()
            pos += seg.length
        flush_remove()
        flush_annotate()

        if squash:
            self.state = mk.drop_squashed(self.state)
        s = self._snap()
        live_uid = s.seg_uid[: int(s.nseg)] if plans else None

        out: list[tuple[int, dict]] = []
        # Split removes shift later pieces left by what earlier pieces
        # removed (see mergetree_ref.regenerate_pending).
        removed_before = 0
        for kind, pos1, pos2, payload, uids in plans:
            fresh = new_local_seq()
            fresh_key = LOCAL_BASE + fresh
            self._regenerated_keys.add(fresh_key)
            if kind == 0:
                self._restamp(uids, key, fresh_key, new_client, "ins", live_uid)
                # Same-op props (insertMarker) re-mint with the insert.
                self._restamp(uids, key, fresh_key, None, "prop", live_uid)
                out.append((fresh, {"type": 0, "pos1": pos1, "seg": payload}))
            elif kind == 1:
                self._restamp(uids, key, fresh_key, new_client, "rem", live_uid)
                out.append(
                    (fresh, {"type": 1, "pos1": pos1 - removed_before,
                             "pos2": pos2 - removed_before})
                )
                removed_before += pos2 - pos1
            else:
                self._restamp(uids, key, fresh_key, None, "prop", live_uid)
                out.append(
                    (fresh, {"type": 2, "pos1": pos1, "pos2": pos2, "props": payload})
                )
        return out

    def _regenerate_obliterate(
        self, ob: _Ob, key: int, new_local_seq, squash: bool, new_client: int | None
    ) -> list[tuple[int, dict]]:
        """Port of mergetree_ref._regenerate_obliterate over the snapshot."""
        segs = self._segs()
        index_of = {seg.uid: i for i, seg in enumerate(segs)}
        s_i = index_of.get(ob.start_uid, len(segs))
        e_i = index_of.get(ob.end_uid, len(segs))
        b_s = b_e = total = 0
        for i, seg in enumerate(segs):
            if not self._visible_at_prefix(seg, key, exclude_key=key, squash=squash):
                continue
            n = seg.length
            if i < s_i or (i == s_i and ob.start_side == mk.SIDE_AFTER):
                b_s += n
            if i < e_i or (i == e_i and ob.end_side == mk.SIDE_AFTER):
                b_e += n
            total += n

        if ob.start_side == mk.SIDE_AFTER and b_s > 0:
            start = {"pos": b_s - 1, "before": False}
        else:
            start = {"pos": b_s, "before": True}
        if ob.end_side == mk.SIDE_BEFORE and b_e < total:
            end = {"pos": b_e, "before": True}
        elif b_e > 0:
            end = {"pos": b_e - 1, "before": False}
        else:
            end = None

        start_char = start["pos"]
        end_char = end["pos"] if end is not None else -1
        start_bound = start["pos"] + (0 if start["before"] else 1)
        end_bound = (end["pos"] + (0 if end["before"] else 1)) if end is not None else -1
        if (
            end is None
            or not (0 <= start_char <= end_char < total)
            or start_bound > end_bound
        ):
            # Range gone from the prefix view: retire the obliterate (strip
            # its never-to-ack stamps, free its record slot).
            self.state = mk.strip_stamp(self.state, key)
            self.slice_keys.discard(key)
            return []

        fresh = new_local_seq()
        fresh_key = LOCAL_BASE + fresh
        self._regenerated_keys.add(fresh_key)
        self._restamp(None, key, fresh_key, new_client, "ob")
        self.slice_keys.discard(key)
        self.slice_keys.add(fresh_key)
        return [(fresh, {"type": 5, "pos1": start, "pos2": end})]

    # ------------------------------------------------------------ checkpoint
    def export_summary(self) -> dict:
        """Merge-tree snapshot in the shared summary JSON (identical schema
        to RefMergeTree.export_summary; ref snapshotV1.ts:42)."""
        inv_prop = {v: k for k, v in self._prop_slot.items()}
        return state_to_summary(self._snap(), inv_prop, self.slice_keys)

    def import_summary(self, summary: dict) -> None:
        """Rebuild the device state from summary JSON (fresh text pool, uids
        = segment indices, obliterate anchors resolved by index).
        Attribution override runs (reference V1 snapshots with
        universalized below-MSN stamps) are refused loudly — load those
        into the oracle backend."""
        state = summary_to_state(
            summary, state_geometry(self.state), self._slot_for, device=self.device
        )
        self.slice_keys = set(summary.get("sliceKeys", [])) | {
            o["key"] for o in summary.get("obliterates", [])
        }
        self.state = state
