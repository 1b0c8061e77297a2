"""The summary codec: one document's ``DocState`` <-> summary JSON.

The converters of ``fluidframework_tpu/dds/kernel_backend.py`` (``_Seg``,
``_Ob``, ``pull_segments``, ``pull_obliterates``, ``state_to_summary``,
``summary_to_state``, ``summary_to_state_host``, ``state_geometry``): the
checkpoint/restore primitives of the fleet engine.  Any packed one-document
state — a batch row, an overflow lane, a restored checkpoint — round-trips
through the same summary schema as ``RefMergeTree.export_summary``, and a
summary written by either package restores in the other
(tests/test_torch_checkpoint.py).  Every value in a summary is a Python
int or str, so ``json.dumps`` gives the same bytes as the reference's.
``KernelMergeTree`` (the single-document client backend) is not ported.

States may hold torch tensors on any device or numpy arrays: the readers
pull them to the host once (``mk.to_numpy``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..device import DEFAULT_DEVICE
from ..ops import mergetree_kernel as mk
from ..protocol.stamps import NO_REMOVE, acked as _acked


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
