"""The port's ``KernelMergeTree`` and its device programs against the JAX
package's.

The same seeded inputs, made with numpy / ``random``, go through the
reference (JAX on the CPU) and the port (``device="cpu"``); the tolerance
is exact equality everywhere:

- a lockstep ``SharedString`` stream over each package's ``LocalService``
  (two ``KernelMergeTree`` replicas and one ``RefMergeTree`` a package):
  after every sync the FULL raw state columns (padding included), the
  error latch, the views (text, lengths, annotations, marker scan,
  attribution) and the ``converged_*`` position maps of the kernel
  replicas are equal across the packages;
- ``regenerate_pending`` plans (with and without squash, with and without
  a new client) on direct backend streams of acked, pending and acked-
  pending ops, then the regenerated ops acked;
- the one-doc ``apply_op`` and K5 (``drop_squashed``, ``strip_stamp``,
  ``restamp``) alone on states crafted by those streams;
- summaries across the packages, both ways, with equal JSON bytes, and a
  reference replica's raw state carried into the port (``mk.from_numpy``)
  continuing identically.

One geometry for the whole file (S=120, T=1920, L=8, OB=6), used by no
other test file, so the reference compiles each program once.
"""

from __future__ import annotations

import json
import random

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.kernel_backend import KernelMergeTree as RefKMT
from fluidframework_tpu.dds.kernel_backend import _apply_one as _ref_apply
from fluidframework_tpu.dds.mergetree_ref import RefMergeTree as RefOracle
from fluidframework_tpu.dds.shared_string import SharedString as RefSharedString
from fluidframework_tpu.ops import mergetree_kernel as rmk
from fluidframework_tpu.server.local_service import LocalService as RefService
from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree as PortKMT
from fluidframework_tpu_torch.dds.mergetree_ref import RefMergeTree as PortOracle
from fluidframework_tpu_torch.dds.shared_string import SharedString as PortSharedString
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.protocol.stamps import (
    ALL_ACKED,
    LOCAL_BASE,
    NON_COLLAB_CLIENT,
)
from fluidframework_tpu_torch.server.local_service import LocalService as PortService

GEOM = dict(max_segments=120, remove_slots=4, prop_slots=4, text_capacity=1920,
            max_insert_len=8, ob_slots=6)


def pair(**kw):
    g = dict(GEOM, **kw)
    return RefKMT(**g), PortKMT(**g, device="cpu")


# ----------------------------------------------------------------- compare

def _leaves(state) -> list[np.ndarray]:
    if isinstance(state.nseg, torch.Tensor):
        return [x.cpu().numpy() for x in tk.leaves(state)]
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _names(state) -> list[str]:
    out = []
    for f, v in zip(tk.DocState._fields, state):
        out += [f"{f}[{i}]" for i in range(len(v))] if isinstance(v, tuple) else [f]
    return out


def assert_raw_equal(ref_state, port_state, tag: str) -> None:
    """Every raw column (padding included) and the error latch equal."""
    for name, x, y in zip(_names(port_state), _leaves(ref_state), _leaves(port_state), strict=True):
        assert y.dtype == np.int32, f"{tag}: {name} is {y.dtype}"
        assert x.shape == y.shape and np.array_equal(x, y), f"{tag}: {name} diverged"


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _summary_bytes(backend):
    return _outcome(lambda: json.dumps(backend.export_summary(), sort_keys=True))


def views(kmt, clients=(-3, 0, 1, 2), ref_seqs=(ALL_ACKED,)) -> dict:
    """Every host view of one replica, and its converged position maps
    at every position (exceptions compared by type and message)."""
    out: dict = {"error": kmt.check_errors(), "summary": _summary_bytes(kmt)}
    for rs in ref_seqs:
        for vc in clients:
            key = f"{rs}/{vc}"
            out[f"text {key}"] = kmt.visible_text(rs, vc)
            out[f"raw {key}"] = kmt.visible_text(rs, vc, raw=True)
            n = kmt.visible_length(rs, vc)
            out[f"len {key}"] = n
            out[f"ann {key}"] = kmt.annotations(rs, vc)
            out[f"markers {key}"] = kmt.marker_scan(rs, vc)
            out[f"attr {key}"] = kmt.attribution_runs(rs, vc)
            out[f"conv_pos {key}"] = [
                _outcome(lambda p=p: kmt.converged_position(p, rs, vc)) for p in range(n + 2)
            ]
    conv = kmt.visible_length(ALL_ACKED, NON_COLLAB_CLIENT)
    out["to_local"] = [kmt.converged_to_local(p) for p in range(conv + 2)]
    out["spans"] = [kmt.converged_spans_to_local(a, b)
                    for a in range(0, conv + 1, 3) for b in (a, a + 2, conv)]
    uids = [int(u) for u in np.asarray(tk.to_numpy(kmt.state).seg_uid) if u >= 0]
    out["ins_ranges"] = kmt.converged_insert_ranges(uids[::2])
    keys = sorted({int(k) for k in np.concatenate(
        [np.asarray(a) for a in tk.to_numpy(kmt.state).rem_keys]) if k < LOCAL_BASE})
    out["rem_ranges"] = [kmt.converged_removed_ranges(uids, k) for k in keys[-3:]]
    return out


def assert_replicas_equal(ref, port, tag: str, **kw) -> None:
    assert_raw_equal(ref.state, port.state, tag)
    vr, vp = views(ref, **kw), views(port, **kw)
    for k in vr:
        assert vr[k] == vp[k], f"{tag}: view {k!r} diverged"
    assert ref.slice_keys == port.slice_keys, tag


def message_stream(doc) -> list[dict]:
    """The document's sequenced messages as wire JSON, wall-clock
    timestamps dropped."""
    return [dict(json.loads(m.to_json()), timestamp=0) for m in doc.sequencer.log]


# ------------------------------------------------- lockstep SharedString

def _fleet(Service, SharedString, make_kmt, oracle_cls):
    svc = Service()
    doc = svc.document("d")
    clients = [SharedString(f"c{i}", backend=make_kmt() if i < 2 else oracle_cls())
               for i in range(3)]
    for c in clients:
        doc.connect(c.client_id, c.process)
    doc.process_all()
    return doc, clients


def _edit(rng, c):
    n = len(c.text)
    kind = rng.choices(["ins", "rem", "ann", "ob", "obs"], [8, 3, 2, 1, 1])[0]
    if kind == "ins" or n == 0:
        return ("insert_text", rng.randint(0, n), rng.choice("abcxyz") * rng.randint(1, 11))
    p1 = rng.randrange(n)
    p2 = rng.randint(p1 + 1, min(n, p1 + 5))
    if kind == "rem":
        return ("remove_range", p1, p2)
    if kind == "ann":
        return ("annotate_range", p1, p2, rng.randrange(3), rng.randrange(9))
    if kind == "ob":
        return ("obliterate_range", p1, p2)
    c2 = rng.randint(p1, n - 1)
    s1, s2 = rng.random() < 0.5, rng.random() < 0.5
    if p1 == c2 and not s1 and s2:
        s1 = True
    return ("obliterate_range_sided", (p1, s1), (c2, s2))


@pytest.mark.parametrize("seed", range(6))
def test_shared_string_stream_matches_reference(seed):
    """Inserts (multi-chunk), removes, annotates, plain and sided
    obliterates from three writers, flushed in random groups: every kernel
    replica equal across the packages after every sync, and every replica
    of a package converged."""
    rng = random.Random(seed)
    ref_doc, ref_c = _fleet(RefService, RefSharedString, lambda: RefKMT(**GEOM), RefOracle)
    port_doc, port_c = _fleet(PortService, PortSharedString,
                              lambda: PortKMT(**GEOM, device="cpu"), PortOracle)
    for rnd in range(10):
        for _ in range(rng.randint(1, 5)):
            i = rng.randrange(3)
            name, *args = _edit(rng, ref_c[i])
            getattr(ref_c[i], name)(*args)
            getattr(port_c[i], name)(*args)
            for doc, c in ((ref_doc, ref_c[i]), (port_doc, port_c[i])):
                for m in c.take_outbox():
                    doc.submit(m)
            if rng.random() < 0.4:
                k = rng.randint(1, 3)
                ref_doc.process_some(k)
                port_doc.process_some(k)
        ref_doc.process_all()
        port_doc.process_all()
        texts = {c.text for c in ref_c} | {c.text for c in port_c}
        assert len(texts) == 1, (seed, rnd, texts)
        for i in range(2):
            assert_replicas_equal(ref_c[i].backend, port_c[i].backend, f"seed {seed} round {rnd} c{i}")
    assert message_stream(ref_doc) == message_stream(port_doc)


# ------------------------------------------------------ direct backend streams

class _Stream:
    """A direct backend stream for one replica pair: remote ops from
    clients 0-2 at lagging refSeqs, local pending ops (the replica's own
    client), acks of the oldest pending op, and min-seq advances."""

    def __init__(self, seed: int, ref, port):
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.ref, self.port = ref, port
        self.seq = 0
        self.min_seq = 0
        self.ls = 0
        self.pending: list[int] = []

    def both(self, name, *args, **kw):
        a = getattr(self.ref, name)(*args, **kw)
        b = getattr(self.port, name)(*args, **kw)
        assert a == b, (name, args, a, b)
        return a

    def _op(self, key, client, ref_seq):
        rng = self.rng
        n = self.ref.visible_length(ref_seq, client)
        kind = rng.choices(["ins", "rem", "ann", "ob"], [6, 3, 2, 2])[0]
        if kind == "ins" or n == 0:
            text = rng.choice("pqrs") * rng.randint(1, 10)
            self.both("apply_insert", rng.randint(0, n), text, key, client, ref_seq)
        elif kind == "rem":
            p1 = rng.randrange(n)
            self.both("apply_remove", p1, rng.randint(p1 + 1, min(n, p1 + 4)), key, client, ref_seq)
        elif kind == "ann":
            p1 = rng.randrange(n)
            self.both("apply_annotate", p1, rng.randint(p1 + 1, n), rng.randrange(3),
                      rng.randrange(50), key, client, ref_seq)
        else:
            p1 = rng.randrange(n)
            p2 = rng.randint(p1, min(n - 1, p1 + 3))
            s1, s2 = rng.randrange(2), rng.randrange(2)
            if p1 == p2 and s1 == tk.SIDE_AFTER and s2 == tk.SIDE_BEFORE:
                s1 = tk.SIDE_BEFORE
            self.both("apply_obliterate", p1, s1, p2, s2, key, client, ref_seq)

    def step(self) -> None:
        rng = self.rng
        r = rng.random()
        if r < 0.45:
            self.seq += 1
            ref_seq = rng.randint(max(self.min_seq, self.seq - 4), self.seq - 1)
            self._op(self.seq, rng.randrange(3), ref_seq)
        elif r < 0.8:
            self.ls += 1
            self.pending.append(self.ls)
            self._op(LOCAL_BASE + self.ls, self.ref.local_client, ALL_ACKED)
        elif r < 0.95 and self.pending:
            self.seq += 1
            self.both("ack", self.pending.pop(0), self.seq, 3, self.seq - 1)
        elif self.seq > 2:
            self.min_seq = max(self.min_seq, self.seq - 2)
            self.both("update_min_seq", self.min_seq)

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("squash", [False, True], ids=["plain", "squash"])
def test_regenerate_pending_matches_reference(seed, squash):
    """Every pending op regenerated in order (a reconnect): equal wire
    plans and fresh local seqs, equal raw state after each regeneration
    (K5 on the port), then the regenerated ops acked under a new client."""
    ref, port = pair()
    st = _Stream(seed, ref, port)
    st.run(70)
    assert_replicas_equal(ref, port, f"seed {seed} before regeneration",
                          ref_seqs=(ALL_ACKED, st.seq - 2))
    fresh = iter(range(st.ls + 1, st.ls + 1000))
    new_client = 7 if seed % 2 else None
    regenerated = []
    for ls in list(st.pending):
        counter = [next(fresh) for _ in range(8)]
        a = ref.regenerate_pending(ls, iter(counter).__next__, squash=squash,
                                   new_client=new_client)
        b = port.regenerate_pending(ls, iter(counter).__next__, squash=squash,
                                    new_client=new_client)
        assert a == b, (seed, ls, a, b)
        regenerated += [f for f, _op in a]
        assert_raw_equal(ref.state, port.state, f"seed {seed} after regenerating {ls}")
    assert ref._regenerated_keys == port._regenerated_keys
    for f in regenerated:
        st.seq += 1
        st.both("ack", f, st.seq, 7, st.seq - 1)
    assert_replicas_equal(ref, port, f"seed {seed} after the regenerated acks")


def test_regenerate_obliterate_retires_and_reissues():
    """A pending sided obliterate whose range survives is re-issued under
    a fresh key (restamp of its record); one whose range a concurrent
    remote remove took is retired (``strip_stamp``)."""
    for remote_cut in (False, True):
        ref, port = pair()
        st = _Stream(11, ref, port)
        st.both("apply_insert", 0, "abcdefgh", 1, 0, 0)
        st.both("apply_obliterate", 2, tk.SIDE_AFTER, 5, tk.SIDE_BEFORE,
                LOCAL_BASE + 1, ref.local_client, ALL_ACKED)
        if remote_cut:
            st.both("apply_remove", 0, 8, 2, 1, 1)
        out = [kmt.regenerate_pending(1, iter([2, 3]).__next__) for kmt in (ref, port)]
        assert out[0] == out[1]
        assert (out[0] == []) == remote_cut
        assert_replicas_equal(ref, port, f"remote_cut={remote_cut}")


# --------------------------------------------------- programs on crafted states

def _crafted(seed: int, steps: int = 60):
    """A reference replica's state after a direct stream (pending stamps,
    live obliterate records), and the same state on the port."""
    ref, port = pair()
    st = _Stream(seed, ref, port)
    st.run(steps)
    s = jax.tree.map(np.asarray, ref.state)
    return s, tk.from_numpy(s, device="cpu"), st


@pytest.mark.parametrize("seed", range(4))
def test_apply_op_matches_reference(seed):
    """The one-doc ``apply_op`` on crafted states, op by op: every kind,
    NOOPs, out-of-range positions (ERR_POS_RANGE) and acks of stamps that
    do not exist, each from the same state in both packages."""
    ref_s, port_s, st = _crafted(seed)
    rng = np.random.default_rng(seed)
    L = GEOM["max_insert_len"]
    for i in range(40):
        kind = int(rng.integers(0, 6))
        pos1 = int(rng.integers(0, 40))
        op = np.array([kind, int(rng.integers(1, 60)) if i % 3 else LOCAL_BASE + int(rng.integers(1, 9)),
                       int(rng.integers(-3, 3)), int(rng.integers(0, 60)), pos1,
                       pos1 + int(rng.integers(0, 8)), int(rng.integers(1, L + 1)),
                       int(rng.integers(0, 50))], np.int32)
        if kind == tk.OpKind.OBLITERATE:
            op[6:8] = rng.integers(0, 2, 2)
        if kind == tk.OpKind.ANNOTATE:
            op[6] = rng.integers(0, GEOM["prop_slots"])
        payload = rng.integers(97, 123, L).astype(np.int32)
        ref_s = _ref_apply(ref_s, op, payload)
        port_s = tk.apply_op(port_s, op, payload)
        assert_raw_equal(ref_s, port_s, f"seed {seed} op {i} {op.tolist()}")


def _k5_calls(fn: str, rng, st):
    S = GEOM["max_segments"]
    keys = [LOCAL_BASE + ls for ls in range(1, st.ls + 2)] + list(range(1, st.seq + 2))
    for _ in range(1 if fn == "drop_squashed" else 6):
        key = int(rng.choice(keys))
        if fn == "strip_stamp":
            yield (key,)
        elif fn == "restamp":
            mask = rng.random(S) < rng.choice([0.3, 1.0])
            flags = [bool(f) for f in rng.integers(0, 2, 4)]
            yield (mask, key, LOCAL_BASE + 500 + int(rng.integers(0, 9)),
                   int(rng.choice([-1, 5])), *flags)
        else:
            yield ()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn", ["drop_squashed", "strip_stamp", "restamp"])
def test_k5_matches_reference(fn, seed):
    """K5 alone on crafted states: each call from the same state in both
    packages, chained six times."""
    ref_s, port_s, st = _crafted(seed + 20, steps=80)
    rng = np.random.default_rng(seed)
    ref_fn, port_fn = getattr(rmk, fn), getattr(tk, fn)
    for args in _k5_calls(fn, rng, st):
        ref_args = [jax.numpy.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        ref_s = ref_fn(ref_s, *ref_args)
        port_s = port_fn(port_s, *args)
        assert_raw_equal(ref_s, port_s, f"{fn} seed {seed} {args[1:] if args else ''}")


def test_drop_squashed_keeps_obliterate_anchors():
    """Of two squashed segments (pending insert, then pending remove) the
    one anchoring a live obliterate record stays; the other is dropped."""
    ref, port = pair()
    st = _Stream(3, ref, port)
    me = ref.local_client
    st.both("apply_insert", 0, "xyz", 1, 0, 0)
    st.both("apply_insert", 0, "uvw", LOCAL_BASE + 1, me, ALL_ACKED)
    st.both("apply_obliterate", 0, tk.SIDE_BEFORE, 2, tk.SIDE_AFTER, LOCAL_BASE + 2, me, ALL_ACKED)
    st.both("apply_insert", 0, "ab", LOCAL_BASE + 3, me, ALL_ACKED)
    st.both("apply_remove", 0, 2, LOCAL_BASE + 4, me, ALL_ACKED)
    ref_s = rmk.drop_squashed(ref.state)
    port_s = tk.drop_squashed(port.state)
    assert_raw_equal(ref_s, port_s, "drop_squashed")
    assert int(port_s.error) == 0
    assert (int(port.state.nseg), int(port_s.nseg)) == (3, 2)


# ----------------------------------------------------------------- summaries

def _acked_pair(seed: int):
    ref, port = pair()
    st = _Stream(seed, ref, port)
    st.run(50)
    while st.pending:
        st.seq += 1
        st.both("ack", st.pending.pop(0), st.seq, 3, st.seq - 1)
    return ref, port


@pytest.mark.parametrize("seed", range(3))
def test_summaries_cross_packages(seed):
    """Equal JSON bytes from both packages' ``export_summary``; each
    package's summary imports into the other's replica (and the port's
    ``RefMergeTree``) with equal raw state and equal bytes out."""
    ref, port = _acked_pair(seed)
    a = json.dumps(ref.export_summary(), sort_keys=True)
    b = json.dumps(port.export_summary(), sort_keys=True)
    assert a == b
    ref2, port2 = pair()
    ref2.import_summary(json.loads(b))   # port -> reference
    port2.import_summary(json.loads(a))  # reference -> port
    assert_replicas_equal(ref2, port2, f"seed {seed} imported")
    assert json.dumps(port2.export_summary(), sort_keys=True) == a
    oracle = PortOracle()
    oracle.import_summary(json.loads(b))
    assert oracle.visible_text() == port.visible_text()
    port3 = PortKMT(**GEOM, device="cpu")
    port3.import_summary(oracle.export_summary())
    assert json.dumps(port3.export_summary(), sort_keys=True) == a


def test_summary_with_pending_state_refuses_in_both():
    ref, port = pair()
    for kmt in (ref, port):
        kmt.apply_insert(0, "pending", LOCAL_BASE + 1, kmt.local_client, ALL_ACKED)
        with pytest.raises(RuntimeError, match="pending"):
            kmt.export_summary()


def test_carried_raw_state_continues_identically():
    """A reference replica's raw DocState carried into the port as numpy
    (``mk.from_numpy``) with its host tables: the same stream continues
    identically."""
    ref, port = pair()
    st = _Stream(5, ref, port)
    st.run(40)
    carried = PortKMT(**GEOM, device="cpu")
    carried.state = tk.from_numpy(jax.tree.map(np.asarray, ref.state), device="cpu")
    carried._prop_slot = dict(ref._prop_slot)
    carried.slice_keys = set(ref.slice_keys)
    st.port = carried
    st.run(40)
    assert_replicas_equal(ref, carried, "carried")


def test_prop_slot_overflow_raises_in_both():
    P = GEOM["prop_slots"]
    for kmt in pair():
        kmt.apply_insert(0, "abc", 1, 0, 0)
        for prop in range(P):
            kmt.apply_annotate(0, 1, prop, 1, 2 + prop, 0, 1)
        with pytest.raises(ValueError, match="out of prop slots"):
            kmt.apply_annotate(0, 1, 99, 1, 2 + P, 0, 1)


def test_segment_capacity_latch_matches_reference():
    """Past the segment capacity the latch sets the same bits, and the
    failed inserts report no segment, in both packages."""
    ref, port = pair()
    st = _Stream(0, ref, port)
    for i in range(GEOM["max_segments"] + 4):
        st.both("apply_insert", 0, "q", i + 1, i % 3, i)
    assert ref.check_errors() == port.check_errors() == tk.ERR_SEG_OVERFLOW
    assert_replicas_equal(ref, port, "segments")
