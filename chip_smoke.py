#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fluidframework_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

It builds every hand-written kernel of the port from ``csrc/`` with nvcc
(sm_90a), then runs these phases on the card, one JSON line each:

1. ``kernels``: K1 (``resolve_positions``) against its plain PyTorch
   version on the same card tensors — edge cases, the edges of its tiles,
   the batched form and the long-document size (Q=256, S=262,144) — exact
   equality; then, at the long-document shape and the segment lane's
   (Q=1, S=16,384), its call time (CUDA events) and device time
   (torch.profiler) beside its bound and the same function in PyTorch
   calls (``torch.cumsum`` then ``torch.searchsorted``).
2. ``fleet``: config-3 geometry (10,000 SharedString docs, S=1024,
   T=8192, R=4, P=2, B=16, K=8) fed Zipf-skewed 4-writer insert/remove
   traffic through ``DocBatchEngine.ingest``/``step``/``compact``; no error
   bits, and a seeded sample of 64 docs replayed through the same engine
   on the CPU gives byte-identical state rows.
3. ``hot_doc``: config-1 geometry (one doc, S=16,384, T=131,072) — a
   4-writer trace through the one-shard segment lane
   (``apply_megastep_seg``, whose containment searches are K1 launches)
   equals the single lane on the same trace.
4. ``long_doc``: the long-document query plane's resolve at Q=256 over
   262,144 segments (K1), mark and visible length, against numpy.

Phases 2-4 are the port's main path: every kernel launch counter is set to
0 just before it and read just after, and a kernel of the path that never
launched fails the run.  Then it prints the ``kernels`` summary line, the
card's name and power limit, and, last, the ``{"ok": true, ...}`` line.
Any failure exits nonzero without that line; so does a machine without a
CUDA card, or a directory without the port.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ traffic

def zipf_counts(n_docs: int, ops_per_step: int, a: float) -> np.ndarray:
    """Per-doc ops per round by Zipf rank (doc 0 busiest, floor 1)."""
    w = (np.arange(n_docs, dtype=np.float64) + 1.0) ** (-a)
    return np.maximum(1, np.round(ops_per_step * w / w[0]).astype(np.int64))


def fleet_traffic(n_docs: int, rounds: int, ops_per_round: int, ins_len: int,
                  seed: int, writers: int = 4):
    """Zipf-skewed multi-writer SharedString traffic as sequenced wire
    messages: per round every op stamps ref_seq at the round start (writers
    are mutually concurrent), writer slots alternate insert (``ins_len``
    chars at a random own-perspective position) / remove (2 chars of that
    same insert), and the MSN is the round start.  Returns per-round lists
    of (doc, message) and the join messages."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    D, W = n_docs, writers
    counts = zipf_counts(D, ops_per_round, 1.1)
    joins = [
        (d, SequencedMessage(
            client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w},
        ))
        for d in range(D) for w in range(W)
    ]
    lengths = np.zeros(D, np.int64)
    seq = np.zeros(D, np.int64)
    out = []
    for _r in range(rounds):
        ref = seq.copy()
        own_extra = np.zeros((D, W), np.int64)
        pair_pos = np.zeros((D, W), np.int64)
        rows = []
        for b in range(int(counts.max())):
            w = b % W
            docs = np.nonzero(b < counts)[0]
            own_len = lengths[docs] + own_extra[docs, w]
            insert = (b // W) % 2 == 0
            if insert:
                pos = np.minimum((rng.random(len(docs)) * (own_len + 1)).astype(np.int64), own_len)
                pair_pos[docs, w] = pos
                own_extra[docs, w] += ins_len
                texts = rng.integers(97, 123, size=(len(docs), ins_len))
            else:
                pos = pair_pos[docs, w]
                own_extra[docs, w] -= 2
            seq[docs] += 1
            for j, d in enumerate(docs.tolist()):
                if insert:
                    contents = {"type": 0, "pos1": int(pos[j]),
                                "seg": "".join(map(chr, texts[j]))}
                else:
                    contents = {"type": 1, "pos1": int(pos[j]), "pos2": int(pos[j]) + 2}
                rows.append((d, SequencedMessage(
                    client_id=f"w{w}", client_seq=int(seq[d]), ref_seq=int(ref[d]),
                    seq=int(seq[d]), min_seq=int(ref[d]), contents=contents,
                )))
        lengths = lengths + own_extra.sum(axis=1)
        out.append(rows)
    return joins, out


def four_writer_trace(seed: int, n_rounds: int, max_insert_len: int):
    """Multi-writer rounds with real ref_seq lag over one document:
    inserts (some multi-chunk), removes, annotates and sided obliterates of
    each writer's own content, valid in each op's own perspective.  Returns
    (ops[N, 8], payloads[N, L], ref[N]) op rows."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    rng = np.random.default_rng(seed)
    rows, refs = [], []
    length = 0
    seq = 0
    writers = 4
    empty = np.zeros(max_insert_len, np.int32)
    for _r in range(n_rounds):
        ref = seq
        base = length
        own = [0] * writers
        last_ins = [(0, 0)] * writers
        for w in range(writers):
            for _ in range(2):
                own_len = base + own[w]
                kind = rng.integers(0, 5)
                seq += 1
                if kind in (0, 1) or own_len < 4:
                    tlen = int(rng.integers(1, 20))
                    pos = int(rng.integers(0, own_len + 1))
                    text = "".join(chr(97 + rng.integers(0, 26)) for _ in range(tlen))
                    new = mk.encode_insert(pos, text, seq, w, ref, max_insert_len)
                    last_ins[w] = (pos, tlen)
                    own[w] += tlen
                elif kind == 2:
                    p, ln = last_ins[w]
                    p2 = min(p + max(1, ln // 2), own_len)
                    new = [(np.array([mk.OpKind.REMOVE, seq, w, ref, p, p2, 0, 0], np.int32), empty)]
                    own[w] -= p2 - p
                    last_ins[w] = (p, 0)
                elif kind == 3:
                    p = int(rng.integers(0, own_len - 1))
                    p2 = int(rng.integers(p + 1, own_len + 1))
                    new = [(np.array(
                        [mk.OpKind.ANNOTATE, seq, w, ref, p, p2,
                         int(rng.integers(0, 2)), int(rng.integers(1, 100))], np.int32,
                    ), empty)]
                else:
                    p, ln = last_ins[w]
                    if ln >= 2:
                        new = [(mk.encode_obliterate(
                            p, mk.SIDE_BEFORE, p + ln - 1, mk.SIDE_AFTER, seq, w, ref,
                        ), empty)]
                        own[w] -= ln
                        last_ins[w] = (p, 0)
                    else:
                        new = [(np.array([mk.OpKind.NOOP, seq, w, ref, 0, 0, 0, 0], np.int32), empty)]
                rows.extend(new)
                refs.extend([ref] * len(new))
        length = base + sum(own)
    return (np.stack([o for o, _ in rows]), np.stack([p for _, p in rows]),
            np.asarray(refs, np.int64))


# ----------------------------------------------------------------- timing

def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phases

def _random_lens(rng, n_segs, vis_p=0.7, max_len=9):
    lens = rng.integers(0, max_len, size=n_segs).astype(np.int32)
    return np.where(rng.random(n_segs) < vis_p, lens, 0).astype(np.int32)


def _queries(rng, lens, n):
    total = int(lens.sum())
    qs = rng.integers(0, max(total, 1) + 3, size=n).astype(np.int32)
    return np.concatenate([qs, np.asarray([-1, -7, total, total + 5], np.int32)])


def _edge_queries(rng, lens, tile, n=300):
    """``n`` queries (more than one query chunk of the kernel): the prefix
    at every tile start and the total, one below each, one past the end,
    and random positions."""
    incl = np.cumsum(lens, dtype=np.int64)
    total = int(incl[-1])
    edges = np.unique(np.concatenate([[0], incl[tile - 1::tile], [total]]))
    fixed = np.concatenate([edges, edges - 1, [total + 5]])
    return np.concatenate([fixed, rng.integers(0, total + 3, size=n - len(fixed))]).astype(np.int32)


def tile_edge_cases(rng, tile):
    """K1 cases at the edges of its tiles: S one below, at and one past a
    tile, a ragged third tile, and 3 * tile + 3 segments with whole zero-sum
    tiles at the start, in the middle and at the end (tile 2 and the tail)."""
    cases = []
    for S, zero in ((tile - 1, ()), (tile, ()), (tile + 1, ()), (2 * tile + 3, ()),
                    (3 * tile + 3, (0,)), (3 * tile + 3, (1,)), (3 * tile + 3, (2, 3))):
        lens = _random_lens(rng, S)
        for t in zero:
            lens[t * tile:(t + 1) * tile] = 0
        cases.append((lens, _edge_queries(rng, lens, tile)))
    return cases


# Every K1 kernel's name contains this, in this design and the earlier one.
K1_NAME = "resolve_positions_"


def device_ms_by_name(fn, iters: int = 50) -> dict[str, float]:
    """Mean device time per call of ``fn`` of each device activity
    (kernels, copies, fills), by name, from torch.profiler; empty when the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "device_time_total", None)
        t = t if t is not None else evt.cuda_time_total
        if t:
            out[evt.key] = t / 1e3 / iters
    return out


def _device_sum(by_name: dict[str, float], name: str | None = None) -> float | None:
    """Sum over the activities whose name contains ``name`` (all when None);
    None when there are none."""
    return sum(v for k, v in by_name.items() if name is None or name in k) or None


def time_k1(rk, lens, qs, iters: int, plain_iters: int) -> dict:
    """K1 and its yardsticks on the same card tensors: call times (CUDA
    events over back-to-back calls, so host issue counts) and device times
    (torch.profiler).  ``library`` is the same function from ``lens`` in two
    PyTorch calls (cumsum, then searchsorted); ``library_search`` is the
    search alone over a prefix computed beforehand."""
    import torch

    incl = torch.cumsum(lens, -1, dtype=torch.int32)

    def k1():
        return rk.resolve_positions(lens, qs)

    def library():
        return torch.searchsorted(torch.cumsum(lens, -1, dtype=torch.int32), qs, right=True)

    # The function needs about Q*log2(S) compares, far below the bytes
    # bound: lens and the queries read once, the three outputs written once.
    nbytes = 4 * lens.numel() + 4 * qs.numel() + 3 * 4 * qs.numel()
    k1_device = device_ms_by_name(k1)
    return {
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "bound_bytes": nbytes,
        "kernel_ms": cuda_ms(k1, iters),
        "kernel_device_ms": _device_sum(k1_device, K1_NAME),
        # Everything the wrapper puts on the card per call, by activity.
        "call_device_ms": _device_sum(k1_device),
        "call_device_ms_by_name": {
            k.replace("(anonymous namespace)::", "").split("(")[0]: v for k, v in k1_device.items()
        },
        "plain_ms": cuda_ms(lambda: rk.resolve_positions_plain(lens, qs), plain_iters, warmup=2),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": _device_sum(device_ms_by_name(library)),
        "library_search_ms": cuda_ms(lambda: torch.searchsorted(incl, qs, right=True), iters),
    }


def phase_kernels(seed: int, card: str) -> dict:
    """K1 on the card against its plain version on the same card tensors
    (and the plain version on the CPU), exact; then timings at the
    long-document shape and the segment lane's."""
    import torch

    from fluidframework_tpu_torch.ops import resolve_kernel as rk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cases = [
        (np.asarray([3, 0, 2], np.int32), np.asarray([0, 2, 3, 4, 5, 99, -1, -7], np.int32)),
        (np.zeros(256, np.int32), np.asarray([0, 1, 2, -1], np.int32)),
    ]
    for n_segs in (1, 7, 128, 1023, 1024, 1025, 1500, 4096, 16384):
        lens = _random_lens(rng, n_segs)
        cases.append((lens, _queries(rng, lens, 37)))
    cases += tile_edge_cases(rng, rk.TILE)
    big_lens = _random_lens(rng, 262_144)
    big_q = rng.integers(-3, int(big_lens.sum()) + 3, size=256).astype(np.int32)
    cases.append((big_lens, big_q))
    # Batched forms [D, S] x [D, Q]: random, and D=3 at the tile edges.
    lens_b = np.stack([_random_lens(rng, 3000) for _ in range(3)])
    batched = [(lens_b, np.stack([_queries(rng, lens_b[d], 60) for d in range(3)]))]
    lens_e = np.stack([_random_lens(rng, 2 * rk.TILE + 3) for _ in range(3)])
    lens_e[1, :rk.TILE] = 0
    lens_e[2, rk.TILE:] = 0
    batched.append((lens_e, np.stack([_edge_queries(rng, row, rk.TILE) for row in lens_e])))
    max_err = 0
    hits = 0
    for lens, qs in cases + batched:
        lt = torch.from_numpy(lens).to(dev)
        qt = torch.from_numpy(qs).to(dev)
        got = rk.resolve_positions(lt, qt)
        want = rk.resolve_positions_plain(lt, qt)
        want_cpu = rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))
        torch.cuda.synchronize()
        for g, w, wc in zip(got, want, want_cpu):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(g.cpu(), w.cpu()) and torch.equal(g.cpu(), wc),
                  f"K1 disagrees with its plain version at lens {lens.shape}, queries {qs.shape}")
        hits += int(got[2].sum())

    lt = torch.from_numpy(big_lens).to(dev)
    qt = torch.from_numpy(big_q).to(dev)
    S, Q = lt.shape[0], qt.shape[0]
    long_doc = time_k1(rk, lt, qt, 200, 20)
    # Segment-lane shape: one query over a 16,384-segment hot doc.
    ls = torch.from_numpy(_random_lens(rng, 16_384)).to(dev)[None]
    qs1 = torch.zeros((1, 1), dtype=torch.int32, device=dev) + int(ls.sum()) // 2
    seg_lane = time_k1(rk, ls, qs1, 500, 200)
    out = {
        "phase": "kernels", "card": card, "cases": len(cases) + len(batched),
        "hits_checked": hits, "max_abs_err": max_err, "tile": rk.TILE,
        "S": S, "Q": Q, **long_doc,
        **{f"seg_lane_{k}": v for k, v in seg_lane.items()},
    }
    emit(out)
    return out


def _state_rows_equal(a, b) -> bool:
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    return all(
        np.array_equal(x.cpu().numpy(), y.cpu().numpy())
        for x, y in zip(mk.leaves(a), mk.leaves(b))
    )


class SliceClock:
    """Per-slice wall times of ``apply_megastep`` on the fleet path.

    With no OBLITERATE in a slice, each slice starts with the obliterate
    gate's one host sync (``_ob_table_nonempty``), so the time from one
    gate read to the next is one slice issued and run on the card; the
    last slice of a megastep ends at the caller's ``end()`` after a sync.
    Also counts the op rows each slice applied.  Installs by wrapping the
    two module functions; ``close()`` restores them."""

    def __init__(self, mk):
        self.mk = mk
        self.gate, self.apply_op = mk._ob_table_nonempty, mk._apply_op
        self.slice_s: list[float] = []
        self.slice_rows: list[int] = []
        self._t = None

        def gate(st):
            out = self.gate(st)
            self._mark()
            return out

        def apply_op(st, op, payload, kinds, ob_flag):
            self.slice_rows[-1] += int((kinds != mk.OpKind.NOOP).sum())
            return self.apply_op(st, op, payload, kinds, ob_flag)

        mk._ob_table_nonempty, mk._apply_op = gate, apply_op

    def _mark(self) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.slice_s.append(now - self._t)
        self._t = now
        self.slice_rows.append(0)

    def end(self) -> None:
        """Close the running slice (call after a device sync)."""
        if self._t is not None:
            self.slice_s.append(time.perf_counter() - self._t)
            self._t = None

    def close(self) -> None:
        self.mk._ob_table_nonempty, self.mk._apply_op = self.gate, self.apply_op


def phase_fleet(seed: int, card: str, device: str, n_docs: int = 10_000,
                rounds: int = 16, step_every: int = 8, sample: int = 64) -> dict:
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    geom = dict(max_segments=1024, text_capacity=8192, remove_slots=4,
                prop_slots=2, ops_per_step=16, megastep_k=8, max_insert_len=16)
    t0 = time.perf_counter()
    joins, rounds_msgs = fleet_traffic(n_docs, rounds, geom["ops_per_step"], 8, seed)
    gen_s = time.perf_counter() - t0
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = DocBatchEngine(n_docs, device=device, **geom)
    pick = np.sort(np.random.default_rng(seed + 1).choice(n_docs, size=min(sample, n_docs), replace=False))
    local = {int(d): j for j, d in enumerate(pick)}
    for d, m in joins:
        eng.ingest(d, m)
    clock = SliceClock(mk)
    ingest_s = step_s = compact_s = 0.0
    slices = 0
    try:
        t_all = time.perf_counter()
        for r, msgs in enumerate(rounds_msgs):
            t1 = time.perf_counter()
            for d, m in msgs:
                eng.ingest(d, m)
            ingest_s += time.perf_counter() - t1
            if (r + 1) % step_every == 0 or r + 1 == len(rounds_msgs):
                t1 = time.perf_counter()
                slices += eng.step()
                if on_card:
                    torch.cuda.synchronize()
                clock.end()
                t2 = time.perf_counter()
                eng.compact()
                if on_card:
                    torch.cuda.synchronize()
                step_s += t2 - t1
                compact_s += time.perf_counter() - t2
        wall_s = time.perf_counter() - t_all
    finally:
        clock.close()
    ops_applied = eng.counters["ops_staged"]
    errored = eng.error_count()
    check(errored == 0, f"fleet latched error bits on {errored} docs")
    check(len(clock.slice_s) == slices, "fleet slice clock lost a slice")
    # The check's replay runs after the timed window: the sampled docs'
    # messages through the same engine on the CPU, stepped at the same
    # rounds.
    ref = DocBatchEngine(len(pick), device="cpu", **geom)
    for d, m in joins:
        if d in local:
            ref.ingest(local[d], m)
    for r, msgs in enumerate(rounds_msgs):
        for d, m in msgs:
            if d in local:
                ref.ingest(local[d], m)
        if (r + 1) % step_every == 0 or r + 1 == len(rounds_msgs):
            ref.step()
            ref.compact()
    same = sum(_state_rows_equal(eng.doc_state(int(d)), ref.doc_state(j)) for j, d in enumerate(pick))
    check(same == len(pick), f"{len(pick) - same} of {len(pick)} sampled docs differ from the CPU replay")
    out = {
        "phase": "fleet", "card": card, "docs": n_docs, "rounds": rounds,
        "ops_applied": ops_applied, "slices": slices,
        "megasteps": eng.counters["megastep_dispatches"],
        "traffic_gen_s": gen_s, "ingest_s": ingest_s, "step_s": step_s,
        "compact_s": compact_s, "wall_s": wall_s, "ops_per_s": ops_applied / wall_s,
        "slice_s": clock.slice_s, "slice_rows": clock.slice_rows,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "ob_gate_syncs": eng.health()["ob_gate_syncs"],
        "sampled_docs_identical": same,
    }
    emit(out)
    return out


def phase_hot_doc(seed: int, card: str, device: str, S: int = 16_384,
                  T: int = 131_072, rounds: int = 96) -> dict:
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel import mesh as pm

    L, K, B = 8, 8, 16
    ops, pays, refs = four_writer_trace(seed, rounds, L)
    n = -(-len(ops) // (K * B)) * K * B
    ops = np.concatenate([ops, np.zeros((n - len(ops), 8), np.int32)])
    pays = np.concatenate([pays, np.zeros((n - len(pays), L), np.int32)])
    refs = np.concatenate([refs, np.full(n - len(refs), refs[-1])])
    mesh = pm.docs_segs_mesh(device, seg_shards=1)
    proto = mk.init_state(S, 4, 2, T, 8, device=device)
    blocked = mk.seg_shard_state(proto, 1)
    seg_prog = pm.mesh_seg_program(mk.apply_megastep_seg, mesh, pm.seg_state_specs(blocked))
    seg_compact = pm.mesh_seg_program(mk.compact_seg, mesh)
    seg = pm.shard_seg_state(blocked, mesh)
    single = mk.batch_state(proto, 1)
    launches0 = resolve_positions.launches
    seg_s = single_s = 0.0
    for c in range(n // (K * B)):
        o = ops[c * K * B:(c + 1) * K * B].reshape(K, B, 8)
        p = pays[c * K * B:(c + 1) * K * B].reshape(K, B, L)
        min_seq = int(refs[(c + 1) * K * B - 1])
        t1 = time.perf_counter()
        seg = seg_compact(seg_prog(seg, o, p), min_seq)
        if device == "cuda":
            torch.cuda.synchronize()
        seg_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        single = mk.apply_megastep(single, o[:, None], p[:, None])
        single = mk.compact(mk.set_min_seq(single, np.asarray([min_seq], np.int32)))
        if device == "cuda":
            torch.cuda.synchronize()
        single_s += time.perf_counter() - t1
    k1 = resolve_positions.launches - launches0
    a = mk.canonical_doc(mk.doc_row(single, 0))
    b = mk.canonical_doc(mk.seg_gather_state(seg, max_segments=S))
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    check(not bad, f"segment lane diverged from the single lane in {bad}")
    check(a["error"] == 0, f"hot doc latched error bits {a['error']}")
    if device == "cuda":
        check(k1 > 0, "segment lane never launched K1")
    out = {
        "phase": "hot_doc", "card": card, "S": S, "T": T, "op_rows": int(len(ops)),
        "live_segments": a["nseg"], "text_end": a["text_end"],
        "seg_lane_s": seg_s, "single_lane_s": single_s,
        "seg_rows_per_s": len(ops) / seg_s, "k1_launches": k1,
        "identical": True,
    }
    emit(out)
    return out


def phase_long_doc(seed: int, card: str, device: str, S: int = 262_144, Q: int = 256) -> dict:
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel import mesh as pm
    from fluidframework_tpu_torch.parallel.long_doc import make_sharded_ops, shard_doc_state
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED, NO_REMOVE

    rng = np.random.default_rng(seed)
    seg_len = rng.integers(1, 9, size=S).astype(np.int32)
    removed = rng.random(S) < 0.15
    host = mk.to_numpy(mk.init_state(S, 2, 2, int(seg_len.sum()), 8, device="cpu"))
    rem0 = np.where(removed, S + 1 + np.arange(S), NO_REMOVE).astype(np.int32)
    host = host._replace(
        nseg=np.asarray(S, np.int32),
        seg_start=(np.cumsum(seg_len) - seg_len).astype(np.int32),
        seg_len=seg_len,
        ins_key=np.arange(1, S + 1, dtype=np.int32),
        ins_client=np.zeros(S, np.int32),
        rem_keys=(rem0,) + host.rem_keys[1:],
    )
    mesh = pm.doc_mesh(device)
    state = shard_doc_state(mk.from_numpy(host, device="cpu"), mesh)
    vis_len, resolve, mark = make_sharded_ops(mesh, state)
    lens = np.where(removed, 0, seg_len).astype(np.int64)
    total = int(lens.sum())
    queries = rng.integers(0, total, size=Q).astype(np.int32)
    launches0 = resolve_positions.launches
    t1 = time.perf_counter()
    gi, off = resolve(state, queries, ALL_ACKED, -2)
    if device == "cuda":
        torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t1
    k1 = resolve_positions.launches - launches0
    incl = np.cumsum(lens)
    want_i = np.searchsorted(incl, queries, side="right")
    want_o = queries - (incl[want_i] - lens[want_i])
    check(np.array_equal(gi.cpu().numpy(), want_i) and np.array_equal(off.cpu().numpy(), want_o),
          "long-doc resolve disagrees with numpy")
    check(int(vis_len(state, ALL_ACKED, -2)) == total, "long-doc visible length")
    out_state = mark(state, 40, 4000, S + 10 * S, 3, ALL_ACKED, -2)
    prefix = incl - lens
    in_range = (lens > 0) & (prefix >= 40) & (incl <= 4000)
    want_rem0 = np.where((rem0 == NO_REMOVE) & in_range, S + 10 * S, rem0)
    check(np.array_equal(out_state.rem_keys[0].cpu().numpy(), want_rem0), "long-doc mark")
    if device == "cuda":
        check(k1 > 0, "long-doc resolve never launched K1")
    out = {"phase": "long_doc", "card": card, "S": S, "Q": Q,
           "resolve_s": resolve_s, "k1_launches": k1, "identical": True}
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    try:
        from fluidframework_tpu_torch.ops import resolve_kernel as rk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    card = card_label()
    t0 = time.perf_counter()
    rk.build(verbose=True)
    emit({"phase": "build", "card": card, "build_s": time.perf_counter() - t0,
          "library": str(rk.library_path().name)})
    k = phase_kernels(args.seed, card)

    # The main path: counts to 0 just before, read just after.
    rk.resolve_positions.launches = 0
    phase_fleet(args.seed, card, "cuda")
    phase_hot_doc(args.seed, card, "cuda")
    phase_long_doc(args.seed, card, "cuda")
    launches = rk.resolve_positions.launches
    check(launches > 0, "K1 was never launched on the main path")

    emit({"kernels": [{
        "name": "resolve_positions", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/resolve_positions.cu",
        "replaces": "fluidframework_tpu/ops/pallas_kernels.py:65",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "device_ms": k["kernel_device_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
