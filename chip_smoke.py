#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fluidframework_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N] [--trace-dir DIR]

``--trace-dir`` writes the Chrome traces of the recorded turns there
(nothing is written by default).

It builds every hand-written kernel of the port from ``csrc/`` with nvcc
(sm_90a; one compile per source, started together, then one link), then
runs these phases on the card, one JSON line each:

1. ``kernels``: K1 (``resolve_positions``) against its plain PyTorch
   version on the same card tensors — edge cases, the edges of its tiles,
   the batched form and the long-document size (Q=256, S=262,144) — exact
   equality; then, at the long-document shape and the segment lane's
   (Q=1, S=16,384), its call time (CUDA events) and device time
   (torch.profiler) beside its bound and the same function in PyTorch
   calls (``torch.cumsum`` then ``torch.searchsorted``); also at the
   4-shard lane's shape ([4, 16,384] lengths, one query a shard).
1b. ``rebase_kernel``: K9 (``rebase_window``) against its plain PyTorch
   version on the same card tensors and on the CPU, exact on every output
   of every step, at ``bench.py``'s microbench windows (W=256 and W=4,096
   windows of C=8 multi-insert commits) and one tree_deep window (W=1,
   C=256); call and device time, the plain version's, the host pooled
   fold's over the same windows, the bytes bound; then one window per
   ``DeviceRebaser.fold`` (the serving form) against the pooled fold.
2. ``fleet``: config-3 geometry (10,000 SharedString docs, S=1024,
   T=8192, R=4, P=2, B=16, K=8) fed Zipf-skewed 4-writer insert/remove
   traffic, a round per ``DocBatchEngine.ingest_batch`` call, through
   ``step``/``compact``; no error bits, and a seeded sample of 64 docs
   replayed per message through the same engine on the CPU gives
   byte-identical state rows.  Run at ``recovery="grow"``, then, to price
   recovery, in turns at ``"off"``, ``"grow"``, ``"grow"``, ``"off"``: the
   first grow of the turns ingests per message (``ingest``), the second
   runs with a flight recorder installed (phase shares of ``ingest``,
   ``upload``, ``dispatch``, ``readback``, then a recorded checkpoint
   sweep of the 64 sampled docs).  Each line carries the op-latency p50
   and p99, the ingest watermarks and the overload gauges.
3. ``recovery``: the fleet's geometry and traffic at ``recovery="grow"``
   with seeded faults (8 docs past the text capacity, 8 past the segment
   count, 4 with an insert past their length): no error bits, 16 overflow
   lanes at the doubled capacity, 4 quarantined docs; the faulted docs and
   64 others replayed on the CPU are identical; two watchdog sweeps of 64
   find nothing, and the device digest K4 (``fleet_digest``) is timed
   beside its bytes bound and equals its CPU result; on a 256-doc engine a
   tampered codepoint is caught by exactly one doc passing the digest
   pre-filter and quarantined; a forced checkpoint sweep restores into a
   fresh engine identically (the restore's scatter timed alone), and both
   engines stay identical through two more rounds, while a re-fed
   checkpointed round is skipped.
4. ``hot_doc``: config-1 geometry (one doc, S=16,384, T=131,072) — a
   4-writer trace through the one-shard segment lane
   (``apply_megastep_seg``, whose containment searches are K1 launches)
   equals the single lane on the same trace.
5. ``long_doc``: the long-document query plane's resolve at Q=256 over
   262,144 segments (K1), mark and visible length, against numpy.
6. ``fleet_programs``: the fleet programs timed alone beside their bytes
   bounds — K2 (one K=8 ``apply_megastep`` of the fleet's second
   megastep, [8, 10,000, 16]), K3 (``set_min_seq`` + ``compact`` of the
   10,000 docs) and K6 (``apply_megastep_seg`` and ``compact_seg`` at the
   hot document); their launches per path follow in a
   ``fleet_programs_launches`` line.
7. ``tree_fleet``: 1,024 SharedTree docs of ``bench.py``'s config-5
   stream (4 writers with their own subtrees and one shared subtree, 8
   edits per writer a round with one round of ref lag, 40% string
   leaves; capacity 2,048, pool 16,384, B=32, K=8) through
   ``TreeBatchEngine.ingest``/``step`` for 4 rounds: no error bits, the
   4 seeded docs that pass 2,048 rows (and only they) routed to the host
   fallback, a CPU replay of 64 sampled docs and the 4 identical (raw
   columns, ``tree_json``, ``values``, ``em.summarize()``); a forced
   checkpoint sweep restored into a fresh engine identically, and both
   engines identical through one more round.  The rounds run with a
   flight recorder installed: the host fold's phase shares
   (``host_fold_mark_alloc``/``_rebase``/``_compose``/``_translate``).
8. ``tree_deep``: one doc seeded with a 10,000-leaf mixed-type subtree
   under 32 writer subtrees, then 32 writers x 8 edits x 4 rounds;
   ``device_fraction`` 1.0 and identical to a CPU replay.
9. ``tree_churn``: 256 docs whose writers alternate inserts and removes
   (capacity 128): compaction (K8) must run; a sample of 64 identical to
   a CPU replay.
9b. ``wire_ingest``: ``bench.py``'s config-3 ingest stream (128 docs, 16
   rounds, 4 writers) as JSON lines through ``ingest_lines`` (the C++
   encoder, ``native/ingest.cpp``), as messages through ``ingest_batch``
   and through ``ingest``: ops/s of each; after ``step`` every doc's
   raw columns and error latch identical across them and a CPU run, the
   library loaded and every ``ingest_lines`` doc native.  Then
   tree_churn's stream through ``TreeBatchEngine.ingest_lines``
   (``native_wire=True``) round by round: every doc identical to the
   tree_churn engine's, native tree batches and no native decode error.
10. ``tree_programs``: K7 (``apply_nested_megastep``) on the ring the
    tree fleet stages from one more round, and K8 (``compact_nested``) on
    the fleet's state, timed alone beside their bytes bounds and held
    against the CPU on 64 docs; then K7's two routes (masked over every
    doc, or on the gathered rows of the docs that hold a kind) timed in
    turns on that ring with its ops kept for 1/16 to all of the docs.
11. ``tree_rebase``: config 5 with the device rebase window (K9) on:
    tree_deep's stream (its phase 8 engine, the pooled fold, is the other
    side) and the tree fleet's cut to 256 docs, in turns on, off, off, on;
    every doc's summary and tree JSON identical between the settings;
    ingest s, edits/s, ``device_rebase_fraction``, ``rebase_fallbacks``,
    ``rebase_windows``; the fleet's last turn runs with a flight recorder
    (the rebase window's encode/dispatch/decode spans).
12. ``map_lww``: config 2 — one map (K=256) fed 64 batches of 256
    SET/DELETE ops plus a CLEAR, then 10,000 maps through
    ``apply_batch_fleet``, 16 batches; both equal a CPU run exactly.
13. ``matrix``: config 4 — one 256 x 256 matrix seeded with 128 rows and
    columns, 16 steps of 64 SET_CELL ops from 64 writers with two of
    writer 0's row and column inserts and removes interleaved in each and
    FWW on some cells; the state and ``to_grid`` equal a CPU run exactly.
14. ``serving``: the serving tier, through its entry points.
    (a) A firehose stand-in (``FirehoseFeeder``: one thread answers the
    consume handshake, one sends JSON lines) serves the fleet's traffic
    for all 10,000 docs over local TCP to ``FleetConsumer`` over a
    ``DocBatchEngine`` at config-3 geometry (``recovery="grow"``): joins
    and round 0 warm it (``run_for``), rounds 1-15 are the timed drain
    (drain ops/s and wire -> device ops/s as ``bench.py``
    ``_wire_ingest_rate`` defines them), then a scribe summaryAck triggers
    the compaction; no error bits, and 64 sampled docs identical to a CPU
    ``ingest_lines`` replay of the same bytes.  RLIMIT_NOFILE's soft limit
    is raised to two sockets a doc; a lower hard limit cuts the doc count,
    written in the line as ``reduced``.  (b) tree_churn's stream to a
    ``TreeBatchEngine`` over the same feeder, a step a round: every doc
    identical to the tree_churn engine's.  (c) A ``ScribeLambda`` on the
    card and one on the CPU summarize one topic of 64 string, 64 tree and
    64 map docs (map_lww's op mix) and 4 matrices (the matrix phase's
    stream, cut to 4 steps): the same commit SHAs, ``refs.json`` and git
    objects; engines booted from ``SummaryRecordStore`` and fed the whole
    stream equal engines fed it all.  (d) A primary of 512 docs with a
    ``BackgroundCheckpointWriter``; a ``WarmStandby`` prepares (warmup,
    timed), trails, and promotes when the primary releases its lease; the
    promoted engine and a cold successor without warmup take the stream:
    both equal the primary on 64 sampled docs; first-step times and the
    promotion's ``recovery_p50_ms``.  (e) ``python -m
    fluidframework_tpu_torch.server.fleet_main --device cuda`` over 256
    docs, twice on one checkpoint directory: its ``done`` texts equal an
    in-process engine's, and the second run prints ``restored`` with
    ``checkpointed_ops_skipped > 0``.
15. ``sharded``: the sharded fleet, one line a part, every check exact.
    (a) The fleet's shared traffic (8 of its rounds) for all 10,000 docs on
    a 4-shard ``doc_mesh(["cuda"] * 4)`` with 64 spare slots: after round 3
    16 docs migrate with their rows staged; at round 4 shard 0's docs take
    two rounds ahead of the rest and ``rebalance_hot_shards()`` (factor
    2.0) is called until it migrates a doc.  Every doc's raw row and latch
    equal a control engine with no mesh fed the same stream (which
    re-packs the moved docs through the checkpoint codec at the same
    points), and 64 sampled unmoved docs a CPU replay; ops/s of each, ms
    per ``migrate_doc``.  (b) The control runs with ``use_mesh=False``
    (cohort steps for the Zipf stragglers) and a third engine with the
    default full-fleet step: identical state, ``cohort_steps > 0``; the
    runs go in turns mesh, cohort, full, full, cohort, mesh; the cohort
    gather and scatter timed alone.  (c) A hot doc at config-1 geometry
    (S=16,384, T=131,072) among 64 cold docs on
    ``docs_segs_mesh(["cuda"] * 8, seg_shards=4)``, promoted mid-stream by
    ``enable_segment_sharding`` and later by ``rebalance_hot_shards``' own
    promotion (a move to -1), re-blocked every 128 lane rows, demoted at
    the end: every doc equals an oracle engine that serves the hot doc in
    its batch row; ``seg_occupancy`` sums to the live count; the lane's
    rows/s and one n=4 ``apply_megastep_seg`` timed alone beside its bytes
    bound.  (d) tree_churn's stream on a 4-shard mesh with 16 spare slots,
    8 docs migrated mid-stream: every doc equals the tree_churn engine's.
    (e) ``python -m fluidframework_tpu_torch.server.fleet_main --device
    cuda --mesh 4 --spare-slots 16 --rebalance-every 0.5 --seg-shards 2``
    over 256 docs: a ``migrations`` line appears and its ``done`` texts
    equal an in-process engine's.
16. ``string_client``: the SharedString client path through its entry
    points: one ``LocalService`` document with four ``ContainerRuntime``
    clients (config 1's four writers), each holding a ``sharedString``;
    clients 0 and 2 on ``KernelMergeTree(device="cuda")`` at config 1's
    single-document geometry (S=16,384, T=131,072, the reference's default
    slot counts), 1 and 3 on ``RefMergeTree``.  A seeded script of 4,000
    edits (inserts, removes, annotates, plain and sided obliterates,
    interval adds), each client flushing after its edits and a sync a
    round; every sixth round a kernel client drops, edits offline and
    rejoins (its pending ops regenerate through K5), and once it stashes
    and rehydrates through ``apply_stashed``.  Every sync checks that the
    four clients' texts, resolved annotations and intervals are equal.
    The same script then runs with the kernel clients on the CPU: every
    kernel replica's raw state, error latch and summary, the sequenced
    stream and the text identical.  Then the squash regeneration (pending
    inserts and removes that cancel, a pending obliterate whose range a
    remote remove took) on a replica restored from the summary, card
    against CPU.  Outside the path, the one-doc programs (``apply_op``,
    K3, K5's ``restamp``, ``drop_squashed``, ``strip_stamp``) are timed
    alone on the final state beside their bytes bounds and held against
    the CPU.  Phase 16 runs first, right after the build, before any
    torch.profiler session (one leaves every later launch dearer on the
    host: ``apply_op`` 3.0 -> 4.2 ms a call on an H100); its programs are
    timed after phase 1b, as every other program is.

The fleet's traffic is made once, before phase 2, and shared by phases
2, 3, 6, 14 and 15 (a ``traffic`` line gives its generation time); each tree
path makes its own from the seed, outside its timed window.  Phases 2-5,
7-9b and 11-15 are the port's main path: the launch counters of K1, of the
fleet programs, of K7 and K8, of K9, of the map and matrix programs and of
the cohort gather and scatter are set to 0 just before each of them and
read just after, and a path
that runs K1 (phases 4 and 5), K7 (phases 7-9b and 11), K8 (phases 7 and
9), K9 (phase 11), the fleet program on wire_ingest (9b), the map
program (12) or the matrix program (13) fails the run if it never
launched; so does the serving path (14) unless K2, K3, K7, K8 and the map
and matrix programs all launched on it.  Phase 15's parts are paths of
their own: ``sharded_fleet`` fails unless K2, K3 and the cohort gather and
scatter launched, ``sharded_hot`` unless K1 and K6 (``apply_megastep_seg``,
``compact_seg``) did, ``sharded_tree`` unless K7 did; ``string_client``
(16) fails unless the one-doc ``apply_op``, K3's ``compact`` and the three
K5 programs launched on it.  Then it prints the ``kernels`` summary line
(K1 with its launches by path, the segment lane's among them; K7, K8, K9,
map, matrix; K6 at 4 shards; the cohort gather and scatter; the one-doc
``apply_op`` and K5), the card's name and power limit, and, last, the
``{"ok": true, ...}`` line.
Any failure exits nonzero without that line; so does a machine without a
CUDA card, or a directory without the port.
"""

from __future__ import annotations

import argparse
import gc
import gzip
import json
import os
import shutil
import subprocess
import tempfile
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


def k1_mismatch(qs, plane: str, got, want, want_cpu, again) -> str:
    """What a K1 disagreement was, for its failure message: the output
    plane; how many queries differ between the kernel, the plain version on
    the card and the plain version on the CPU; the first few such queries
    with the three values; and whether a second launch on the same inputs
    gave the same kernel output."""
    q = qs.reshape(-1)
    g, w, wc = (t.reshape(-1) for t in (got, want, want_cpu))
    at = ((g != w) | (g != wc) | (w != wc)).nonzero().flatten()[:4].tolist()
    return json.dumps({
        "plane": plane,
        "kernel_vs_plain_card": int((got != want).sum()),
        "kernel_vs_plain_cpu": int((got != want_cpu).sum()),
        "plain_card_vs_plain_cpu": int((want != want_cpu).sum()),
        "first": [{"at": i, "q": int(q[i]), "kernel": int(g[i]), "plain_card": int(w[i]),
                   "plain_cpu": int(wc[i])} for i in at],
        "second_launch_same": bool((again == got).all()),
    })


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
    # The 4-shard segment lane's shape: [4, 16,384] lengths, one query a
    # shard (each shard's local coordinate, some before or past it).
    lens_4 = np.stack([_random_lens(rng, 16_384) for _ in range(4)])
    q_4 = np.asarray([[int(lens_4[0].sum()) // 2], [-3], [int(lens_4[2].sum())], [0]], np.int32)
    batched.append((lens_4, q_4))
    max_err = 0
    hits = 0
    for lens, qs in cases + batched:
        lt = torch.from_numpy(lens).to(dev)
        qt = torch.from_numpy(qs).to(dev)
        got = rk.resolve_positions(lt, qt)
        want = rk.resolve_positions_plain(lt, qt)
        want_cpu = rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))
        torch.cuda.synchronize()
        for plane, g, w, wc in zip(("idx", "off", "hit"), got, want, want_cpu):
            g, w = g.cpu(), w.cpu()
            max_err = max(max_err, int((g.long() - w.long()).abs().max()))
            if not (torch.equal(g, w) and torch.equal(g, wc)):
                again = rk.resolve_positions(lt, qt)[("idx", "off", "hit").index(plane)].cpu()
                check(False, f"K1 disagrees with its plain version at lens {lens.shape}, "
                             f"queries {qs.shape}: " + k1_mismatch(qs, plane, g, w, wc, again))
        hits += int(got[2].sum())

    lt = torch.from_numpy(big_lens).to(dev)
    qt = torch.from_numpy(big_q).to(dev)
    S, Q = lt.shape[0], qt.shape[0]
    long_doc = time_k1(rk, lt, qt, 200, 20)
    # Segment-lane shape: one query over a 16,384-segment hot doc.
    ls = torch.from_numpy(_random_lens(rng, 16_384)).to(dev)[None]
    qs1 = torch.zeros((1, 1), dtype=torch.int32, device=dev) + int(ls.sum()) // 2
    seg_lane = time_k1(rk, ls, qs1, 500, 200)
    ls4 = torch.from_numpy(lens_4).to(dev)
    seg_lane4 = time_k1(rk, ls4, torch.from_numpy(q_4).to(dev), 500, 200)
    out = {
        "phase": "kernels", "card": card, "cases": len(cases) + len(batched),
        "hits_checked": hits, "max_abs_err": max_err, "tile": rk.TILE,
        "S": S, "Q": Q, **long_doc,
        **{f"seg_lane_{k}": v for k, v in seg_lane.items()},
        **{f"seg_lane4_{k}": v for k, v in seg_lane4.items()},
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


# Config-3 geometry: the fleet and recovery phases' engines.
FLEET_GEOM = dict(max_segments=1024, text_capacity=8192, remove_slots=4,
                  prop_slots=2, ops_per_step=16, megastep_k=8, max_insert_len=16)


def install_recorder(capacity: int):
    """A fresh flight recorder installed as the process's global one."""
    from fluidframework_tpu_torch.observability import FlightRecorder, install

    return install(FlightRecorder(capacity=capacity))


def recorder_line(rec, trace_dir: str | None, name: str, events=None) -> dict:
    """A trace's summary: phase shares and seconds per span name, events
    kept and dropped; the Chrome trace goes to ``trace_dir`` when given."""
    from fluidframework_tpu_torch.observability import phase_shares, phase_totals

    events = rec.events() if events is None else events
    out = {"events": len(events), "dropped": rec.dropped,
           "phase_shares": phase_shares(events), "phase_s": phase_totals(events)}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(rec.chrome_trace(), f)
        out["trace"] = path
    return out


def latency_gauges(eng) -> dict:
    """The engine's op-latency, watermark and overload surface."""
    h = eng.health()
    return {
        "latency_samples": h["latency_samples"],
        "latency_p50_ms": h.get("latency_p50_ms"), "latency_p99_ms": h.get("latency_p99_ms"),
        "ingest_watermarks": eng.ingest_watermarks(),
        **{k: h[k] for k in ("overload", "overloaded_docs", "overload_events",
                             "queue_depth_max")},
    }


def phase_fleet(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                rounds: int = 16, step_every: int = 8, sample: int = 64,
                recovery: str = "grow", geom: dict = FLEET_GEOM, ingest: str = "batch",
                record: bool = False, trace_dir: str | None = None) -> dict:
    """The fleet at ``recovery`` on ``device``: the first ``rounds`` rounds
    of ``traffic`` (``fleet_traffic``'s joins and rounds for ``n_docs``),
    each round through one ``ingest_batch`` call (``ingest="batch"``) or
    per-message ``ingest`` (``"message"``).  ``record`` installs a flight
    recorder for the timed window (phase shares in the line), then records
    a checkpoint sweep of the sampled docs into a scratch store."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    geom = dict(geom, recovery=recovery)
    joins, rounds_msgs = traffic[0], traffic[1][:rounds]
    check(len(rounds_msgs) == rounds, f"fleet: traffic holds {len(rounds_msgs)} rounds")
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
    rec = install_recorder(1 << 16) if record else None
    try:
        t_all = time.perf_counter()
        for r, msgs in enumerate(rounds_msgs):
            t1 = time.perf_counter()
            if ingest == "batch":
                eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])
            else:
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
        trace = None
        if rec is not None:
            trace = recorder_line(rec, trace_dir, f"fleet_{recovery}")
            # A recorded checkpoint sweep of the sampled docs (outside the
            # timed window: the fleet runs without a store).
            ck_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_ckpt_")
            try:
                eng.checkpoint_store = CheckpointStore(ck_dir)
                n0 = len(rec.events())
                written = eng.maybe_checkpoint(docs=[int(d) for d in pick])
                check(len(written) == len(pick),
                      f"fleet: checkpointed {len(written)} of {len(pick)} sampled docs")
                trace["sampled_checkpoint_s"] = recorder_line(
                    rec, None, "", rec.events()[n0:])["phase_s"]
            finally:
                eng.checkpoint_store = None
                shutil.rmtree(ck_dir, ignore_errors=True)
    finally:
        clock.close()
        if rec is not None:
            uninstall()
    ops_applied = eng.counters.get("ops_staged")
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
        "phase": "fleet", "card": card, "recovery": recovery, "ingest": ingest,
        "recorder": record, "docs": n_docs,
        "rounds": rounds, "ops_applied": ops_applied, "slices": slices,
        "megasteps": eng.counters.get("megastep_dispatches"),
        "ingest_s": ingest_s, "step_s": step_s,
        "compact_s": compact_s, "wall_s": wall_s, "ops_per_s": ops_applied / wall_s,
        "slice_s": clock.slice_s, "slice_rows": clock.slice_rows,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "ob_gate_syncs": eng.health()["ob_gate_syncs"],
        "ingest_batch_rows": eng.counters.get("ingest_batch_rows"),
        "sampled_docs_identical": same,
        **latency_gauges(eng),
    }
    if trace is not None:
        out["trace"] = trace
    emit(out)
    return out


def fault_traffic(n_docs: int, rounds: int, extra: int, geom: dict, seed: int):
    """Seeded faults for the recovery phase, over ``rounds`` rounds plus
    ``extra`` later ones, on docs away from the Zipf head (their Zipf
    traffic is dropped; writer w0 alone, each op seeing every earlier one):

    - 8 ``text`` docs append inserts of 4 chunks until the text pool passes
      ``text_capacity`` (ERR_TEXT_OVERFLOW) and remove 2 chars a round;
    - 8 ``seg`` docs insert 2 chars strictly inside a segment (+2 segments
      each) until they pass ``max_segments`` (ERR_SEG_OVERFLOW);
    - 4 ``pos`` docs insert once past their visible length in the middle
      round (ERR_POS_RANGE: quarantine), with valid inserts around it.

    Returns ({kind: [docs]}, {doc: [[message] per round]})."""
    from fluidframework_tpu_torch.protocol.messages import SequencedMessage

    rng = np.random.default_rng(seed + 7)
    skip = min(100, n_docs // 2)
    picks = rng.choice(np.arange(skip, n_docs), size=20, replace=False).tolist()
    plan = {"text": sorted(picks[:8]), "seg": sorted(picks[8:16]), "pos": sorted(picks[16:])}
    T, S, L = geom["text_capacity"], geom["max_segments"], geom["max_insert_len"]
    chunk = 4 * L
    text_per_round = -(-(T + chunk) // (rounds * chunk))
    seg_per_round = -(-(S // 2 + 8) // rounds)
    out = {}
    for kind, docs in plan.items():
        for d in docs:
            seq = 0
            length = 0
            segs = []  # the seg docs' segment lengths, in order
            per_round = []
            for r in range(rounds + extra):
                floor = seq
                msgs = []

                def op(contents):
                    nonlocal seq
                    seq += 1
                    msgs.append(SequencedMessage(
                        client_id="w0", client_seq=seq, ref_seq=seq - 1, seq=seq,
                        min_seq=floor, contents=contents,
                    ))

                if kind == "text":
                    for _ in range(text_per_round):
                        op({"type": 0, "pos1": length, "seg": "".join(
                            map(chr, rng.integers(97, 123, size=chunk)))})
                        length += chunk
                    op({"type": 1, "pos1": 0, "pos2": 2})
                    length -= 2
                elif kind == "seg":
                    if not segs:
                        op({"type": 0, "pos1": 0, "seg": "s" * L})
                        segs = [L]
                    for _ in range(seg_per_round):
                        cand = [i for i, n in enumerate(segs) if n >= 2]
                        i = cand[int(rng.integers(0, len(cand)))]
                        cut = int(rng.integers(1, segs[i]))
                        op({"type": 0, "pos1": sum(segs[:i]) + cut, "seg": "yz"})
                        segs[i:i + 1] = [cut, 2, segs[i] - cut]
                else:
                    if r == rounds // 2:
                        op({"type": 0, "pos1": length + 5, "seg": "bad"})
                    op({"type": 0, "pos1": 0, "seg": "ok"})
                    length += 2
                per_round.append(msgs)
            out[d] = per_round
    return plan, out


def _fleet_rounds(rounds_msgs, faults, r, docs=None):
    """Round ``r``'s messages: the Zipf traffic without the fault docs',
    then the fault docs' (restricted to ``docs`` when given)."""
    msgs = [(d, m) for d, m in rounds_msgs[r] if d not in faults]
    msgs += [(d, m) for d in sorted(faults) for m in faults[d][r]]
    return msgs if docs is None else [(d, m) for d, m in msgs if d in docs]


def _lane_of(eng, d: int):
    return ("overflow" if d in eng.overflow else "quarantine" if d in eng.quarantine
            else "oracle" if d in eng.oracles else "batch")


def _summary(eng, d: int) -> dict:
    """A doc's summary: its host oracle's, or its device state's through
    the checkpoint codec."""
    from fluidframework_tpu_torch.dds import kernel_backend as kb

    tree = eng.quarantine.get(d) or eng.oracles.get(d)
    if tree is not None:
        return tree.export_summary()
    names = {v: k for k, v in eng.hosts[d].prop_slot.items()}
    return kb.state_to_summary(eng.doc_state(d), names)


def _docs_equivalent(a, da: int, b, db: int) -> bool:
    """Two engines hold the same document: lane, lane geometry, text,
    annotations and summary (a restored row is the original's summary
    packed afresh, so its raw columns differ from a row with history)."""
    if (_lane_of(a, da), a.text(da), a.annotations(da)) != (_lane_of(b, db), b.text(db), b.annotations(db)):
        return False
    if da in a.overflow and (
        (a.overflow[da].geometry, a.overflow[da].growths)
        != (b.overflow[db].geometry, b.overflow[db].growths)
    ):
        return False
    return _summary(a, da) == _summary(b, db)


def _docs_identical(a, da: int, b, db: int) -> bool:
    """``_docs_equivalent`` and, for device-held docs, every raw state
    column (batch row or overflow lane) equal."""
    if not _docs_equivalent(a, da, b, db):
        return False
    return _lane_of(a, da) not in ("batch", "overflow") or _state_rows_equal(
        a.doc_state(da), b.doc_state(db))


def digest_bound(state) -> tuple[int, float]:
    """K4's bytes bound: every column it reads once (text, seg_len,
    seg_start, rem_keys, text_end, nseg) and its int64 output written once."""
    D, T = state.text.shape
    S = state.seg_len.shape[-1]
    nbytes = 4 * D * (T + (2 + len(state.rem_keys)) * S + 2) + 8 * D
    return nbytes, nbytes / H100_BYTES_PER_S * 1e3


def phase_recovery(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                   rounds: int = 16, step_every: int = 8, sample: int = 64,
                   geom: dict = FLEET_GEOM, tamper_docs: int = 256) -> dict:
    """The recovery and durability path at the fleet phase's geometry on
    ``device``: ``traffic`` (``fleet_traffic``'s joins and at least
    ``rounds`` + 2 rounds for ``n_docs``) with seeded faults through
    ``recovery="grow"``, a
    CPU replay of the faulted docs and a sample, two watchdog sweeps (K4
    timed against its bound), a tamper check, a forced checkpoint sweep,
    a restore into a fresh engine, and traffic after it."""
    import torch

    from fluidframework_tpu_torch.dds import kernel_backend as kb
    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine, fleet_digest
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    geom = dict(geom, recovery="grow")
    joins, rounds_msgs = traffic
    check(len(rounds_msgs) >= rounds + 2, f"recovery: traffic holds {len(rounds_msgs)} rounds")
    t0 = time.perf_counter()
    plan, faults = fault_traffic(n_docs, rounds, 2, geom, seed)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = resolve_positions.launches
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        eng = DocBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        # recover() as a whole (its error-count read waits for the queued
        # megasteps), and the grow replays inside it.
        timers = {"recover": 0.0, "_recover_doc": 0.0}
        for name in timers:
            def timed(*a, _fn=getattr(eng, name), _name=name, **kw):
                t = time.perf_counter()
                out = _fn(*a, **kw)
                timers[_name] += time.perf_counter() - t
                return out

            setattr(eng, name, timed)
        for d, m in joins:
            eng.ingest(d, m)
        t_all = time.perf_counter()
        for r in range(rounds):
            for d, m in _fleet_rounds(rounds_msgs, faults, r):
                eng.ingest(d, m)
            if (r + 1) % step_every == 0 or r + 1 == rounds:
                eng.step()
                eng.compact()
                sync()
        wall_s = time.perf_counter() - t_all
        ops_applied = eng.counters.get("ops_staged")
        check(not eng.errors().any(), "recovery left error bits")
        check(sorted(eng.overflow) == sorted(plan["text"] + plan["seg"]),
              f"overflow lanes {sorted(eng.overflow)}")
        check(all(eng.overflow[d].geometry["text_capacity"] == 2 * geom["text_capacity"]
                  for d in plan["text"]), "text lanes not at twice the text capacity")
        check(all(eng.overflow[d].geometry["max_segments"] == 2 * geom["max_segments"]
                  for d in plan["seg"]), "segment lanes not at twice the segments")
        check(sorted(eng.quarantine) == plan["pos"], f"quarantined {sorted(eng.quarantine)}")

        # The faulted docs and a sample replayed on the CPU, same rounds.
        rng = np.random.default_rng(seed + 2)
        others = np.setdiff1d(np.arange(n_docs), np.asarray(sorted(faults)))
        pick = sorted(faults) + sorted(rng.choice(others, size=min(sample, len(others)),
                                                  replace=False).tolist())
        local = {d: j for j, d in enumerate(pick)}
        cpu = DocBatchEngine(len(pick), device="cpu", **geom)
        t1 = time.perf_counter()
        for d, m in joins:
            if d in local:
                cpu.ingest(local[d], m)
        for r in range(rounds):
            for d, m in _fleet_rounds(rounds_msgs, faults, r, local):
                cpu.ingest(local[d], m)
            if (r + 1) % step_every == 0 or r + 1 == rounds:
                cpu.step()
                cpu.compact()
        cpu_replay_s = time.perf_counter() - t1
        same = sum(_docs_identical(eng, d, cpu, j) for d, j in local.items())
        check(same == len(pick), f"{len(pick) - same} of {len(pick)} docs differ from the CPU replay")

        # Watchdog at full width: two sweeps of 64, then K4 alone.
        t1 = time.perf_counter()
        failed = eng.watchdog(sample=64) + eng.watchdog(sample=64)
        sync()
        watchdog_s = time.perf_counter() - t1
        check(not failed, f"watchdog failed docs {failed}")
        wd = {k: eng.counters.get(k) for k in ("watchdog_checks", "watchdog_prefiltered")}
        # Sweep 1 verifies 64 of the batch docs; sweep 2 skips those (their
        # digest and stream did not move) and verifies the next 64.
        eligible = n_docs - len(faults)
        first = min(64, eligible)
        check(wd == {"watchdog_checks": first + min(64, eligible - first),
                     "watchdog_prefiltered": first}, f"watchdog {wd}")
        peak_mem = torch.cuda.max_memory_allocated() if on_card else None
        dig_bytes, dig_bound_ms = digest_bound(eng.state)
        digest = {"digest_bytes": dig_bytes, "digest_bound_ms": dig_bound_ms}
        if on_card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            card_dig = fleet_digest(eng.state)
            sync()
            digest.update(
                digest_peak_extra_bytes=torch.cuda.max_memory_allocated() - base,
                digest_ms=cuda_ms(lambda: fleet_digest(eng.state), 10, warmup=2),
                digest_device_ms=_device_sum(device_ms_by_name(lambda: fleet_digest(eng.state), 10)),
            )
            cpu_dig = fleet_digest(mk.from_numpy(mk.to_numpy(eng.state), device="cpu"))
            check(torch.equal(card_dig.cpu(), cpu_dig), "K4 on the card differs from the CPU")

        # Tamper check on a separate engine at the same geometry.
        tw = DocBatchEngine(tamper_docs, device=device, **geom)
        t_joins, t_rounds = fleet_traffic(tamper_docs, 2, geom["ops_per_step"], 8, seed + 3)
        for d, m in t_joins + [x for rnd in t_rounds for x in rnd]:
            tw.ingest(d, m)
        tw.step()
        check(tw.watchdog(sample=tamper_docs) == [], "tamper engine: clean sweep failed")
        victim = int(np.random.default_rng(seed + 4).integers(0, tamper_docs))
        row = mk.to_numpy(mk.doc_row(tw.state, victim))
        _, vis = mk._host_vis(row, mk.ALL_ACKED, -3)
        seg = int(np.flatnonzero(vis & (row.seg_len[: len(vis)] > 0))[0])
        at = int(row.seg_start[seg])
        before_text = tw.text(victim)
        pref0 = tw.counters.get("watchdog_prefiltered")
        tw.state.text[victim, at] = 97 + (int(row.text[at]) - 96) % 26
        check(mk.visible_text(mk.doc_row(tw.state, victim)) != before_text, "tamper changed nothing")
        t_card = fleet_digest(tw.state).cpu()
        t_cpu = fleet_digest(mk.from_numpy(mk.to_numpy(tw.state), device="cpu"))
        check(torch.equal(t_card, t_cpu), "K4 differs between the card and the CPU (tamper rows)")
        caught = tw.watchdog(sample=tamper_docs)
        tamper = {
            "tamper_docs": tamper_docs, "tamper_caught": caught,
            "tamper_prefiltered": tw.counters.get("watchdog_prefiltered") - pref0,
        }
        check(caught == [victim] and victim in tw.quarantine, f"tamper: caught {caught}")
        check(tamper["tamper_prefiltered"] == tamper_docs - 1, f"tamper {tamper}")
        check(tw.text(victim) == before_text, "tampered doc's oracle text differs")
        del tw

        # Checkpoint sweep, then restore into a fresh engine.
        t1 = time.perf_counter()
        written = eng.maybe_checkpoint(force=True)
        checkpoint_s = time.perf_counter() - t1
        ck_root = os.path.join(ck_dir, "checkpoints")
        ck_bytes = sum(os.path.getsize(os.path.join(ck_root, n)) for n in os.listdir(ck_root))
        check(len(written) == n_docs, f"checkpointed {len(written)}")
        eng2 = DocBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        t1 = time.perf_counter()
        restored = eng2.restore_from_checkpoints()
        sync()
        restore_s = time.perf_counter() - t1
        check(restored == sorted(written), "restore missed docs")
        # Every restored doc holds the original's summary, lane and text;
        # a sampled batch row equals, column by column, the original's
        # summary packed at the batch geometry (what restore must write).
        check(all(_docs_equivalent(eng, d, eng2, d) for d in restored), "restored docs differ")
        sampled = [d for d in pick if d in set(restored)]
        for d in sampled:
            if _lane_of(eng, d) == "batch":
                want = kb.summary_to_state_host(
                    _summary(eng, d), eng2.geometry, eng2.hosts[d].prop_slot.__getitem__)
                check(_state_rows_equal(eng2.doc_state(d), mk.from_numpy(want, device="cpu")),
                      f"restored row {d} is not its summary's pack")

        # The parallel restore's scatter alone (K4's neighbour on the table):
        # the restored batch rows written again from a host stack — the
        # same bytes, so the state does not change.
        scatter = {}
        if on_card:
            rows = [int(eng2._slot[d]) for d in restored if _lane_of(eng2, d) == "batch"]
            stacked = mk.tree_map(lambda x: x[rows], mk.to_numpy(eng2.state))
            nbytes = 2 * sum(x.nbytes for x in mk.leaves(stacked))
            # The library part alone: one ``index_copy_`` per leaf from rows
            # already on the card (the host-to-device copy left out).
            idx = torch.tensor(rows, device="cuda")
            on_dev = [torch.from_numpy(y).cuda() for y in mk.leaves(stacked)]

            def index_copy():
                for x, y in zip(mk.leaves(eng2.state), on_dev):
                    x.index_copy_(0, idx, y)

            scatter = {
                "scatter_rows": len(rows), "scatter_bytes": nbytes,
                "scatter_bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                "scatter_ms": cuda_ms(lambda: eng2._scatter_rows(rows, stacked), 3, warmup=1),
                "scatter_device_ms": _device_sum(device_ms_by_name(
                    lambda: eng2._scatter_rows(rows, stacked), 3)),
                "scatter_library_ms": cuda_ms(index_copy, 3, warmup=1),
                "scatter_library_device_ms": _device_sum(device_ms_by_name(index_copy, 3)),
            }
            del stacked, on_dev

        # Two more rounds to both engines, then one checkpointed round again.
        live = set(restored)
        for r in (rounds, rounds + 1):
            for d, m in _fleet_rounds(rounds_msgs, faults, r, live):
                eng.ingest(d, m)
                eng2.ingest(d, m)
        for e in (eng, eng2):
            e.step()
            e.compact()
        sync()
        check(eng2.counters.get("checkpointed_ops_skipped") == 0, "new ops were skipped")
        check(all(_docs_equivalent(eng, d, eng2, d) for d in sampled),
              "post-restore traffic diverged")
        dig0 = fleet_digest(eng2.state).cpu()
        for d, m in _fleet_rounds(rounds_msgs, faults, rounds - 1, live):
            eng2.ingest(d, m)
        eng2.step()
        skipped = eng2.counters.get("checkpointed_ops_skipped")
        check(skipped > 0 and torch.equal(fleet_digest(eng2.state).cpu(), dig0)
              and all(_docs_equivalent(eng, d, eng2, d) for d in sampled),
              "re-fed checkpointed round changed the restored engine")
        health = eng.health()
        out = {
            "phase": "recovery", "card": card, "docs": n_docs, "rounds": rounds,
            "recovery": "grow", "faults": {k: len(v) for k, v in plan.items()},
            "fault_gen_s": gen_s, "ops_applied": ops_applied, "wall_s": wall_s,
            "ops_per_s": ops_applied / wall_s, "recover_s": timers["recover"],
            "replay_s": timers["_recover_doc"],
            "cpu_replay_docs": len(pick), "cpu_replay_s": cpu_replay_s,
            "watchdog_s": watchdog_s, **wd, **digest, **tamper,
            "checkpoint_docs": len(written), "checkpoint_bytes": ck_bytes,
            "checkpoint_s": checkpoint_s, "restore_docs": len(restored),
            "restore_s": restore_s, **scatter, "peak_mem_bytes": peak_mem,
            # Since K4's measurement: the restore's second engine included.
            "peak_mem_restore_bytes": torch.cuda.max_memory_allocated() if on_card else None,
            "checkpointed_ops_skipped": skipped,
            "k1_launches": resolve_positions.launches - launches0,
            **{k: health.get(k) for k in (
                "capacity_recoveries", "quarantines", "poison_ops_dropped",
                "recovery_replay_len", "quarantine_replay_len", "overflow_docs",
                "quarantined_docs", "checkpoints_written", "megastep_dispatches",
                "megastep_slices")},
            "docs_restored": eng2.counters.get("docs_restored"),
        }
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
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


# ------------------------------------------------- fleet programs alone

def nbytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_program(fn, iters: int, prof_iters: int | None = None, uncounted=None) -> dict:
    """Call time (CUDA events over ``iters`` back-to-back calls) and device
    time (torch.profiler over ``prof_iters`` calls, every activity) of one
    device program.  ``uncounted``: the program whose launch counter the
    timing calls leave as they found it (timing inside a main-path phase,
    whose count is the path's own launches)."""
    launches = uncounted.launches if uncounted is not None else None
    out = {"ms": cuda_ms(fn, iters, warmup=1),
           "device_ms": _device_sum(device_ms_by_name(fn, prof_iters or iters))}
    if uncounted is not None:
        uncounted.launches = launches
    return out


def state_bound(state_leaves, ring_leaves=()) -> tuple[int, float]:
    """The bytes bound of a program that reads and writes a state once and
    reads an op ring once, at the card's memory rate."""
    nbytes = 2 * nbytes_of(state_leaves) + nbytes_of(ring_leaves)
    return nbytes, nbytes / H100_BYTES_PER_S * 1e3


def phase_fleet_programs(seed: int, card: str, traffic, n_docs: int = 10_000,
                         geom: dict = FLEET_GEOM, hot_S: int = 16_384,
                         hot_T: int = 131_072, hot_rounds: int = 96) -> dict:
    """K2 (``apply_megastep``), K3 (``set_min_seq`` + ``compact``) and K6
    (``apply_megastep_seg``, ``compact_seg``) timed alone on the card.

    K2 and K3 run at the fleet phase's geometry on the state and ring of
    its second megastep: an engine takes rounds 0-7 of ``traffic`` and
    steps and compacts, then rounds 8-15 are drained into one K=8 ring.
    K6 runs at the hot document's geometry on the state after half of its
    trace, with the next K x B chunk.  Each is printed beside its bytes
    bound (state read and written once, plus the ring)."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine, _fleet_compact_body
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.parallel import mesh as pm

    joins, rounds_msgs = traffic
    eng = DocBatchEngine(n_docs, device="cuda", **dict(geom, recovery="off"))
    for d, m in joins:
        eng.ingest(d, m)
    for r in range(8):
        for d, m in rounds_msgs[r]:
            eng.ingest(d, m)
    eng.step()
    eng.compact()
    for r in range(8, 16):
        for d, m in rounds_msgs[r]:
            eng.ingest(d, m)
    busy = sorted(eng._busy)
    K = eng._select_k(busy)
    stage = eng._staging()
    ops, pays = stage.acquire(K, eng.capacity)
    for k in range(K):
        rows = [int(r) for r in eng._slot[busy]]  # the docs' state rows
        stage.mark(k, eng._drain_into(busy, ops[k], pays[k], rows=rows))
        busy = [d for d in busy if d in eng._busy]
    kinds = ops[..., 0].copy()
    dev_ops, dev_pays = stage.upload(ops, pays)
    state = eng.state
    torch.cuda.synchronize()
    k2 = time_program(lambda: mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds), 2, 1)
    after = mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds)
    mins = torch.as_tensor([h.min_seq for h in eng.hosts], dtype=torch.int32, device="cuda")
    k3 = time_program(lambda: _fleet_compact_body(after, mins), 5)
    k2_bytes, k2_bound = state_bound(mk.leaves(state), (dev_ops, dev_pays))
    k3_bytes, k3_bound = state_bound(mk.leaves(state), (mins,))
    del eng, state, after

    L, Kh, B = 8, 8, 16
    h_ops, h_pays, h_refs = four_writer_trace(seed, hot_rounds, L)
    chunks = len(h_ops) // (Kh * B)
    mesh = pm.docs_segs_mesh("cuda", seg_shards=1)
    proto = mk.init_state(hot_S, 4, 2, hot_T, 8, device="cuda")
    blocked = mk.seg_shard_state(proto, 1)
    seg_prog = pm.mesh_seg_program(mk.apply_megastep_seg, mesh, pm.seg_state_specs(blocked))
    seg_compact = pm.mesh_seg_program(mk.compact_seg, mesh)
    seg = pm.shard_seg_state(blocked, mesh)

    def chunk(c):
        rows = slice(c * Kh * B, (c + 1) * Kh * B)
        return (h_ops[rows].reshape(Kh, B, 8), h_pays[rows].reshape(Kh, B, L),
                int(h_refs[(c + 1) * Kh * B - 1]))

    for c in range(chunks // 2):
        o, p, ms = chunk(c)
        seg = seg_compact(seg_prog(seg, o, p), ms)
    o, p, ms = chunk(chunks // 2)
    o_t, p_t = torch.from_numpy(o).cuda(), torch.from_numpy(p).cuda()
    okinds = o[..., 0].copy()
    torch.cuda.synchronize()
    k6_mega = time_program(lambda: seg_prog(seg, o_t, p_t, kinds=okinds), 2, 1)
    seg_after = seg_prog(seg, o_t, p_t, kinds=okinds)
    k6_compact = time_program(lambda: seg_compact(seg_after, ms), 5)
    k6_bytes, k6_bound = state_bound(mk.leaves(seg), (o_t, p_t))
    k6c_bytes, k6c_bound = state_bound(mk.leaves(seg))
    out = {
        "phase": "fleet_programs", "card": card,
        "k2": {"shape": [K, n_docs, geom["ops_per_step"]], **k2,
               "bound_ms": k2_bound, "bound_bytes": k2_bytes, "bound_by": "bytes"},
        "k3": {"docs": n_docs, **k3, "bound_ms": k3_bound, "bound_bytes": k3_bytes,
               "bound_by": "bytes"},
        "k6_megastep": {"shape": [Kh, B], "S": hot_S, "T": hot_T, **k6_mega,
                        "bound_ms": k6_bound, "bound_bytes": k6_bytes, "bound_by": "bytes"},
        "k6_compact": {"S": hot_S, "T": hot_T, **k6_compact, "bound_ms": k6c_bound,
                       "bound_bytes": k6c_bytes, "bound_by": "bytes"},
    }
    emit(out)
    return out


# ----------------------------------------------------------- tree paths

# The tree fleet's geometry (``bench.py`` ``bench_config5`` at fleet width).
TREE_FLEET_GEOM = dict(capacity=2048, pool_capacity=16_384, ops_per_step=32, megastep_k=8)
TREE_DEEP_GEOM = dict(capacity=16_384, pool_capacity=65_536, ops_per_step=32, megastep_k=8)
TREE_CHURN_GEOM = dict(capacity=128, pool_capacity=1024, ops_per_step=32, megastep_k=8)


def tree_traffic(seed: int, n_docs: int, rounds: int, writers: int = 4,
                 ops_per_writer: int = 8, faulted=(), fault_edits: int = 0,
                 fault_leaves: int = 32, shared_leaves: int = 0, churn: bool = False):
    """SharedTree edit streams of ``bench.py``'s ``bench_config5`` shape as
    sequenced wire messages: per doc ``writers`` writer-owned subtrees
    (an ``obj`` node whose ``kids`` field starts as one leaf) plus one
    shared subtree, seeded by writer 0, then ``rounds`` rounds in which
    each writer submits ``ops_per_writer`` edits with its ref_seq at the
    round start (one round of lag).  Even edits insert into the shared
    ``kids`` at 0 (concurrent inserts that rebase against each other),
    odd ones set (half) or insert (half) in the writer's own subtree;
    leaves are 40% strings of 3-10 chars, else ints.

    - ``shared_leaves``: the shared subtree starts with that many leaves,
      and the whole seed is one commit;
    - ``churn``: each writer alternates an insert and a remove in its own
      subtree instead;
    - ``faulted`` docs: writer 0 adds ``fault_edits`` edits a round, each
      inserting ``fault_leaves`` int leaves into its own subtree.

    Returns ``rounds + 1`` lists of (doc, message): the seed round, then
    one per round."""
    from fluidframework_tpu_torch.dds.tree.changeset import (
        commit_to_json, make_insert, make_remove, make_set_value,
    )
    from fluidframework_tpu_torch.dds.tree.forest import Node
    from fluidframework_tpu_torch.dds.tree.schema import leaf
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    W = writers
    faulted = set(int(d) for d in faulted)

    def rand_leaf():
        if rng.random() < 0.4:
            n = int(rng.integers(3, 11))
            return leaf("".join(chr(97 + int(c)) for c in rng.integers(0, 26, n)))
        return leaf(int(rng.integers(1000)))

    def msg(seq, ref, w, rev, change):
        return SequencedMessage(
            client_id=f"w{w}", client_seq=rev, ref_seq=ref, seq=seq,
            min_seq=max(0, ref - 1), type=MessageType.OP,
            contents={"type": "edit", "sid": f"s{w}", "rev": rev,
                      "changes": commit_to_json([change])})

    out = [[] for _ in range(rounds + 1)]
    for d in range(n_docs):
        nodes = [Node(type="obj", fields={"kids": [leaf(0)]}) for _ in range(W)]
        nodes.append(Node(type="obj", fields={"kids": (
            [rand_leaf() for _ in range(shared_leaves)] if shared_leaves else [leaf(0)])}))
        if shared_leaves:
            seed_changes = [make_insert([], "", 0, nodes)]
        else:
            seed_changes = [make_insert([], "", i, [n]) for i, n in enumerate(nodes)]
        seq = 0
        for ch in seed_changes:
            seq += 1
            out[0].append((d, msg(seq, seq - 1, 0, seq, ch)))
        revs = [seq] * W
        sizes = [1] * W
        for r in range(1, rounds + 1):
            ref = seq
            for w in range(W):
                for k in range(ops_per_writer):
                    seq += 1
                    revs[w] += 1
                    if churn:
                        if k % 2 == 1 and sizes[w] > 0:
                            ch = make_remove([("", w)], "kids", int(rng.integers(sizes[w])), 1)
                            sizes[w] -= 1
                        else:
                            ch = make_insert([("", w)], "kids", int(rng.integers(sizes[w] + 1)),
                                             [rand_leaf()])
                            sizes[w] += 1
                    elif k % 2 == 0:
                        ch = make_insert([("", W)], "kids", 0, [rand_leaf()])
                    elif rng.random() < 0.5 and sizes[w] > 0:
                        ch = make_set_value([("", w), ("kids", int(rng.integers(sizes[w])))],
                                            rand_leaf().value)
                    else:
                        ch = make_insert([("", w)], "kids", int(rng.integers(sizes[w] + 1)),
                                         [rand_leaf()])
                        sizes[w] += 1
                    out[r].append((d, msg(seq, ref, w, revs[w], ch)))
                if w == 0 and d in faulted:
                    for _ in range(fault_edits):
                        seq += 1
                        revs[w] += 1
                        ch = make_insert([("", w)], "kids", 0, [
                            leaf(int(v)) for v in rng.integers(1000, size=fault_leaves)])
                        sizes[w] += fault_leaves
                        out[r].append((d, msg(seq, ref, w, revs[w], ch)))
    return out


def _drive_tree(eng, rounds_msgs, local=None, on_card: bool = False) -> dict:
    """Ingest each round's messages (those of the docs in ``local``,
    renumbered through it, when given) and step after each round."""
    import torch

    ingest_s = step_s = 0.0
    edits = slices = 0
    for msgs in rounds_msgs:
        t = time.perf_counter()
        for d, m in msgs:
            if local is None:
                eng.ingest(d, m)
            elif d in local:
                eng.ingest(local[d], m)
            else:
                continue
            edits += 1
        ingest_s += time.perf_counter() - t
        t = time.perf_counter()
        slices += eng.step()
        if on_card:
            torch.cuda.synchronize()
        step_s += time.perf_counter() - t
    return {"edits": edits, "ingest_s": ingest_s, "step_s": step_s, "slices": slices}


def _tree_views_equal(a, da: int, b, db: int) -> bool:
    """Two tree engines hold the same document: lane, ``tree_json`` and
    ``values`` and the EditManager summary, compared as JSON text (True
    and 1 differ; a restored summary holds lists where the live one holds
    tuples)."""
    return (
        (da in a.fallbacks) == (db in b.fallbacks)
        and json.dumps(a.tree_json(da)) == json.dumps(b.tree_json(db))
        and json.dumps(a.values(da)) == json.dumps(b.values(db))
        and json.dumps(a.hosts[da].em.summarize(), sort_keys=True)
        == json.dumps(b.hosts[db].em.summarize(), sort_keys=True)
    )


def _tree_docs_identical(a, da: int, b, db: int) -> bool:
    """``_tree_views_equal`` and every raw column of the two device rows."""
    import torch

    sa, sb = int(a._slot[da]), int(b._slot[db])  # the docs' state rows
    return _tree_views_equal(a, da, b, db) and all(
        torch.equal(x[sa].cpu(), y[sb].cpu()) for x, y in zip(a.state, b.state)
    )


def _tree_replay(geom, rounds_msgs, docs) -> tuple:
    """The listed docs' streams through a TreeBatchEngine on the CPU,
    stepped at the same rounds; returns (engine, doc -> local index)."""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    local = {int(d): j for j, d in enumerate(docs)}
    ref = TreeBatchEngine(len(docs), device="cpu", **geom)
    t = time.perf_counter()
    _drive_tree(ref, rounds_msgs, local)
    return ref, local, time.perf_counter() - t


def _tree_run_line(name, card, eng, run, gen_s, on_card, compacts) -> dict:
    import torch

    h = eng.health()
    wall = run["ingest_s"] + run["step_s"]
    return {
        "phase": name, "card": card, "docs": eng.n_docs, "edits": run["edits"],
        "traffic_gen_s": gen_s, "ingest_s": run["ingest_s"], "step_s": run["step_s"],
        "edits_per_s": run["edits"] / wall,
        "host_translation_edits_per_s": run["edits"] / run["ingest_s"],
        "slices": run["slices"], "dispatches": h["megastep_dispatches"],
        "compacts": compacts, "fallback_docs": sorted(eng.fallbacks),
        "device_fraction": eng.device_fraction(),
        "translation_plan_hit_rate": h["translation_plan_hit_rate"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
    }


def phase_tree_fleet(seed: int, card: str, device: str, n_docs: int = 1024,
                     rounds: int = 4, n_faulted: int = 4, sample: int = 64,
                     fault_edits: int = 24, geom: dict = TREE_FLEET_GEOM,
                     record: bool = False, trace_dir: str | None = None) -> tuple:
    """The SharedTree fleet: ``bench_config5``'s stream at ``n_docs`` docs
    through ``TreeBatchEngine.ingest``/``step`` (a step after every
    round), with ``n_faulted`` seeded docs whose writer 0 inserts
    ``fault_edits`` x 32 extra leaves a round until they pass
    ``capacity`` rows: they must latch on the device and route to the host
    fallback.  Then a CPU replay of a seeded sample plus the faulted docs
    (raw columns, views and summaries identical, same fallbacks), a forced
    checkpoint sweep restored into a fresh engine (every doc's views and
    summary equal), and one more round through both engines.  ``record``
    installs a flight recorder over the timed rounds (the host-fold phase
    shares in the line).  Returns the phase's line and the inputs of a K7
    ring that the engine stages from a further round
    (``tree_fleet_ring``), for timing K7 and K8 alone."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"
    rng = np.random.default_rng(seed + 11)
    faulted = sorted(int(d) for d in rng.choice(n_docs, size=n_faulted, replace=False))
    t0 = time.perf_counter()
    traffic = tree_traffic(seed, n_docs, rounds + 2, faulted=faulted, fault_edits=fault_edits)
    gen_s = time.perf_counter() - t0
    main_rounds, extra, ring_round = traffic[:rounds + 1], traffic[rounds + 1:rounds + 2], traffic[-1]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_tree_ckpt_")
    try:
        eng = TreeBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        k8_0 = tk.compact_nested.launches
        rec = install_recorder(1 << 20) if record else None
        try:
            run = _drive_tree(eng, main_rounds, on_card=on_card)
        finally:
            if rec is not None:
                uninstall()
        line = _tree_run_line("tree_fleet", card, eng, run, gen_s, on_card,
                              tk.compact_nested.launches - k8_0)
        if rec is not None:
            line["recorder"] = True
            line["trace"] = recorder_line(rec, trace_dir, "tree_fleet")
        check(not eng.errors().any(), "tree_fleet: error bits left after step()")
        check(sorted(eng.fallbacks) == faulted,
              f"tree_fleet: fallbacks {sorted(eng.fallbacks)}, expected the faulted docs {faulted}")
        others = [h for d, h in enumerate(eng.hosts) if d not in eng.fallbacks]
        check(all(h.device_commits == h.total_commits for h in others),
              "tree_fleet: a commit of a device doc did not apply on the device")
        total = sum(h.total_commits for h in eng.hosts)
        host_only = sum(eng.hosts[d].total_commits - eng.hosts[d].device_commits for d in faulted)
        check(eng.device_fraction() == (total - host_only) / total,
              "tree_fleet: device_fraction is not the faulted docs' post-routing commits")

        pick = np.random.default_rng(seed + 1).choice(
            [d for d in range(n_docs) if d not in faulted], size=min(sample, n_docs - n_faulted),
            replace=False)
        docs = sorted(int(d) for d in pick) + faulted
        ref, local, replay_s = _tree_replay(geom, main_rounds, docs)
        same = sum(_tree_docs_identical(eng, d, ref, local[d]) for d in docs)
        check(same == len(docs), f"tree_fleet: {len(docs) - same} of {len(docs)} docs differ from the CPU replay")
        check(sorted(ref.fallbacks) == sorted(local[d] for d in faulted),
              "tree_fleet: the CPU replay routed other docs")

        t = time.perf_counter()
        written = eng.maybe_checkpoint(force=True)
        sweep_s = time.perf_counter() - t
        ck_bytes = sum(os.path.getsize(os.path.join(root, f))
                       for root, _dirs, files in os.walk(ck_dir) for f in files)
        check(len(written) == n_docs, f"tree_fleet: checkpointed {len(written)} of {n_docs} docs")
        eng2 = TreeBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        t = time.perf_counter()
        restored = eng2.restore_from_checkpoints()
        restore_s = time.perf_counter() - t
        t = time.perf_counter()
        eng2.step()
        if on_card:
            torch.cuda.synchronize()
        rematerialize_s = time.perf_counter() - t
        check(len(restored) == n_docs, f"tree_fleet: restored {len(restored)} of {n_docs} docs")
        same = sum(_tree_views_equal(eng, d, eng2, d) for d in range(n_docs))
        check(same == n_docs, f"tree_fleet: {n_docs - same} restored docs differ")
        _drive_tree(eng, extra, on_card=on_card)
        _drive_tree(eng2, extra, on_card=on_card)
        same = sum(_tree_views_equal(eng, d, eng2, d) for d in range(n_docs))
        check(same == n_docs, f"tree_fleet: {n_docs - same} docs differ after a round past the restore")
        check(not eng.errors().any() and not eng2.errors().any(),
              "tree_fleet: error bits after the round past the restore")
        ring = tree_fleet_ring(eng, ring_round)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    line.update({
        "rounds": rounds, "faulted": faulted, "replayed_docs": len(docs),
        "cpu_replay_s": replay_s, "checkpoint_s": sweep_s, "checkpoint_bytes": ck_bytes,
        "restore_s": restore_s, "rematerialize_s": rematerialize_s,
        "restored_identical": n_docs, "identical_after_extra_round": n_docs,
    })
    emit(line)
    return line, ring


def tree_fleet_ring(eng, msgs) -> tuple:
    """K7's inputs as the engine's next step would see them: ``msgs``
    ingested, then one ring staged from the queues as ``_step_fleet``
    stages it (the engine's own ``_select_k``, ``_staging`` and
    ``_drain_into``).  Returns (state, ops, payloads, host ops)."""
    for d, m in msgs:
        eng.ingest(d, m)
    busy = sorted(eng._busy)
    K = eng._select_k(busy)
    stage = eng._staging()
    ops, pays = stage.acquire(K, eng.fleet_capacity)
    for k in range(K):
        stage.mark(k, eng._drain_into(busy, ops[k], pays[k]))
        busy = [d for d in busy if d in eng._busy]
    host_ops = ops[..., :3].copy()
    dev_ops, dev_pays = stage.upload(ops, pays)
    return eng.state, dev_ops, dev_pays, host_ops


def tree_deep_traffic(seed: int, writers: int = 32, rounds: int = 4, leaves: int = 10_000):
    """tree_deep's stream (``tree_traffic`` of one doc seeded by one commit
    with a shared subtree of ``leaves`` leaves)."""
    return tree_traffic(seed + 5, 1, rounds, writers=writers, shared_leaves=leaves)


def phase_tree_deep(seed: int, card: str, device: str, writers: int = 32, rounds: int = 4,
                    leaves: int = 10_000, geom: dict = TREE_DEEP_GEOM) -> tuple:
    """``BASELINE.json`` config 5's shape: one document seeded by one commit
    of ``writers`` writer subtrees and a shared subtree of ``leaves``
    mixed-type leaves, then ``writers`` x 8 edits a round for ``rounds``
    rounds; the whole doc stays on the device and equals a CPU replay.
    Returns the phase's line and its engine (the pooled fold's result that
    the ``tree_rebase`` path holds its device window against)."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    on_card = device == "cuda"
    t0 = time.perf_counter()
    traffic = tree_deep_traffic(seed, writers, rounds, leaves)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = TreeBatchEngine(1, device=device, **geom)
    k8_0 = tk.compact_nested.launches
    run = _drive_tree(eng, traffic, on_card=on_card)
    line = _tree_run_line("tree_deep", card, eng, run, gen_s, on_card,
                          tk.compact_nested.launches - k8_0)
    check(not eng.errors().any(), "tree_deep: error bits left after step()")
    check(not eng.fallbacks and eng.device_fraction() == 1.0,
          f"tree_deep: device_fraction {eng.device_fraction()}, fallbacks {sorted(eng.fallbacks)}")
    ref, local, replay_s = _tree_replay(geom, traffic, [0])
    check(_tree_docs_identical(eng, 0, ref, 0), "tree_deep: the doc differs from its CPU replay")
    line.update({"writers": writers, "rounds": rounds, "seed_leaves": leaves,
                 "nodes": int(eng.state.alive.sum()), "cpu_replay_s": replay_s})
    emit(line)
    return line, eng


def phase_tree_churn(seed: int, card: str, device: str, n_docs: int = 256, rounds: int = 8,
                     sample: int = 64, geom: dict = TREE_CHURN_GEOM) -> tuple:
    """Insert/remove churn: each writer alternates an insert and a remove
    in its own subtree, so the host's row bound passes 75% of ``capacity``
    while live rows stay low; K8 (``compact_nested``) must run, and a
    seeded sample equals its CPU replay.  Returns the line and (the engine,
    its traffic as per-round, per-doc JSON-lines chunks): the wire_ingest
    path holds ``ingest_lines`` against it."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    on_card = device == "cuda"
    t0 = time.perf_counter()
    traffic = tree_traffic(seed + 9, n_docs, rounds, churn=True)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = TreeBatchEngine(n_docs, device=device, **geom)
    k8_0 = tk.compact_nested.launches
    run = _drive_tree(eng, traffic, on_card=on_card)
    k8 = tk.compact_nested.launches - k8_0
    line = _tree_run_line("tree_churn", card, eng, run, gen_s, on_card, k8)
    check(not eng.errors().any() and not eng.fallbacks,
          f"tree_churn: error bits or fallbacks {sorted(eng.fallbacks)}")
    if on_card:
        check(k8 > 0, "tree_churn: compact_nested never launched")
    docs = sorted(int(d) for d in np.random.default_rng(seed + 2).choice(
        n_docs, size=min(sample, n_docs), replace=False))
    ref, local, replay_s = _tree_replay(geom, traffic, docs)
    same = sum(_tree_docs_identical(eng, d, ref, local[d]) for d in docs)
    check(same == len(docs), f"tree_churn: {len(docs) - same} of {len(docs)} docs differ from the CPU replay")
    line.update({"rounds": rounds, "live_rows_max": int(eng.state.alive.sum(-1).max()),
                 "replayed_docs": len(docs), "cpu_replay_s": replay_s})
    emit(line)
    # The wire_ingest path takes the stream as JSON-lines chunks (bytes,
    # which the garbage collector does not track), so the messages die here.
    return line, (eng, [_doc_blobs(n_docs, msgs) for msgs in traffic])


def wire_traffic(n_docs: int, rounds: int, writers: int, seed: int) -> tuple:
    """``bench.py``'s ``_string_ingest_rate`` stream: every round each of
    ``writers`` writers inserts "abcd" at a random position of every doc,
    valid at the round start (ref_seq and MSN at the round start).
    Returns the joins and the ops as (doc, message) lists."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    joins = [
        (d, SequencedMessage(
            seq=0, min_seq=0, ref_seq=0, client_id=f"w{w}", client_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w}))
        for d in range(n_docs) for w in range(writers)
    ]
    lengths = np.zeros((n_docs,), np.int64)
    seqs = np.zeros((n_docs,), np.int64)
    ops = []
    for r in range(rounds):
        refs = seqs.copy()
        for w in range(writers):
            for d in range(n_docs):
                pos = int(rng.integers(0, lengths[d] + 1))
                seqs[d] += 1
                ops.append((d, SequencedMessage(
                    seq=int(seqs[d]), min_seq=int(refs[d]), ref_seq=int(refs[d]),
                    client_id=f"w{w}", client_seq=r, type=MessageType.OP,
                    contents={"type": 0, "pos1": pos, "seg": "abcd"})))
        lengths += 4 * writers
    return joins, ops


def _doc_blobs(n_docs: int, msgs) -> list[bytes]:
    """Each doc's messages as one JSON-lines chunk, in stream order."""
    parts = [[] for _ in range(n_docs)]
    for d, m in msgs:
        parts[d].append(m.wire_line())
    return [b"".join(p) for p in parts]


def phase_wire_ingest(seed: int, card: str, device: str, churn, n_docs: int = 128,
                      rounds: int = 16, writers: int = 4, geom: dict = FLEET_GEOM) -> dict:
    """The wire-ingest paths.  ``bench.py``'s config-3 ingest probe stream
    (``_string_ingest_rate(128, rounds=16, writers=4)``) at config-3
    geometry goes into four engines: JSON lines through ``ingest_lines``
    (the C++ encoder), messages through one ``ingest_batch`` call and
    through per-message ``ingest`` on ``device``, and per-message on the
    CPU; after ``step`` every doc's raw state columns and error latch are
    identical across the four, the native library is loaded and every doc
    of the first engine is in native mode.  Then tree_churn's stream
    (``churn``: that path's engine, fed through ``ingest``, and its
    traffic as JSON-lines chunks) goes through a tree engine's ``ingest_lines`` with
    ``native_wire=True``, round by round: every doc identical to the churn
    engine's (raw columns, tree JSON, values, summary), with native tree
    batches and no native decode error."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.native import ingest_native

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    joins, ops = wire_traffic(n_docs, rounds, writers, seed + 21)
    blobs = _doc_blobs(n_docs, joins + ops)
    gen_s = time.perf_counter() - t0
    geom = dict(geom, recovery="off")
    out = {"phase": "wire_ingest", "card": card, "docs": n_docs, "rounds": rounds,
           "writers": writers, "ops": len(ops), "wire_bytes": sum(map(len, blobs)),
           "traffic_gen_s": gen_s}

    engines = {}
    nat = engines["native"] = DocBatchEngine(n_docs, device=device, **geom)
    check(ingest_native.loaded(), "wire_ingest: the native ingest library is not loaded")
    t = time.perf_counter()
    for d in range(n_docs):
        nat.ingest_lines(d, blobs[d])
    out["native_ingest_s"] = time.perf_counter() - t
    modes = sorted({h.mode for h in nat.hosts})
    check(modes == ["native"], f"wire_ingest: ingest_lines left docs in modes {modes}")
    for name, dev in (("batch", device), ("message", device), ("cpu", "cpu")):
        eng = engines[name] = DocBatchEngine(n_docs, device=dev, **geom)
        for d, m in joins:
            eng.ingest(d, m)
        t = time.perf_counter()
        if name == "batch":
            eng.ingest_batch([d for d, _ in ops], [m for _, m in ops])
        else:
            for d, m in ops:
                eng.ingest(d, m)
        out[f"{name}_ingest_s"] = time.perf_counter() - t
    for name in ("native", "batch", "message"):
        out[f"{name}_ingest_ops_per_s"] = len(ops) / out[f"{name}_ingest_s"]
    for name, eng in engines.items():
        t = time.perf_counter()
        eng.step()
        sync()
        out[f"{name}_step_s"] = time.perf_counter() - t
    cpu = engines["cpu"]
    for name, eng in engines.items():
        check(np.array_equal(eng.errors(), cpu.errors()),
              f"wire_ingest: the {name} engine's error latches differ from the CPU run")
        same = sum(_state_rows_equal(eng.doc_state(d), cpu.doc_state(d)) for d in range(n_docs))
        check(same == n_docs, f"wire_ingest: {n_docs - same} docs of the {name} engine "
                              "differ from the CPU run")
    check(not cpu.errors().any(), "wire_ingest: error bits latched")
    out["identical_docs"] = n_docs
    del engines, nat, cpu

    churn_eng, round_blobs = churn
    tn = churn_eng.n_docs
    tnat = TreeBatchEngine(tn, device=device, native_wire=True, **TREE_CHURN_GEOM)
    ingest_s = step_s = 0.0
    for blobs_r in round_blobs:
        t = time.perf_counter()
        for d, blob in enumerate(blobs_r):
            if blob:
                tnat.ingest_lines(d, blob)
        ingest_s += time.perf_counter() - t
        t = time.perf_counter()
        tnat.step()
        sync()
        step_s += time.perf_counter() - t
    h = tnat.health()
    check(h.get("tree_native_batches", 0) > 0, "wire_ingest: no native tree batch")
    check(h.get("tree_native_decode_errors", 0) == 0,
          f"wire_ingest: {h.get('tree_native_decode_errors')} native tree decode errors")
    check(not tnat.errors().any() and sorted(tnat.fallbacks) == sorted(churn_eng.fallbacks),
          "wire_ingest: tree error bits or fallbacks differ from tree_churn's")
    same = sum(_tree_docs_identical(tnat, d, churn_eng, d) for d in range(tn))
    check(same == tn, f"wire_ingest: {tn - same} of {tn} tree docs differ between "
                      "ingest_lines and ingest")
    edits = sum(blob.count(b"\n") for blobs_r in round_blobs for blob in blobs_r)
    out["tree"] = {"docs": tn, "edits": edits, "native_batches": h["tree_native_batches"],
                   "ingest_lines_s": ingest_s, "step_s": step_s,
                   "ingest_lines_edits_per_s": edits / ingest_s, "identical_docs": same}
    emit(out)
    return out


def time_tree_programs(card: str, ring, cmp_docs: int = 64,
                       shares=(1 / 16, 1 / 4, 1 / 2, 1)) -> dict:
    """K7 on the tree fleet's staged ring and K8 on its state, timed alone
    and held against the same call on the CPU for the first ``cmp_docs``
    docs (exact), beside their bytes bounds.

    Then K7's routes on that ring: for each share f, the ops of all docs
    but the first f x D become NOOP rows, and the ring runs with every
    kind on the masked route (``SUBSET_FRACTION`` past D) and on the
    gathered route (``SUBSET_FRACTION`` 0), in turns masked, gathered,
    gathered, masked."""
    import torch

    from fluidframework_tpu_torch.ops import tree_kernel as tk

    s, ops, pays, host_ops = ring
    D = s.parent.shape[0]
    n = min(cmp_docs, D)

    def k7(o=ops, h=host_ops):
        return tk.apply_nested_megastep(s, o, pays, host_ops=h)

    def max_err(got, want):
        return max(int((g[:n].cpu().long() - w.long()).abs().max()) for g, w in zip(got, want))

    cpu_s = tk.tree_map(lambda x: x[:n].cpu(), s)
    want = tk.apply_nested_megastep(cpu_s, ops[:, :n].cpu(), pays[:, :n].cpu(),
                                    host_ops=host_ops[:, :n])
    err7 = max_err(k7(), want)
    check(err7 == 0, f"K7 on the card differs from the CPU by {err7}")
    nbytes, bound = state_bound(list(s), (ops, pays))
    out = {"phase": "tree_programs", "card": card}
    out["k7"] = {"shape": list(ops.shape[:3]), **time_program(k7, 3),
                 "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                 "max_abs_err": err7, "compared_docs": n}
    err8 = max_err(tk.compact_nested(s), tk.compact_nested(cpu_s))
    check(err8 == 0, f"K8 on the card differs from the CPU by {err8}")
    nbytes, bound = state_bound(list(s))
    out["k8"] = {"docs": D, **time_program(lambda: tk.compact_nested(s), 5),
                 "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                 "max_abs_err": err8, "compared_docs": n}

    split = tk.SUBSET_FRACTION
    routes = {}
    try:
        for f in shares:
            keep = max(1, round(f * D))
            o, h = ops.clone(), host_ops.copy()
            o[:, keep:] = 0
            h[:, keep:] = 0
            turns = {"masked": [], "gathered": []}
            for route in ("masked", "gathered", "gathered", "masked"):
                tk.SUBSET_FRACTION = 2 * D if route == "masked" else 0
                turns[route].append(time_program(lambda: k7(o, h), 3, 1))
            routes[f"{keep}/{D}"] = turns
    finally:
        tk.SUBSET_FRACTION = split
    out["k7_routes"] = routes
    emit(out)
    return out


# ------------------------------------------------------- K9 and tree_rebase

def rebase_microbench_windows(seed: int, n_windows: int, window: int = 8) -> tuple:
    """``bench.py``'s ``_rebase_kernel_microbench`` windows: each folds one
    multi-insert commit ([Skip, Insert, ...]: 4 one-leaf inserts at
    distinct positions of 32, in one field) through ``window`` such commits.
    Returns (pool, [(c, xs)])."""
    from fluidframework_tpu_torch.dds.tree import mark_pool as mp
    from fluidframework_tpu_torch.dds.tree.changeset import Commit, Insert, NodeChange, Skip, _wrap
    from fluidframework_tpu_torch.dds.tree.schema import leaf

    rng = np.random.default_rng(seed)
    pool = mp.MarkPool()

    def multi_insert():
        marks, cur = [], 0
        for p in sorted(int(p) for p in rng.choice(32, size=4, replace=False)):
            if p > cur:
                marks.append(Skip(p - cur))
                cur = p
            marks.append(Insert([leaf(int(rng.integers(1000)))]))
        return mp.pool_commit(pool, Commit([_wrap([("", 0)], NodeChange(fields={"kids": marks}))]))

    return pool, [(multi_insert(), [multi_insert() for _ in range(window)])
                  for _ in range(n_windows)]


def tree_deep_window(seed: int, window: int = 256) -> tuple:
    """One window of tree_deep's shape: the 257th edit of its stream folded
    through the 256 edits before it (32 writers' inserts into the shared
    subtree, sets and inserts in their own).  Returns (pool, [(c, xs)])."""
    from fluidframework_tpu_torch.dds.tree import mark_pool as mp

    pool = mp.MarkPool()
    traffic = tree_deep_traffic(seed, rounds=2)
    commits = [mp.pool_commit_from_json(pool, m.contents["changes"])
               for msgs in traffic[1:] for _d, m in msgs]
    return pool, [(commits[window], commits[:window])]


def _fold_json(c, xs) -> str:
    from fluidframework_tpu_torch.dds.tree.changeset import commit_to_json

    return json.dumps([commit_to_json(c)] + [commit_to_json(x) for x in xs])


def time_serving_folds(reb, windows, encs, host, host_ms: float) -> dict:
    """The serving form of K9, one window per ``DeviceRebaser.fold`` (pack,
    one copy up, one launch, one copy down, decode), over ``windows``,
    held against the pooled fold's results ``host`` (``host_ms`` in all).
    The fold's cost is split by timing its parts alone on the same
    windows: ``_dispatch`` (pack and the device round trip), and the
    launch alone on one window's rows already on the card, synchronized
    after each call."""
    import torch

    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    W, C = len(windows), len(windows[0][1])
    cap = 1 << (C - 1).bit_length()
    gc.collect()
    t = time.perf_counter()
    folds = [reb.fold(c, xs) for c, xs in windows]
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t
    same = sum(_fold_json(fc, fx) == _fold_json(hc, hx)
               for (fc, fx, _st), (hc, hx) in zip(folds, host))
    check(same == W, f"K9 serving folds: {W - same} of {W} differ from the pooled fold")
    check(reb.stats()["rebase_fallbacks"] == 0, "K9 serving folds fell back")
    t = time.perf_counter()
    for enc_c, xe in encs:
        reb._dispatch(enc_c, xe, cap)
    dispatch_s = time.perf_counter() - t
    enc_c, xe = encs[0]
    dev = reb.device
    c1 = torch.from_numpy(enc_c.row[None]).to(dev)
    x1 = torch.from_numpy(np.stack([x.row for x in xe])[None]).to(dev)
    e1 = torch.ones((1, C), dtype=torch.uint8, device=dev)
    for _ in range(3):
        rk9.rebase_window(c1, x1, e1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(W):
        rk9.rebase_window(c1, x1, e1)
        torch.cuda.synchronize()
    launch_s = time.perf_counter() - t
    return {"windows": W, "C": C, "fold_us_per_window": fold_s / W * 1e6,
            "dispatch_us_per_window": dispatch_s / W * 1e6,
            "launch_sync_us_per_window": launch_s / W * 1e6,
            "one_window_device_ms": _device_sum(
                device_ms_by_name(lambda: rk9.rebase_window(c1, x1, e1), 20), "rebase_window"),
            "pooled_fold_us_per_window": host_ms / W * 1e3, "identical": same}


def phase_rebase_kernel(seed: int, card: str) -> dict:
    """K9 (``rebase_window``) against its plain version on the same card
    tensors (and on the CPU), exact on every output of every step, at four
    shapes: ``bench.py``'s microbench windows at W=256 and W=4,096 (C=8),
    one tree_deep window (W=1, C=256) and the serving shape tree_rebase
    launches (W=1, C=16: a fold of 9-16 entries pads to 16).  For each:
    call and device time, device us per step of the window's chain (the W
    windows run side by side), the plain version's time, the host pooled
    fold (``mark_pool.rebase_pair``) over the same windows, and the bytes
    bound (packed inputs read once, outputs written once; the window itself
    is a serial chain of C steps).  Then the serving form, one window per
    fold (``DeviceRebaser.fold``: one copy up, one launch, one copy down,
    the decode), against the pooled fold on the W=256 windows, identical."""
    import torch

    from fluidframework_tpu_torch.dds.tree import mark_pool as mp
    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    dev = torch.device("cuda")
    out = {"phase": "rebase_kernel", "card": card}
    shapes = (("microbench_256", lambda: rebase_microbench_windows(seed, 256), 50, 5),
              ("microbench_4096", lambda: rebase_microbench_windows(seed + 1, 4096), 20, 3),
              ("tree_deep_window", lambda: tree_deep_window(seed), 20, 1),
              ("serving_16", lambda: rebase_microbench_windows(seed + 2, 1, window=16), 50, 3))
    serving = None
    for name, make, iters, plain_iters in shapes:
        pool, windows = make()
        reb = DeviceRebaser(pool, device=dev)
        encs = [(reb.encode_commit(c), [reb.encode_commit(x) for x in xs]) for c, xs in windows]
        check(all(e is not None and all(x is not None for x in xe) for e, xe in encs),
              f"K9 {name}: a window commit is not device-encodable")
        W, C = len(windows), len(windows[0][1])
        c_rows = torch.from_numpy(np.stack([e.row for e, _ in encs]))
        xs_rows = torch.from_numpy(np.stack([np.stack([x.row for x in xe]) for _, xe in encs]))
        elig = torch.ones((W, C), dtype=torch.uint8)
        cd, xd, ed = c_rows.to(dev), xs_rows.to(dev), elig.to(dev)
        got = rk9.rebase_window(cd, xd, ed)
        want = rk9.rebase_window_plain(cd, xd, ed)
        want_cpu = rk9.rebase_window_plain(c_rows, xs_rows, elig)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(g.cpu(), w.cpu()) and torch.equal(g.cpu(), wc)
                  for g, w, wc in zip(got, want, want_cpu)),
              f"K9 disagrees with its plain version at {name} (W={W}, C={C})")
        gc.collect()  # a collection inside the timed fold would be the previous shape's
        t = time.perf_counter()
        host = []
        for c, xs in windows:
            new_xs = []
            for x in xs:
                c, xw = mp.rebase_pair(c, x)
                new_xs.append(xw)
            host.append((c, new_xs))
        host_ms = (time.perf_counter() - t) * 1e3

        def kernel():
            return rk9.rebase_window(cd, xd, ed)

        by_name = device_ms_by_name(kernel, iters)
        nbytes = nbytes_of([cd, xd, ed, *got])
        device_ms = _device_sum(by_name, "rebase_window")
        out[name] = {
            "W": W, "C": C, "valid_steps": int(got[1][..., 0].sum()), "max_abs_err": err,
            "ms": cuda_ms(kernel, iters, warmup=2),
            "device_ms": device_ms,
            "us_per_step": device_ms * 1e3 / C if device_ms is not None else None,
            "call_device_ms": _device_sum(by_name),
            "plain_ms": cuda_ms(lambda: rk9.rebase_window_plain(cd, xd, ed), plain_iters, warmup=1),
            "host_fold_ms": host_ms,
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_bytes": nbytes, "bound_by": "bytes",
            "library_ms": None,
        }
        if name == "microbench_256":
            serving = time_serving_folds(reb, windows, encs, host, host_ms)
        del pool, windows, reb, encs, host, got, want, want_cpu
    out["serving"] = serving
    out["note"] = ("a window is a serial chain of C dependent steps; the bytes bound "
                   "ignores that chain")
    emit(out)
    return out


def phase_tree_rebase(seed: int, card: str, device: str, deep, fleet_docs: int = 256,
                      rounds: int = 4, deep_geom: dict = TREE_DEEP_GEOM,
                      deep_shape: dict | None = None, trace_dir: str | None = None) -> dict:
    """BASELINE config 5 through ``TreeBatchEngine`` with the device rebase
    window (K9) on and off, on the same streams: tree_deep's (one doc, a
    10,000-leaf seed commit, 32 writers x 8 edits x 4 rounds; ``deep`` is
    the tree_deep path's engine, the pooled fold) and the tree fleet's cut
    to ``fleet_docs`` docs (its writers and edits kept), in turns on, off,
    off, on.  Every doc's ``em.summarize()`` and ``tree_json`` must be
    byte-identical between the settings; ingest s, edits/s and the
    rebaser's gauges per run.  The fleet's last turn (on) runs with a
    flight recorder (the rebase window's spans), against the first (on)
    without.  ``deep_geom`` and ``deep_shape`` (the
    ``tree_deep_traffic`` arguments) must be those of ``deep``'s run."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.observability import uninstall

    on_card = device == "cuda"
    deep_shape = deep_shape or {}

    def views(eng, d):
        return (json.dumps(eng.hosts[d].em.summarize(), sort_keys=True),
                json.dumps(eng.tree_json(d), sort_keys=True))

    def run(n_docs, geom, traffic, device_rebase, record=False):
        eng = TreeBatchEngine(n_docs, device=device, device_rebase=device_rebase, **geom)
        rec = install_recorder(1 << 19) if record else None
        try:
            r = _drive_tree(eng, traffic, on_card=on_card)
        finally:
            if rec is not None:
                uninstall()
        h = eng.health()
        line = {"device_rebase": device_rebase, "recorder": record,
                "edits": r["edits"], "ingest_s": r["ingest_s"],
                "step_s": r["step_s"], "edits_per_s": r["edits"] / (r["ingest_s"] + r["step_s"]),
                "host_translation_edits_per_s": r["edits"] / r["ingest_s"]}
        for k in ("device_rebase_fraction", "rebase_fallbacks", "rebase_windows",
                  "device_rebase_steps", "rebase_encode_rejects"):
            line[k] = h.get(k)
        if rec is not None:
            line["trace"] = recorder_line(
                rec, trace_dir, f"tree_rebase_{'on' if device_rebase else 'off'}")
        check(not eng.errors().any(), "tree_rebase: error bits left after step()")
        return eng, line

    out = {"phase": "tree_rebase", "card": card}
    deep_eng, deep_on = run(1, deep_geom, tree_deep_traffic(seed, **deep_shape), True)
    check(views(deep_eng, 0) == views(deep, 0),
          "tree_rebase: tree_deep's summary or tree JSON differs between device_rebase on and off")
    check(deep_on["device_rebase_fraction"] > 0, "tree_rebase: tree_deep resolved no step on K9")
    out["tree_deep"] = {"on": deep_on, "identical_docs": 1}
    del deep_eng

    traffic = tree_traffic(seed + 13, fleet_docs, rounds)
    turns, first = [], {}
    for i, setting in enumerate((True, False, False, True)):
        eng, line = run(fleet_docs, TREE_FLEET_GEOM, traffic, setting, record=i == 3)
        turns.append(line)
        first.setdefault(setting, eng)
        del eng
    same = sum(views(first[True], d) == views(first[False], d) for d in range(fleet_docs))
    check(same == fleet_docs,
          f"tree_rebase: {fleet_docs - same} of {fleet_docs} fleet docs differ between settings")
    check(all(t["device_rebase_fraction"] > 0 for t in turns if t["device_rebase"]),
          "tree_rebase: the fleet resolved no step on K9")
    out["tree_fleet"] = {"docs": fleet_docs, "rounds": rounds, "turns": turns,
                         "identical_docs": same}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


# ------------------------------------------------------------ map and matrix

def map_ops(rng, shape, K: int) -> tuple:
    """SET/DELETE ops over ``shape`` (maps x ops) with keys in [0, K)."""
    kinds = rng.integers(1, 3, size=shape).astype(np.int32)
    keys = rng.integers(0, K, size=shape).astype(np.int32)
    vals = rng.integers(0, 1 << 20, size=shape).astype(np.int32)
    return kinds, keys, vals


def phase_map_lww(seed: int, card: str, device: str, K: int = 256, B: int = 256,
                  batches: int = 64, n_maps: int = 10_000, fleet_batches: int = 16) -> dict:
    """BASELINE config 2: one SharedMap of K=256 key slots fed ``batches``
    batches of B=256 SET/DELETE ops, plus a CLEAR sequenced halfway,
    through ``apply_batch``; then a fleet of ``n_maps`` maps through
    ``apply_batch_fleet``, ``fleet_batches`` batches of B ops a map.  Both
    end states, and ``host_items`` of sampled maps,
    must equal a CPU run's exactly.  Ops/s (host upload included), and the
    fleet program's call and device time beside its bytes bound."""
    import torch

    from fluidframework_tpu_torch.ops import map_kernel as mpk

    on_card = device == "cuda"
    rng = np.random.default_rng(seed + 21)
    seq = 0
    one = []
    for i in range(batches):
        if i == batches // 2:  # the CLEAR, sequenced between two batches
            seq += 1
            one.append(tuple(np.asarray([v], np.int32) for v in (mpk.MapOpKind.CLEAR, -1, 0, seq)))
        kinds, keys, vals = map_ops(rng, (B,), K)
        one.append((kinds, keys, vals, np.arange(seq + 1, seq + B + 1, dtype=np.int32)))
        seq += B
    state = mpk.init_state(K, device=device)
    t = time.perf_counter()
    for batch in one:
        state = mpk.apply_batch(state, *batch)
    if on_card:
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    cpu = mpk.init_state(K, device="cpu")
    for batch in one:
        cpu = mpk.apply_batch(cpu, *batch)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(state, cpu)),
          "map_lww: the single map differs from its CPU run")
    check(mpk.host_items(state) == mpk.host_items(cpu), "map_lww: host_items differ")

    fleet = mpk.batch_state(mpk.init_state(K, device=device), n_maps)
    fleet_cpu = mpk.batch_state(mpk.init_state(K, device="cpu"), n_maps)
    fleet_s = 0.0
    last = None
    for i in range(fleet_batches):
        kinds, keys, vals = map_ops(rng, (n_maps, B), K)
        seqs = (seq + 1 + np.arange(n_maps * B, dtype=np.int64).reshape(n_maps, B)).astype(np.int32)
        seq += n_maps * B
        batch = tuple(torch.from_numpy(a) for a in (kinds, keys, vals, seqs))
        t = time.perf_counter()
        fleet = mpk.apply_batch_fleet(fleet, *batch)
        if on_card:
            torch.cuda.synchronize()
        fleet_s += time.perf_counter() - t
        fleet_cpu = mpk.apply_batch_fleet(fleet_cpu, *batch)
        last = batch
    check(all(torch.equal(a.cpu(), b) for a, b in zip(fleet, fleet_cpu)),
          "map_lww: the map fleet differs from its CPU run")
    sample = np.random.default_rng(seed + 3).choice(n_maps, size=min(64, n_maps), replace=False)
    for d in sample.tolist():
        check(mpk.host_items(mpk.MapState(*(x[d] for x in fleet)))
              == mpk.host_items(mpk.MapState(*(x[d] for x in fleet_cpu))),
              f"map_lww: host_items of map {d} differ")
    out = {"phase": "map_lww", "card": card, "K": K, "B": B, "batches": batches,
           "ops_per_s": (batches * B + 1) / one_s, "live_keys": len(mpk.host_items(state)),
           "fleet_maps": n_maps, "fleet_batches": fleet_batches,
           "fleet_ops_per_s": fleet_batches * n_maps * B / fleet_s,
           "fleet_state_bytes": nbytes_of(fleet)}
    if on_card:
        dev_batch = tuple(x.to(device) for x in last)
        nbytes, bound = state_bound(list(fleet), dev_batch)
        out["fleet_program"] = {"shape": [n_maps, K, B],
                                **time_program(lambda: mpk.apply_batch_fleet(fleet, *dev_batch), 10,
                                               uncounted=mpk.apply_batch_fleet),
                                "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                                "max_abs_err": 0}
    emit(out)
    return out


MATRIX_GEOM = dict(max_rows=256, max_cols=256, max_segments=128)


def matrix_traffic(seed: int, steps: int = 16, B: int = 64, writers: int = 64,
                   seeded: int = 128) -> list:
    """BASELINE config 4's traffic: writer 0 seeds ``seeded`` rows and
    columns, then ``steps`` steps of ``B`` SET_CELL ops from ``writers``
    writers at the step's ref_seq (about one in ten with the FWW flag),
    with two of writer 0's row or column inserts and removes interleaved
    in each step.  Returns the seed ops and one [B + 2, 8] array a step."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk

    K = mxk.MatrixOpKind
    rng = np.random.default_rng(seed + 31)
    seed_ops = np.asarray([[K.INSERT_ROWS, 1, 0, 0, 0, seeded, 0, 0],
                           [K.INSERT_COLS, 2, 0, 1, 0, seeded, 0, 0]], np.int32)
    rows = cols = seeded
    seq = 2
    out = []
    for s in range(steps):
        ref, n_rows, n_cols = seq, rows, cols
        ops = np.zeros((B + 2, mxk.MATRIX_OP_FIELDS), np.int32)
        for b in range(B + 2):
            seq += 1
            if b in (0, B // 2):
                axis_rows = (s + b) % 2 == 0
                n = rows if axis_rows else cols
                insert = (s // 2 + b) % 2 == 0
                kind = (K.INSERT_ROWS if axis_rows else K.INSERT_COLS) if insert else \
                    (K.REMOVE_ROWS if axis_rows else K.REMOVE_COLS)
                pos = int(rng.integers(0, n + 1 if insert else n))
                ops[b] = [kind, seq, 0, seq - 1, pos, 1, 0, 0]
                delta = 1 if insert else -1
                if axis_rows:
                    rows += delta
                else:
                    cols += delta
            else:
                ops[b] = [K.SET_CELL, seq, b % writers, ref, int(rng.integers(0, n_rows)),
                          int(rng.integers(0, n_cols)), int(rng.integers(0, 1 << 20)),
                          int(rng.random() < 0.1)]
        out.append(ops)
    return [seed_ops] + out


def mk_leaves(state) -> list:
    """Every tensor of a matrix state, both permutation merge-trees' too."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    return mk.leaves(state.rows) + mk.leaves(state.cols) + list(state[2:])


def phase_matrix(seed: int, card: str, device: str, steps: int = 16, B: int = 64) -> dict:
    """BASELINE config 4: one SharedMatrix of 256 x 256 cells (128
    permutation segments) seeded with 128 rows and columns, then ``steps``
    steps of ``B`` SET_CELL ops from 64 writers through ``apply_ops``,
    writer 0's row and column inserts and removes interleaved (two a
    step), FWW on some cells.  The end
    state (both permutation merge-trees' raw columns included) and
    ``to_grid`` must equal a CPU run's exactly, with no error bit.  Ops/s,
    and one step's program call and device time beside its bytes bound."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_kernel as mxk

    on_card = device == "cuda"
    traffic = matrix_traffic(seed, steps, B)
    state = mxk.apply_ops(mxk.init_state(**MATRIX_GEOM, device=device), traffic[0])
    if on_card:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for ops in traffic[1:]:
        state = mxk.apply_ops(state, ops)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    cpu = mxk.init_state(**MATRIX_GEOM, device="cpu")
    for ops in traffic:
        cpu = mxk.apply_ops(cpu, ops)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(mk_leaves(state), mk_leaves(cpu))),
          "matrix: the end state differs from its CPU run")
    grid = mxk.to_grid(state)
    check(grid == mxk.to_grid(cpu), "matrix: to_grid differs from the CPU run")
    check(int(state.error) == 0 and int(state.rows.error) == 0 and int(state.cols.error) == 0,
          "matrix: error bits set")
    check(int(state.fww) == 1, "matrix: no FWW write was seen")
    out = {"phase": "matrix", "card": card, "shape": [MATRIX_GEOM["max_rows"], MATRIX_GEOM["max_cols"]],
           "steps": steps, "B": B, "ops": steps * (B + 2), "ops_per_s": steps * (B + 2) / wall,
           "grid_rows": len(grid), "grid_cols": len(grid[0]) if grid else 0,
           "cells_set": sum(v is not None for row in grid for v in row)}
    if on_card:
        ops_dev = torch.as_tensor(traffic[-1], device=device)
        kinds = traffic[-1][:, 0]
        nbytes, bound = state_bound(mk_leaves(state), (ops_dev,))
        out["step_program"] = {"shape": [B + 2, mxk.MATRIX_OP_FIELDS],
                               **time_program(lambda: mxk.apply_ops(state, ops_dev, kinds), 3, 1,
                                              uncounted=mxk.apply_ops_fleet),
                               "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                               "max_abs_err": 0}
    emit(out)
    return out


# ------------------------------------------------------------------ serving

class _FeederServer:
    """The firehose stand-in's server (see ``FirehoseFeeder``): one thread
    accepts subscriptions and answers the consume handshake
    (``{"t":"consume","doc":...}``, then ``{"t":"consuming"}``), a second
    sends each subscriber its doc's JSON lines, wave by wave."""

    def __init__(self, waves: list[dict[str, bytes]]):
        import queue
        import socket
        import threading

        self.waves = waves
        self.released = 0
        self.subscriptions = 0
        self._closed = False
        self._subs: list = []
        self._lock = threading.Lock()
        self._jobs = queue.Queue()
        self._sock = socket.create_server(("127.0.0.1", 0), backlog=1024)
        self.port = self._sock.getsockname()[1]
        self._threads = [threading.Thread(target=self._accept, daemon=True),
                         threading.Thread(target=self._send, daemon=True)]
        for t in self._threads:
            t.start()

    def _accept(self) -> None:
        import socket

        self._sock.settimeout(0.2)  # wakes to see close()
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            if not buf.endswith(b"\n"):
                conn.close()
                continue
            doc = json.loads(buf)["doc"]
            with self._lock:
                # The ack goes out before any of the doc's data is queued.
                self._subs.append((conn, doc))
                self.subscriptions += 1
                conn.sendall(b'{"t":"consuming"}\n')
                for w in range(self.released):
                    self._jobs.put((conn, self.waves[w].get(doc, b"")))

    def _send(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            conn, data = job
            if data:
                try:
                    conn.sendall(data)
                except OSError:
                    pass  # the subscriber went away
            self._jobs.task_done()

    def release(self, wave: int) -> int:
        with self._lock:
            self.released += 1
            for conn, doc in self._subs:
                self._jobs.put((conn, self.waves[wave].get(doc, b"")))
        return sum(map(len, self.waves[wave].values()))

    def drop_subscribers(self) -> None:
        with self._lock:
            subs, self._subs = self._subs, []
        for conn, _doc in subs:
            conn.close()

    def close(self) -> None:
        self._closed = True
        self._threads[0].join(timeout=10)
        self._sock.close()
        self._jobs.put(None)
        self.drop_subscribers()
        self._threads[1].join(timeout=10)


def _feeder_main(conn, waves, fd_need: int) -> None:
    """The feeder process: serve ``waves`` and answer the parent's
    commands until ``close``."""
    _raise_fd_limit(fd_need)
    server = _FeederServer(waves)
    conn.send(server.port)
    while True:
        cmd, arg = conn.recv()
        if cmd == "release":
            conn.send(server.release(arg))
        elif cmd == "flush":
            server._jobs.join()
            conn.send(None)
        elif cmd == "subscriptions":
            conn.send(server.subscriptions)
        elif cmd == "drop":
            server.drop_subscribers()
            conn.send(None)
        else:
            server.close()
            conn.send(None)
            return


class FirehoseFeeder:
    """A firehose stand-in over local TCP, in a process of its own (each
    subscription holds a socket at both ends; two processes halve each
    one's file descriptors).  ``waves[w][doc_id]`` is a doc's JSON-lines
    bytes of wave ``w``: ``release(w)`` sends wave ``w`` to every
    subscriber, and a later subscriber gets every released wave at once."""

    def __init__(self, waves: list[dict[str, bytes]]):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.released = 0
        fd_need = len({d for w in waves for d in w}) + 512
        self._proc = ctx.Process(target=_feeder_main, args=(child, waves, fd_need), daemon=True)
        self._proc.start()
        self.port = self._conn.recv()

    def _call(self, cmd: str, arg=None):
        self._conn.send((cmd, arg))
        return self._conn.recv()

    @property
    def subscriptions(self) -> int:
        return self._call("subscriptions")

    def release(self, wave: int) -> int:
        """Send wave ``wave`` to every subscriber; returns its bytes."""
        check(wave == self.released, f"feeder: wave {wave} released out of order")
        self.released += 1
        return self._call("release", wave)

    def flush(self) -> None:
        """Wait until every queued send reached the kernel."""
        self._call("flush")

    def drop_subscribers(self) -> None:
        self._call("drop")

    def close(self) -> None:
        if self._proc.is_alive():
            self._call("close")
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()


def _raise_fd_limit(need: int) -> int:
    """Raise RLIMIT_NOFILE's soft limit to ``need`` as far as the hard
    limit allows; returns the soft limit in force."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = need if hard == resource.RLIM_INFINITY else min(need, hard)
    if want > soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def _doc_waves(doc_ids, rounds_msgs, groups) -> list[dict[str, bytes]]:
    """Per wave (a list of indices into ``rounds_msgs``), each doc's
    messages of those rounds as one JSON-lines chunk, in stream order."""
    out = []
    for group in groups:
        parts: dict[str, list[bytes]] = {}
        for r in group:
            for d, m in rounds_msgs[r]:
                parts.setdefault(doc_ids[d], []).append(m.wire_line())
        out.append({k: b"".join(v) for k, v in parts.items()})
    return out


def _rounds_for(traffic, n_docs: int, rounds: int) -> tuple:
    """``fleet_traffic``'s joins and first ``rounds`` rounds for docs below
    ``n_docs``."""
    joins = [(d, m) for d, m in traffic[0] if d < n_docs]
    return joins, [[(d, m) for d, m in r if d < n_docs] for r in traffic[1][:rounds]]


def _serve_fleet(seed, device, traffic, n_docs, rounds, sample, geom, reduced) -> dict:
    """Part (a): the string fleet over the wire."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.runtime.summary import make_scribe_ack
    from fluidframework_tpu_torch.server.fleet_consumer import FleetConsumer

    on_card = device == "cuda"
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"d{d}" for d in range(n_docs)]
    # Wave 0: the joins and round 0 (it warms the consumer and the step);
    # wave 1: every later round (the timed drain); wave 2: the scribe's
    # summaryAck for doc 0, the compaction trigger.
    waves = _doc_waves(doc_ids, [joins + rounds_msgs[0]] + rounds_msgs[1:],
                       [[0], list(range(1, rounds))])
    last0 = max(m.seq for r in rounds_msgs for d, m in r if d == 0)
    waves.append({doc_ids[0]: make_scribe_ack(doc_ids[0], last0, "0" * 64).wire_line()})
    rows = [len(rounds_msgs[0]), sum(len(r) for r in rounds_msgs[1:])]
    wire_bytes = sum(sum(map(len, w.values())) for w in waves)
    out = {"docs": n_docs, "rounds": rounds, "ops": sum(rows), "wire_bytes": wire_bytes,
           **reduced}
    feeder = FirehoseFeeder(waves)
    feeder.release(0)
    eng = DocBatchEngine(n_docs, device=device, **geom)
    t = time.perf_counter()
    fc = FleetConsumer("127.0.0.1", feeder.port, eng, doc_ids)
    try:
        out["subscribe_s"] = time.perf_counter() - t
        check(feeder.subscriptions == n_docs, f"serving: {feeder.subscriptions} subscriptions")
        t = time.perf_counter()
        fc.run_for(rows[0])
        if on_card:
            torch.cuda.synchronize()
        out["warm_wave_s"] = time.perf_counter() - t
        # The timed wave sits in the kernel's socket buffers before the
        # clock starts (bench.py _wire_ingest_rate's two waves).
        feeder.release(1)
        feeder.flush()
        time.sleep(0.25)
        t0 = time.perf_counter()
        idle = 0
        while fc.rows_staged < sum(rows):
            if fc.pump(0.005) == 0:
                idle += 1
                check(idle < 2000, f"serving: firehose idle at {fc.rows_staged}/{sum(rows)} rows")
            else:
                idle = 0
        t_drain = time.perf_counter() - t0
        fc.step()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # The ack arrives after the drain: the pump that reads it compacts.
        feeder.release(2)
        for _ in range(2000):
            if fc.bytes_consumed >= wire_bytes:
                break
            fc.pump(0.005)
        check(fc.bytes_consumed == wire_bytes,
              f"serving: consumed {fc.bytes_consumed} of {wire_bytes} bytes")
        h = fc.health()
        check(h["msn_compactions"] == 1, "serving: the summaryAck did not compact the fleet")
        check(not fc.dead_socks, f"serving: dead sockets {sorted(fc.dead_socks)[:8]}")
        check(eng.error_count() == 0, f"serving: {eng.error_count()} docs latched error bits")
        modes = sorted({x.mode for x in eng.hosts})
        check(modes == ["native"], f"serving: docs left the native path ({modes})")
        out.update({"drain_s": t_drain, "step_s": dt - t_drain,
                    "drain_ops_per_s": rows[1] / t_drain, "wire_ops_per_s": rows[1] / dt,
                    "timed_ops": rows[1], "rows_staged": fc.rows_staged,
                    "pump_pauses": h["pump_pauses"], "megasteps": h["megastep_dispatches"]})
    finally:
        fc.close()
        feeder.close()
    # The CPU replay of the same bytes, stepped and compacted at the same
    # points, holds the sampled docs.
    pick = sorted(int(d) for d in np.random.default_rng(seed + 1).choice(
        n_docs, size=min(sample, n_docs), replace=False))
    ref = DocBatchEngine(len(pick), device="cpu", **geom)
    for w, wave in enumerate(waves):
        for j, d in enumerate(pick):
            if wave.get(doc_ids[d]):
                ref.ingest_lines(j, wave[doc_ids[d]])
        if w < 2:
            ref.step()
        else:
            ref.compact()
    same = sum(_state_rows_equal(eng.doc_state(d), ref.doc_state(j)) for j, d in enumerate(pick))
    check(same == len(pick), f"serving: {len(pick) - same} of {len(pick)} sampled docs differ "
                             "from the CPU ingest_lines replay")
    out["sampled_docs_identical"] = same
    return out


def _serve_tree(device, churn) -> dict:
    """Part (b): tree_churn's stream over the wire, one step a round."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.server.fleet_consumer import FleetConsumer

    churn_eng, round_blobs = churn
    n = churn_eng.n_docs
    doc_ids = [f"t{d}" for d in range(n)]
    waves = [{doc_ids[d]: blob for d, blob in enumerate(blobs) if blob} for blobs in round_blobs]
    feeder = FirehoseFeeder(waves)
    eng = TreeBatchEngine(n, device=device, **TREE_CHURN_GEOM)
    fc = FleetConsumer("127.0.0.1", feeder.port, eng, doc_ids)
    want = 0
    t0 = time.perf_counter()
    try:
        for w in range(len(waves)):
            want += feeder.release(w)
            for _ in range(4000):
                if fc.bytes_consumed >= want:
                    break
                fc.pump(0.005)
            check(fc.bytes_consumed == want, f"serving tree: consumed {fc.bytes_consumed} of {want}")
            fc.step()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = fc.health()
    finally:
        fc.close()
        feeder.close()
    check(not eng.errors().any() and sorted(eng.fallbacks) == sorted(churn_eng.fallbacks),
          "serving tree: error bits or fallbacks differ from tree_churn's")
    same = sum(_tree_docs_identical(eng, d, churn_eng, d) for d in range(n))
    check(same == n, f"serving tree: {n - same} of {n} docs differ from the tree_churn engine's")
    edits = sum(blob.count(b"\n") for w in waves for blob in w.values())
    return {"docs": n, "edits": edits, "wall_s": wall, "edits_per_s": edits / wall,
            "rows_staged": h["rows_staged"], "native_batches": h.get("tree_native_batches", 0),
            "identical_docs": same}


def scribe_traffic(seed: int, n_strings: int, n_trees: int, n_maps: int, n_matrices: int,
                   matrix_steps: int) -> list:
    """The scribe's topic as (doc id, message) pairs in produce order:
    config-3 string docs (``fleet_traffic``, 8 rounds), config-5 tree docs
    (``tree_traffic``, 4 rounds), maps of map_lww's op mix (256 SET and
    DELETE ops over 256 keys, a CLEAR halfway) and matrices of the matrix
    phase's stream (``matrix_traffic``, ``matrix_steps`` steps), as wire
    messages."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    def op(seq, ref, contents, client="w0"):
        return SequencedMessage(client_id=client, client_seq=seq, ref_seq=ref, seq=seq,
                                min_seq=0, contents=contents)

    out = []
    joins, rounds = fleet_traffic(n_strings, 8, FLEET_GEOM["ops_per_step"], 8, seed + 51)
    out += [(f"s{d}", m) for d, m in joins + [x for r in rounds for x in r]]
    out += [(f"t{d}", m) for r in tree_traffic(seed + 52, n_trees, 4) for d, m in r]
    kinds, keys, vals = map_ops(np.random.default_rng(seed + 53), (n_maps, 256), 256)
    for d in range(n_maps):
        seq = 0
        for b in range(256):
            if b == 128:
                seq += 1
                out.append((f"m{d}", op(seq, seq - 1, {"type": "clear"})))
            seq += 1
            key = f"k{keys[d, b]}"
            out.append((f"m{d}", op(seq, seq - 1, {"type": "set", "key": key,
                                                   "value": int(vals[d, b])}
                                    if kinds[d, b] == 1 else {"type": "delete", "key": key})))
    K = mxk.MatrixOpKind
    names = {K.INSERT_ROWS: "insertRows", K.INSERT_COLS: "insertCols",
             K.REMOVE_ROWS: "removeRows", K.REMOVE_COLS: "removeCols"}
    for x in range(n_matrices):
        out += [(f"x{x}", SequencedMessage(
            client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w}))
            for w in range(64)]
        for ops in matrix_traffic(seed + 54 + x, matrix_steps):
            for kind, seq, client, ref, a, b, v, fww in ops.tolist():
                if kind == K.SET_CELL:
                    c = {"type": "set", "row": a, "col": b, "value": v}
                    if fww:
                        c["fwwMode"] = True
                else:
                    c = {"type": names[kind], "pos": a, "count": b}
                out.append((f"x{x}", op(seq, ref, c, client=f"w{client}")))
    return out


def _serve_scribe(seed, device, n_strings, n_trees, n_maps, n_matrices, matrix_steps,
                  sample) -> dict:
    """Part (c): the scribe on ``device`` against the same scribe on the
    CPU, then engines booted from its summaries."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.runtime.summary import parse_scribe_ack
    from fluidframework_tpu_torch.server.ordered_log import Topic
    from fluidframework_tpu_torch.server.scribe import (
        ScribeConfig,
        ScribeLambda,
        SummaryRecordStore,
    )

    t = time.perf_counter()
    msgs = scribe_traffic(seed, n_strings, n_trees, n_maps, n_matrices, matrix_steps)
    gen_s = time.perf_counter() - t
    cfg = ScribeConfig(max_ops=64, map_max_keys=256,
                       matrix_shape=(MATRIX_GEOM["max_rows"], MATRIX_GEOM["max_cols"]),
                       matrix_segments=MATRIX_GEOM["max_segments"])
    cut = (3 * len(msgs)) // 5
    runs = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_scribe_")
    try:
        for dev in dict.fromkeys((device, "cpu")):
            topic = Topic("deltas", 4)
            sc = ScribeLambda(topic, os.path.join(root, dev), config=cfg, device=dev)
            t = time.perf_counter()
            for part in (msgs[:cut], msgs[cut:]):
                for doc, m in part:
                    topic.produce(doc, m)
                sc.pump()
            sc.summarize_all()
            sc.pump()
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            sc.close()
            with open(os.path.join(root, dev, "objects", "objects.jsonl"), "rb") as f:
                objects = f.read()
            with open(os.path.join(root, dev, "refs.json"), "rb") as f:
                refs = f.read()
            acks = [parse_scribe_ack(r.payload) for p in range(topic.n_partitions)
                    for r in topic.partition(p).read(0)]
            runs[dev] = {"scribe": sc, "wall": wall, "objects": objects, "refs": refs,
                         "acks": [a for a in acks if a is not None]}
        main, cpu = runs[device], runs["cpu"]
        check(main["refs"] == cpu["refs"], "scribe: refs.json differs from the CPU scribe's")
        check(main["acks"] == cpu["acks"], "scribe: the commit SHAs differ from the CPU scribe's")
        check(main["objects"] == cpu["objects"], "scribe: git objects differ from the CPU scribe's")
        sc = main["scribe"]
        h = sc.health()
        n_docs = n_strings + n_trees + n_maps + n_matrices
        check(h["failed_docs"] == 0 and h["acked_docs"] == n_docs,
              f"scribe: {h['failed_docs']} failed, {h['acked_docs']} of {n_docs} acked")
        store = SummaryRecordStore.from_scribe(sc)
        fams: dict[str, int] = {}
        for d in store.docs():
            fams[store.family(d)] = fams.get(store.family(d), 0) + 1
        check(fams == {"doc_batch": n_strings, "tree_batch": n_trees, "map_batch": n_maps,
                       "matrix_batch": n_matrices}, f"scribe: families {fams}")
        # Engines booted from the acked summaries, then fed the whole
        # stream (the covered prefix skips by seq floor), equal engines fed
        # it all.
        rng = np.random.default_rng(seed + 4)
        t = time.perf_counter()
        s_idx = {f"s{d}": d for d in range(n_strings)}
        s_msgs = [(s_idx[doc], m) for doc, m in msgs if doc in s_idx]
        primary = DocBatchEngine(n_strings, device=device, **FLEET_GEOM)
        boot = DocBatchEngine(n_strings, device=device, doc_keys=list(s_idx), **FLEET_GEOM)
        check(boot.restore_from_checkpoints(store=store) == list(range(n_strings)),
              "scribe: the string docs did not all boot from their summaries")
        for eng in (primary, boot):
            for d, m in s_msgs:
                eng.ingest(d, m)
            eng.step()
            eng.compact()  # the scribe's replica compacts as it folds
        pick = sorted(rng.choice(n_strings, size=min(sample, n_strings), replace=False).tolist())
        same = sum(_docs_equivalent(primary, d, boot, d) for d in pick)
        check(same == len(pick), f"scribe: {len(pick) - same} booted string docs differ")
        skipped = boot.health()["checkpointed_ops_skipped"]
        check(skipped > 0, "scribe: the boot replay skipped nothing")
        t_idx = {f"t{d}": d for d in range(n_trees)}
        t_msgs = [(t_idx[doc], m) for doc, m in msgs if doc in t_idx]
        tprimary = TreeBatchEngine(n_trees, device=device, **TREE_FLEET_GEOM)
        tboot = TreeBatchEngine(n_trees, device=device, doc_keys=list(t_idx), **TREE_FLEET_GEOM)
        check(tboot.restore_from_checkpoints(store=store) == list(range(n_trees)),
              "scribe: the tree docs did not all boot from their summaries")
        tboot.step()
        for eng in (tprimary, tboot):
            for d, m in t_msgs:
                eng.ingest(d, m)
            eng.step()
        tpick = sorted(rng.choice(n_trees, size=min(sample, n_trees), replace=False).tolist())
        # The served views: a booted EditManager's trunk window holds the
        # rebased commits in another (equivalent) form than a live one's,
        # in the reference as well, so its summary is not compared.
        tsame = sum(json.dumps(tprimary.tree_json(d)) == json.dumps(tboot.tree_json(d))
                    and json.dumps(tprimary.values(d)) == json.dumps(tboot.values(d))
                    for d in tpick)
        check(tsame == len(tpick), f"scribe: {len(tpick) - tsame} booted tree docs differ")
        boot_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"docs": n_docs, "messages": len(msgs), "matrix_steps": matrix_steps,
            "traffic_gen_s": gen_s, "wall_s": main["wall"], "cpu_wall_s": cpu["wall"],
            "summaries": h["summaries_written"],
            "summaries_per_s": h["summaries_written"] / main["wall"],
            "acks": len(main["acks"]), "object_bytes": len(main["objects"]),
            "git_sharing_ratio": h["git_sharing_ratio"],
            "handles_reused": h["summary_handles_reused"],
            "booted_strings_equal": same, "booted_trees_equal": tsame,
            "boot_ops_skipped": skipped, "boot_s": boot_s}


def _serve_failover(seed, device, traffic, n_docs, rounds, sample, geom) -> dict:
    """Part (d): a primary with a background checkpoint writer, and a warm
    standby that prepares, trails and promotes on the lease's release."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.recovery import BackgroundCheckpointWriter
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.server.failover import LeaseFile, WarmStandby
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def feed(eng, r):
        eng.ingest_batch([d for d, _ in rounds_msgs[r]], [m for _, m in rounds_msgs[r]])

    # One round past the kill: the promoted engine's first step then has
    # work however far the writer and the trails got (a fully caught-up
    # standby replays nothing, and its recovery clock waits for work).
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds + 1)
    half = rounds // 2
    root = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    store_dir = os.path.join(root, "ckpt")
    lease_path = os.path.join(root, "lease.json")
    out = {"docs": n_docs, "rounds": rounds, "rounds_after_kill": 1}
    try:
        primary = DocBatchEngine(n_docs, device=device,
                                 checkpoint_store=CheckpointStore(store_dir), **geom)
        lease = LeaseFile(lease_path, "primary", ttl_s=60.0)
        check(lease.acquire(), "failover: the primary could not take the lease")
        writer = BackgroundCheckpointWriter(primary, max_seconds_behind=0.05,
                                            interval_s=0.02).start()
        try:
            for d, m in joins:
                primary.ingest(d, m)
            for r in range(half):
                feed(primary, r)
                primary.step()
            sync()
            time.sleep(0.2)
            eng = DocBatchEngine(n_docs, device=device,
                                 checkpoint_store=CheckpointStore(store_dir), **geom)
            ws = WarmStandby(eng, CheckpointStore(store_dir),
                             lease=LeaseFile(lease_path, "standby", ttl_s=60.0))
            rec = install_recorder(1 << 12)
            try:
                t = time.perf_counter()
                ws.prepare()
                sync()
                out["prepare_s"] = time.perf_counter() - t
                out["warmup_s"] = recorder_line(rec, None, "")["phase_s"].get("warmup")
            finally:
                uninstall()
            out["warmup_dispatches"] = eng.health()["warmup_dispatches"]
            out["adopted_at_prepare"] = sum(h.restored for h in eng.hosts)
            for r in range(half, rounds):
                feed(primary, r)
                primary.step()
                sync()
                ws.trail()
            check(not ws.should_promote(), "failover: the standby would promote under a live lease")
        finally:
            writer.stop()
        out["writer"] = writer.stats()
        check(out["writer"]["ckpt_writer_records"] > 0 and out["writer"]["ckpt_writer_errors"] == 0,
              f"failover: checkpoint writer {out['writer']}")
        # A cold successor from the same store, without warmup, for the
        # first-step comparison (built before the kill: the recovery clock
        # times the standby alone).
        cold = DocBatchEngine(n_docs, device=device,
                              checkpoint_store=CheckpointStore(store_dir), **geom)
        cold.restore_from_checkpoints()
        # The primary shuts down cleanly: its lease release promotes.
        lease.release()
        check(ws.should_promote(), "failover: the released lease does not promote the standby")
        t_kill = time.monotonic()
        ws.promote(incident_started_at=t_kill)
        out["trails"], out["adoptions"] = ws.trails, ws.adoptions
        check(ws.lease.epoch >= 0, "failover: the promoted standby does not hold the lease")
        steps = {}
        for name, e in (("warm", eng), ("cold", cold)):
            for d, m in joins:
                e.ingest(d, m)
            for r in range(rounds + 1):
                feed(e, r)  # the checkpointed prefix skips by seq floor
            t = time.perf_counter()
            e.step()
            sync()
            steps[name] = time.perf_counter() - t
        feed(primary, rounds)  # what the primary would hold had it lived
        primary.step()
        h = eng.health()
        pick = sorted(int(d) for d in np.random.default_rng(seed + 5).choice(
            n_docs, size=min(sample, n_docs), replace=False))
        same = sum(_docs_equivalent(primary, d, eng, d) for d in pick)
        check(same == len(pick), f"failover: {len(pick) - same} promoted docs differ from the primary")
        same_cold = sum(_docs_equivalent(primary, d, cold, d) for d in pick)
        check(same_cold == len(pick), f"failover: {len(pick) - same_cold} cold docs differ")
        check(eng.error_count() == 0, "failover: error bits after the promotion")
        check(h["recovery_incidents"] == 1 and h["standby_promotions"] == 1,
              f"failover: incidents {h['recovery_incidents']}, promotions {h['standby_promotions']}")
        out.update({"first_step_warm_s": steps["warm"], "first_step_cold_s": steps["cold"],
                    "recovery_p50_ms": h["recovery_p50_ms"],
                    "checkpointed_ops_skipped": h["checkpointed_ops_skipped"],
                    "identical_docs": same})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _serve_entry(device, traffic, n_docs, rounds, geom) -> dict:
    """Part (e): ``fleet_main`` as a subprocess, twice on one checkpoint
    directory, against an in-process engine fed the same bytes."""
    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"e{d}" for d in range(n_docs)]
    half = rounds // 2
    waves = _doc_waves(doc_ids, [joins + rounds_msgs[0]] + rounds_msgs[1:],
                       [list(range(half)), list(range(half, rounds))])
    wave_rows = [sum(len(r) for r in rounds_msgs[:half]), sum(len(r) for r in rounds_msgs[half:])]
    feeder = FirehoseFeeder(waves)
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {"docs": n_docs, "rounds": rounds, "rows": wave_rows}
    try:
        cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
               "--port", str(feeder.port), "--docs", ",".join(doc_ids), "--device", device,
               "--checkpoint-dir", os.path.join(root, "ckpt"),
               "--capacity", str(geom["max_segments"]),
               "--text-capacity", str(geom["text_capacity"]),
               "--max-insert-len", str(geom["max_insert_len"]),
               "--ops-per-step", str(geom["ops_per_step"]),
               "--megastep-k", str(geom["megastep_k"]), "--status-every", "600"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        runs = []
        for w in range(2):
            feeder.release(w)
            t = time.perf_counter()
            proc = subprocess.run([*cmd, "--exit-after-rows", str(wave_rows[w])],
                                  capture_output=True, text=True, timeout=300, env=env, cwd=repo)
            wall = time.perf_counter() - t
            check(proc.returncode == 0,
                  f"entry: fleet_main run {w} exited {proc.returncode}: {proc.stderr[-1500:]}")
            runs.append(([json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")],
                         wall))
            feeder.drop_subscribers()
        eng = DocBatchEngine(n_docs, device=device, **geom)
        texts = []
        for wave in waves:
            for d, doc in enumerate(doc_ids):
                if wave.get(doc):
                    eng.ingest_lines(d, wave[doc])
            eng.step()
            texts.append({doc: eng.text(d) for d, doc in enumerate(doc_ids)})
        (first, wall0), (second, wall1) = runs
        check(first[-1].get("done") and first[-1]["errors"] == 0, "entry: run 0 did not end clean")
        check(first[-1]["texts"] == texts[0], "entry: run 0's texts differ from the in-process engine")
        check(second[0].get("restored") == doc_ids, "entry: run 1 did not restore every doc")
        check(second[-1].get("done") and second[-1]["errors"] == 0, "entry: run 1 did not end clean")
        skipped = second[-1]["health"]["checkpointed_ops_skipped"]
        check(skipped > 0, "entry: the restart replay skipped nothing")
        check(second[-1]["texts"] == texts[1], "entry: run 1's texts differ from the in-process engine")
        out.update({"run_s": [wall0, wall1], "checkpointed_ops_skipped": skipped,
                    "checkpoints_written": first[-1]["health"]["checkpoints_written"]})
    finally:
        feeder.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_serving(seed: int, card: str, device: str, traffic, churn, n_docs: int = 10_000,
                  rounds: int = 16, sample: int = 64, geom: dict = FLEET_GEOM,
                  scribe_docs: tuple = (64, 64, 64, 4), matrix_steps: int = 4,
                  failover_docs: int = 512, failover_rounds: int = 8,
                  entry_docs: int = 256, entry_rounds: int = 8) -> dict:
    """Phase 14, the serving tier on ``device``: (a) the string fleet over
    the wire, (b) the tree fleet over the wire, (c) the scribe, (d)
    failover, (e) the ``fleet_main`` entry point (see the module
    docstring).  ``traffic`` is ``fleet_traffic``'s for ``n_docs`` docs;
    ``churn`` is ``phase_tree_churn``'s engine and stream."""
    geom = dict(geom, recovery="grow")
    out = {"phase": "serving", "card": card}
    t_all = time.perf_counter()
    # Each subscription holds a socket here and one in the feeder process.
    need = n_docs + 512
    limit = _raise_fd_limit(need)
    reduced = {}
    if limit < need:
        cut = max(64, limit - 512)
        reduced = {"reduced": f"docs {n_docs} -> {cut}: RLIMIT_NOFILE hard limit {limit}"}
        n_docs = cut
    out["fd_limit"] = limit
    parts = (
        ("wire_fleet", lambda: _serve_fleet(seed, device, traffic, n_docs, rounds, sample, geom,
                                            reduced)),
        ("wire_tree", lambda: _serve_tree(device, churn)),
        ("scribe", lambda: _serve_scribe(seed, device, *scribe_docs, matrix_steps, sample)),
        ("failover", lambda: _serve_failover(seed, device, traffic, failover_docs,
                                             failover_rounds, sample, geom)),
        ("entry", lambda: _serve_entry(device, traffic, entry_docs, entry_rounds, geom)),
    )
    for name, part in parts:
        t = time.perf_counter()
        out[name] = part()
        out[name]["part_s"] = time.perf_counter() - t
        gc.collect()
    out["wall_s"] = time.perf_counter() - t_all
    emit(out)
    return out


# ------------------------------------------------ phase 15: the sharded fleet

SHARDED_ROUNDS = 8      # of the fleet's shared traffic, for parts (a), (b)
SHARDED_MIGRATE_AT = 3  # parts (a), (b): 16 docs move after this round is ingested
SHARDED_BURST_AT = 4    # rounds 4 and 5: shard 0's docs run a round ahead


def _repack(eng, d: int) -> None:
    """What a migration (or a demotion) does to doc ``d``'s row, on an
    engine that keeps the doc in place: the row through the checkpoint
    codec, re-packed at the batch geometry into its own slot.  A control
    engine re-packs the docs the sharded engine moved at the same point of
    the stream, so every raw row of the two compares exactly."""
    from fluidframework_tpu_torch.dds import kernel_backend as kb
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    h = eng.hosts[d]
    summary = kb.state_to_summary(mk.to_numpy(eng.doc_state(d)),
                                  {v: k for k, v in h.prop_slot.items()})
    eng._put_row(int(eng._slot[d]), kb.summary_to_state_host(
        summary, eng.geometry, lambda p: eng._prop_slot_for_geom(h, p, eng.geometry)))


def _fleets_differ(a, b) -> tuple[int, int]:
    """(docs whose raw rows differ, docs whose error latch differs) between
    two string engines, each doc read at its own slot, compared on the
    device."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    n = a.n_docs
    ia = torch.as_tensor(a._slot, device=a.device)
    ib = torch.as_tensor(b._slot, device=b.device)
    diff = torch.zeros(n, dtype=torch.bool, device=a.device)
    for x, y in zip(mk.leaves(a.state), mk.leaves(b.state)):
        diff |= (x.index_select(0, ia) != y.index_select(0, ib).to(a.device)).reshape(n, -1).any(-1)
    latch = int((np.asarray(a.errors()[:n]) != np.asarray(b.errors()[:n])).sum())
    return int(diff.sum()), latch


def _sharded_fleet_run(eng, joins, rounds_msgs, role: str, plan: dict, shard0: set,
                       on_card: bool) -> dict:
    """One run of parts (a)/(b) over ``rounds_msgs``: a round an
    ``ingest_batch``, a step and a compact every two rounds; after round
    ``SHARDED_MIGRATE_AT`` is ingested the docs of ``plan["migrate"]`` move
    to the next shard with their rows still staged; at
    ``SHARDED_BURST_AT`` shard 0's docs take two rounds before the others.
    The ``"mesh"`` role migrates, calls ``rebalance_hot_shards()`` after
    every step (a serving loop's window) and at the burst until it makes a
    move, recording its moves in ``plan``; the ``"control"`` role re-packs
    the same docs at the same points (``_repack``)."""
    import torch

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ingest(msgs):
        if msgs:
            eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])

    def step():
        eng.step()
        eng.compact()

    def moved(point, moves):
        if role == "mesh":
            plan.setdefault(point, []).extend(moves)
        else:
            for d in plan.get(point, []):
                _repack(eng, d)

    out = {"migrate_ms": []}
    for d, m in joins:
        eng.ingest(d, m)
    sync()
    t0 = time.perf_counter()
    r = 0
    while r < len(rounds_msgs):
        if r == SHARDED_BURST_AT:
            both = [x for rr in (r, r + 1) for x in rounds_msgs[rr]]
            ingest([x for x in both if x[0] in shard0])
            if role == "mesh":
                moves = []
                for _ in range(4):
                    moves = eng.rebalance_hot_shards(2.0)
                    if moves:
                        break
                check(moves and all(t >= 0 for _d, _s, t in moves),
                      f"sharded: the burst on shard 0 made no migration ({moves})")
                out["burst_moves"] = moves
                moved("burst", [d for d, _s, _t in moves])
            else:
                moved("burst", None)
            ingest([x for x in both if x[0] not in shard0])
            step()
            r += 2
            continue
        ingest(rounds_msgs[r])
        if r == SHARDED_MIGRATE_AT:
            if role == "mesh":
                for d in plan["migrate"]:
                    check(len(eng.hosts[d].queue) > 0, f"sharded: doc {d} has no staged rows")
                    t = time.perf_counter()
                    ok = eng.migrate_doc(d, (eng.shard_of(d) + 1) % eng.n_shards)
                    sync()
                    out["migrate_ms"].append((time.perf_counter() - t) * 1e3)
                    check(ok, f"sharded: migrate_doc({d}) refused")
            else:
                for d in plan["migrate"]:
                    _repack(eng, d)
        if r % 2 == 1:
            step()
            if role == "mesh":
                moves = eng.rebalance_hot_shards(2.0)
                moved(f"step{r}", [d for d, _s, _t in moves])
            else:
                moved(f"step{r}", None)
        r += 1
    sync()
    out["wall_s"] = time.perf_counter() - t0
    out["ops"] = eng.counters.get("ops_staged")
    out["ops_per_s"] = out["ops"] / out["wall_s"]
    return out


def _sharded_fleet(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                   rounds: int = SHARDED_ROUNDS, spare: int = 64, sample: int = 64,
                   geom: dict = FLEET_GEOM) -> dict:
    """Parts (a) and (b): the config-3 fleet on a 4-shard mesh with
    ``spare`` spare slots (migrations, a hot-shard rebalance) against a
    control with no mesh (``use_mesh=False``: cohort steps) and the default
    full-fleet engine; every doc's raw row and latch equal across the
    three, 64 sampled unmoved docs equal a CPU replay; ops/s of each in
    turns."""
    import gc

    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    on_card = device == "cuda"
    geom = dict(geom, recovery="grow")
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    mesh = doc_mesh([device] * 4)
    rng = np.random.default_rng(seed + 15)
    # Docs 1.. of every shard: doc 0, the Zipf head, is the burst's move.
    plan = {"migrate": sorted(int(d) for d in rng.choice(np.arange(1, n_docs), 16, replace=False))}
    makers = {
        "mesh": lambda: DocBatchEngine(n_docs, mesh=mesh, spare_slots=spare, **geom),
        "cohort": lambda: DocBatchEngine(n_docs, device=device, use_mesh=False, **geom),
        "full": lambda: DocBatchEngine(n_docs, device=device, **geom),
    }
    shard0 = None
    runs: dict[str, list] = {k: [] for k in makers}
    engines = {}
    # Checked turns first (mesh, then the two controls), then timing turns
    # in reverse: mesh, cohort, full, full, cohort, mesh.
    for turn, name in enumerate(("mesh", "cohort", "full", "full", "cohort", "mesh")):
        eng = makers[name]()
        if shard0 is None:
            shard0 = {d for d in range(n_docs) if eng.shard_of(d) == 0}
        role = "mesh" if name == "mesh" else "control"
        # The timing turn of the mesh records its moves apart; the
        # controls re-pack the checked mesh run's.
        run_plan = plan if role == "control" or turn == 0 else {"migrate": plan["migrate"]}
        run = _sharded_fleet_run(eng, joins, rounds_msgs, role, run_plan, shard0, on_card)
        runs[name].append(run)
        if turn < 3:
            engines[name] = eng
        if turn == 2:
            m, c, f = engines["mesh"], engines["cohort"], engines["full"]
            for other_name, other in (("cohort", c), ("full", f)):
                rows, latch = _fleets_differ(m, other)
                check(rows == 0 and latch == 0,
                      f"sharded: {rows} rows / {latch} latches differ from the {other_name} engine")
            check(m.error_count() == 0 and not m.overflow and not m.quarantine,
                  "sharded: the mesh engine latched or recovered docs")
            check(c.cohort_steps > 0 and f.cohort_steps == 0 and m.cohort_steps == 0,
                  f"sharded: cohort steps {c.cohort_steps} / {f.cohort_steps} / {m.cohort_steps}")
            h = m.health()
            moved_docs = set(plan["migrate"]) | {d for k, v in plan.items() if k != "migrate"
                                                 for d in v}
            check(h["doc_migrations"] == len(moved_docs),
                  f"sharded: {h['doc_migrations']} migrations for {len(moved_docs)} moves")
            pick = sorted(int(d) for d in rng.choice(
                [d for d in range(n_docs) if d not in moved_docs], sample, replace=False))
            local = {d: j for j, d in enumerate(pick)}
            ref = DocBatchEngine(len(pick), device="cpu", **geom)
            t = time.perf_counter()
            _sharded_fleet_run(ref, [(local[d], x) for d, x in joins if d in local],
                               [[(local[d], x) for d, x in rr if d in local] for rr in rounds_msgs],
                               "control", {"migrate": []}, {local[d] for d in pick if d in shard0},
                               False)
            replay_s = time.perf_counter() - t
            same = sum(_state_rows_equal(m.doc_state(d), ref.doc_state(j)) for d, j in local.items())
            check(same == len(pick), f"sharded: {len(pick) - same} sampled docs differ from the CPU")
            shard_line = {
                "n_shards": m.n_shards, "capacity": m.capacity, "docs_per_shard": m.docs_per_shard,
                "free_slots": [m.free_slots(s) for s in range(m.n_shards)],
                "shard_ops": h["shard_ops"], "migrations": h["doc_migrations"],
                "hot_shard_rebalances": h["hot_shard_rebalances"],
                "burst_moves": runs["mesh"][0]["burst_moves"],
                "cohort": {"full_steps": c.full_steps, "cohort_steps": c.cohort_steps,
                           "cohort_lanes": c.cohort_lanes},
                "full": {"full_steps": f.full_steps},
                "identical_docs": n_docs, "sampled_docs_identical": same, "cpu_replay_s": replay_s,
            }
            if on_card:
                shard_line["cohort_programs"] = _time_cohort_pair(c)
            engines.clear()
            del m, c, f, ref
        del eng
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    migrate_ms = [x for run in runs["mesh"] for x in run["migrate_ms"]]
    return {
        "docs": n_docs, "rounds": rounds, "spare_slots": spare,
        "reduced": f"rounds 16 -> {rounds} (the fleet phase's 16 rounds of the shared traffic)",
        "ops": runs["mesh"][0]["ops"],
        "ops_per_s": {k: [r["ops_per_s"] for r in v] for k, v in runs.items()},
        "wall_s": {k: [r["wall_s"] for r in v] for k, v in runs.items()},
        "migrate_ms_mean": float(np.mean(migrate_ms)), "migrate_ms_max": float(np.max(migrate_ms)),
        "migrate_calls": len(migrate_ms), **shard_line,
    }


def _time_cohort_pair(eng, Kc: int = 16) -> dict:
    """``gather_cohort`` and ``scatter_cohort`` timed alone at the fleet's
    geometry on a 16-lane cohort (12 busy slots, 4 pad lanes) of ``eng``'s
    state, beside their bytes bounds (the cohort's rows read and written
    once).  The scatter writes the rows it gathered: the state's bytes do
    not change."""
    from fluidframework_tpu_torch.models import doc_batch_engine as dbe
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    busy = np.arange(12, dtype=np.int64) * 97
    idx = np.full((Kc,), busy[-1], np.int64)
    idx[:12] = eng._slot[busy]
    valid = np.zeros((Kc,), bool)
    valid[:12] = True
    state = eng.state
    sub = dbe.gather_cohort(state, idx)
    row_bytes = nbytes_of(mk.leaves(sub)) // Kc
    counts = dbe.gather_cohort.launches, dbe.scatter_cohort.launches
    out = {}
    for name, fn, nbytes in (
        ("gather", lambda: dbe.gather_cohort(state, idx), 2 * Kc * row_bytes),
        ("scatter", lambda: dbe.scatter_cohort(state, sub, idx, valid), 2 * 12 * row_bytes),
    ):
        out[name] = {"lanes": Kc, **time_program(fn, 20), "bound_bytes": nbytes,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    dbe.gather_cohort.launches, dbe.scatter_cohort.launches = counts
    return out


def hot_doc_messages(seed: int, rounds: int, writers: int = 4) -> tuple:
    """``four_writer_trace``'s op soup as sequenced wire messages for one
    document: per round every writer makes two edits at the round's
    ref_seq (inserts of 1-19 chars, removes, annotates and sided
    obliterates of its own insert), MSN at the round start.  Returns the
    joins and per-round message lists."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    joins = [SequencedMessage(client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
                              type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w})
             for w in range(writers)]
    out = []
    length = seq = 0
    for _r in range(rounds):
        ref, base = seq, length
        own = [0] * writers
        last_ins = [(0, 0)] * writers
        msgs = []
        for w in range(writers):
            for _ in range(2):
                own_len = base + own[w]
                kind = int(rng.integers(0, 5))
                p, ln = last_ins[w]
                if kind in (0, 1) or own_len < 4 or (kind == 4 and ln < 2):
                    tlen = int(rng.integers(1, 20))
                    pos = int(rng.integers(0, own_len + 1))
                    text = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, tlen))
                    c = {"type": 0, "pos1": pos, "seg": text}
                    last_ins[w] = (pos, tlen)
                    own[w] += tlen
                elif kind == 2:
                    p2 = min(p + max(1, ln // 2), own_len)
                    c = {"type": 1, "pos1": p, "pos2": p2}
                    own[w] -= p2 - p
                    last_ins[w] = (p, 0)
                elif kind == 3:
                    a = int(rng.integers(0, own_len - 1))
                    b = int(rng.integers(a + 1, own_len + 1))
                    c = {"type": 2, "pos1": a, "pos2": b,
                         "props": {int(rng.integers(0, 2)): int(rng.integers(1, 100))}}
                else:
                    c = {"type": 5, "pos1": {"pos": p, "before": True},
                         "pos2": {"pos": p + ln - 1, "before": False}}
                    own[w] -= ln
                    last_ins[w] = (p, 0)
                seq += 1
                msgs.append(SequencedMessage(client_id=f"w{w}", client_seq=seq, ref_seq=ref,
                                             seq=seq, min_seq=ref, contents=c))
        length = base + sum(own)
        out.append(msgs)
    return joins, out


# Config-1 geometry for phase 15's hot doc; 16 obliterate slots, as the
# reference's segment-lane tests give the four-writer op soup.
HOT_GEOM = dict(max_segments=16_384, text_capacity=131_072, remove_slots=4, prop_slots=2,
                ob_slots=16, max_insert_len=8, ops_per_step=16, megastep_k=8)


def _sharded_hot(seed: int, card: str, device: str, traffic, n_cold: int = 64,
                 hot_rounds: int = 80, spare: int = 64, geom: dict = HOT_GEOM) -> dict:
    """Part (c): a hot doc at config-1 geometry among ``n_cold`` cold docs
    (the fleet traffic's first docs) on an 8-device docs x segs mesh with 4
    segment shards, against an oracle engine that serves the hot doc in its
    batch row (no mesh, no lanes) and re-packs the docs the sharded engine
    moves or demotes at the same points (``_repack``).  The hot doc's
    rounds in five parts, stepped two rounds at a time with a rebalance
    window after each step: batch; promoted by ``enable_segment_sharding``
    (with rows staged) and re-blocked every 128 lane rows
    (``seg_rebalance_every``), demoted; batch; eight rounds staged at once,
    a deep queue that ``rebalance_hot_shards`` answers (the cold docs of
    its shard migrate off, then the hot doc promotes: a move to -1); the
    lane, demoted at the end.  Every doc's raw row and latch equal the oracle's at the end;
    on the lanes the hot doc's gathered document equals the oracle row's
    live content and ``seg_occupancy`` sums to its live count."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    hjoins, hrounds = hot_doc_messages(seed + 3, hot_rounds)
    cjoins, crounds = _rounds_for(traffic, n_cold, 3)
    mesh = docs_segs_mesh([device] * 8, seg_shards=4)
    hot = DocBatchEngine(1 + n_cold, mesh=mesh, spare_slots=spare, seg_rebalance_every=128,
                         **geom)
    oracle = DocBatchEngine(1 + n_cold, device=device, **geom)
    engines = (hot, oracle)
    for eng in engines:
        for m in hjoins:
            eng.ingest(0, m)
        for d, m in cjoins:
            eng.ingest(d + 1, m)
    # The hot doc's rounds in five parts (80 rounds: 16, 24, 10, 8, 22).
    bounds = [0, hot_rounds // 5, hot_rounds // 2, 5 * hot_rounds // 8,
              29 * hot_rounds // 40, hot_rounds]
    parts = [hrounds[bounds[i]:bounds[i + 1]] for i in range(5)]
    out = {"S": geom["max_segments"], "T": geom["text_capacity"], "cold_docs": n_cold,
           "hot_msgs": sum(len(r) for r in hrounds), "seg_shards": hot.seg_shards,
           "n_shards": hot.n_shards}
    lane_rows = 0
    lane_s = 0.0
    captured = {}
    seg_prog = hot._seg_megastep

    def capture(state, ops, pays, kinds=None):
        # The deepest ring the lane dispatches, for K6's timing alone.
        if ops.shape[0] > captured.get("ring", (None, np.zeros((0,))))[1].shape[0]:
            captured["ring"] = (state, ops, pays, kinds)
        return seg_prog(state, ops, pays, kinds=kinds)

    hot._seg_megastep = capture

    def feed(msgs, cold_round=None):
        for eng in engines:
            for m in msgs:
                eng.ingest(0, m)
            if cold_round is not None:
                for d, m in crounds[cold_round]:
                    eng.ingest(d + 1, m)

    def step_both():
        nonlocal lane_rows, lane_s
        lane = hot.seg_lanes.get(0)
        rows = len(lane.queue) if lane is not None else 0
        t = time.perf_counter()
        hot.step()
        sync()
        if lane is not None:
            lane_rows += rows
            lane_s += time.perf_counter() - t
        oracle.step()
        for eng in engines:
            eng.compact()

    def check_lane(tag):
        a = mk.canonical_doc(mk.to_numpy(oracle.doc_state(0)))
        b = mk.canonical_doc(hot.doc_state(0))
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        check(not bad, f"sharded hot ({tag}): the lane differs from the oracle in {bad}")
        check(mk.seg_replica_mismatch(hot.seg_lanes[0].state) == [],
              f"sharded hot ({tag}): the lane's replicas disagree")
        occ = hot.health()["seg_occupancy"]
        check(sum(occ) == b["nseg"], f"sharded hot ({tag}): occupancy {occ} vs {b['nseg']} live")
        return occ

    moves = []

    def rebalance():
        """One rebalance window; the oracle re-packs every doc it moved."""
        got = hot.rebalance_hot_shards(2.0)
        for d, _s, t in got:
            if t >= 0:
                _repack(oracle, d)
        moves.extend(got)
        return got

    def serve(rounds, cold_round=None, first=None):
        """Two rounds a step, as a serving loop steps; a rebalance window
        after each step.  ``first`` runs after the first two rounds are
        staged, before their step."""
        for i in range(0, len(rounds), 2):
            feed([m for r in rounds[i:i + 2] for m in r], cold_round if i == 0 else None)
            if i == 0 and first is not None:
                first()
            step_both()
            rebalance()

    def promote():
        check(hot.enable_segment_sharding(0), "sharded hot: enable_segment_sharding refused")

    # Part 1 in the batch, with a cold round.
    serve(parts[0], 0)
    # Part 2 on the lane: promoted with its first rows staged.
    serve(parts[1], first=promote)
    out["occupancy_first_lane"] = check_lane("first lane")
    check(hot.health()["seg_rebalances"] >= 1, "sharded hot: the lane never re-blocked")
    check(hot.disable_segment_sharding(0), "sharded hot: the demotion refused")
    _repack(oracle, 0)
    # Part 3 in the batch, with a cold round.
    serve(parts[2], 1)
    # Part 4: the hot doc's rounds staged at once, a deep queue: the
    # rebalance moves the cold docs of its shard off, then promotes it.
    feed([m for r in parts[3] for m in r])
    for _ in range(2 * hot.docs_per_shard):
        if any(t == -1 for _d, _s, t in rebalance()):
            break
    check(moves and moves[-1][0] == 0 and moves[-1][2] == -1 and 0 in hot.seg_lanes,
          f"sharded hot: no promotion by rebalance ({moves})")
    step_both()
    # Part 5 on the lane.
    serve(parts[4], 2)
    out["occupancy_second_lane"] = check_lane("second lane")
    hot._seg_megastep = seg_prog
    # K6 at n=4 alone on a captured ring (its launches, and K1's inside,
    # stay off the path's counts).
    timing = {}
    if on_card and "ring" in captured:
        st, o, p, kinds = captured["ring"]
        counts = mk.apply_megastep_seg.launches, resolve_positions.launches
        timing = time_program(lambda: seg_prog(st, o, p, kinds=kinds), 2, 1)
        mk.apply_megastep_seg.launches, resolve_positions.launches = counts
        nbytes, bound = state_bound(mk.leaves(st), (o, p))
        timing.update({"shape": [int(o.shape[0]), int(o.shape[1])], "seg_shards": 4,
                       "bound_bytes": nbytes, "bound_ms": bound, "bound_by": "bytes"})
    check(hot.disable_segment_sharding(0), "sharded hot: the final demotion refused")
    _repack(oracle, 0)
    rows, latch = _fleets_differ(hot, oracle)
    check(rows == 0 and latch == 0, f"sharded hot: {rows} rows / {latch} latches differ")
    check(hot.error_count() == 0 and not hot.overflow, "sharded hot: latched or overflowed")
    h = hot.health()
    out.update({
        "moves": moves, "seg_promotions": h["seg_promotions"],
        "seg_demotions": h["seg_demotions"], "seg_rebalances": h["seg_rebalances"],
        "doc_migrations": h["doc_migrations"], "lane_rows": lane_rows, "lane_s": lane_s,
        "lane_rows_per_s": lane_rows / lane_s if lane_s else None,
        "k6_n4": timing, "identical_docs": 1 + n_cold,
    })
    return out


def _sharded_tree(seed: int, card: str, device: str, churn, spare: int = 16,
                  n_migrate: int = 8) -> dict:
    """Part (d): tree_churn's stream through ``ingest_lines`` into a
    ``TreeBatchEngine`` on a 4-shard mesh with ``spare`` spare slots; 8 docs
    migrate mid-stream (rows staged); every doc equals the tree_churn
    engine's (the moved docs' views and EditManager windows, every other
    doc's raw rows too)."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    churn_eng, round_blobs = churn
    n = churn_eng.n_docs
    eng = TreeBatchEngine(n, mesh=doc_mesh([device] * 4), spare_slots=spare, **TREE_CHURN_GEOM)
    moved = sorted(int(d) for d in np.random.default_rng(seed + 16).choice(n, n_migrate,
                                                                            replace=False))
    mid = len(round_blobs) // 2
    migrate_ms = []
    t0 = time.perf_counter()
    for r, blobs in enumerate(round_blobs):
        for d, blob in enumerate(blobs):
            if blob:
                eng.ingest_lines(d, blob)
        if r == mid:
            for d in moved:
                t = time.perf_counter()
                check(eng.migrate_doc(d, (eng.shard_of(d) + 1) % eng.n_shards),
                      f"sharded tree: migrate_doc({d}) refused")
                migrate_ms.append((time.perf_counter() - t) * 1e3)
        eng.step()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not eng.errors().any() and sorted(eng.fallbacks) == sorted(churn_eng.fallbacks),
          "sharded tree: error bits or fallbacks differ from tree_churn's")
    # A moved doc's trunk fold records the removed content in its
    # EditManager window's Remove marks (as a checkpoint sweep's fold does,
    # in both packages), so its summary is compared in its trees only.
    views = sum(
        json.dumps(eng.tree_json(d)) == json.dumps(churn_eng.tree_json(d))
        and json.dumps(eng.values(d)) == json.dumps(churn_eng.values(d)) for d in moved
    )
    rows = sum(_tree_docs_identical(eng, d, churn_eng, d) for d in range(n) if d not in moved)
    check(views == len(moved) and rows == n - len(moved),
          f"sharded tree: {len(moved) - views} moved, {n - len(moved) - rows} other docs differ")
    return {"docs": n, "n_shards": eng.n_shards, "spare_slots": spare, "migrated": moved,
            "migrate_ms": migrate_ms, "wall_s": wall,
            "doc_migrations": eng.counters.get("doc_migrations"), "identical_docs": n}


def _sharded_entry(device: str, traffic, n_docs: int = 256, rounds: int = 8,
                   geom: dict = FLEET_GEOM) -> dict:
    """Part (e): ``fleet_main --mesh 4 --spare-slots 16 --rebalance-every
    0.5 --seg-shards 2`` over ``n_docs`` docs.  Shard 0's docs' rounds
    arrive first (wave 0); once the process prints a ``migrations`` line
    the rest follows (wave 1).  Its ``done`` texts equal an in-process
    engine's fed the same bytes."""
    import queue
    import threading

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"m{d}" for d in range(n_docs)]
    per = -(-n_docs // 4)
    first = [[(d, m) for d, m in r if d < per] for r in rounds_msgs]
    rest = [[(d, m) for d, m in r if d >= per] for r in rounds_msgs]
    waves = _doc_waves(doc_ids, [joins] + first + rest,
                       [list(range(rounds + 1)), list(range(rounds + 1, 2 * rounds + 1))])
    n_rows = sum(len(r) for r in rounds_msgs)
    feeder = FirehoseFeeder(waves)
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
           "--port", str(feeder.port), "--docs", ",".join(doc_ids), "--device", device,
           "--mesh", "4", "--spare-slots", "16", "--rebalance-every", "0.5",
           "--seg-shards", "2", "--capacity", str(geom["max_segments"]),
           "--text-capacity", str(geom["text_capacity"]),
           "--max-insert-len", str(geom["max_insert_len"]),
           "--ops-per-step", str(geom["ops_per_step"]),
           "--megastep-k", str(geom["megastep_k"]), "--status-every", "600",
           "--exit-after-rows", str(n_rows)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    lines: queue.Queue = queue.Queue()
    err = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    feeder.release(0)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                            cwd=repo)
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    got: list[dict] = []

    def stderr_tail() -> str:
        err.seek(0)
        return err.read()[-1500:]

    try:
        deadline = time.monotonic() + 240
        while not any("migrations" in x for x in got):
            if time.monotonic() > deadline or proc.poll() is not None:
                check(False, f"entry: no migrations line (last {got[-1:]}): {stderr_tail()}")
            try:
                x = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if x.startswith("{"):
                got.append(json.loads(x))
        feeder.release(1)
        rc = proc.wait(timeout=240)
        reader.join(timeout=10)
        while not lines.empty():
            x = lines.get()
            if x.startswith("{"):
                got.append(json.loads(x))
        check(rc == 0, f"entry: fleet_main exited {rc}: {stderr_tail()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        feeder.close()
        err.close()
    wall = time.perf_counter() - t0
    eng = DocBatchEngine(n_docs, device=device, **geom)
    for wave in waves:
        for d, doc in enumerate(doc_ids):
            if wave.get(doc):
                eng.ingest_lines(d, wave[doc])
        eng.step()
    done = got[-1]
    check(done.get("done") and done["errors"] == 0, "entry: fleet_main did not end clean")
    check(done["texts"] == {doc: eng.text(d) for d, doc in enumerate(doc_ids)},
          "entry: fleet_main's texts differ from the in-process engine's")
    migrations = [m for x in got if "migrations" in x for m in x["migrations"]]
    h = done["health"]
    check(h["n_shards"] == 4 and h["segment_shards"] == 2, "entry: not served on the 4-shard mesh")
    return {"docs": n_docs, "rounds": rounds, "rows": n_rows, "run_s": wall,
            "migrations": migrations, "doc_migrations": h["doc_migrations"],
            "n_shards": h["n_shards"], "segment_shards": h["segment_shards"]}


def phase_sharded(seed: int, card: str, device: str, traffic, churn, path=None, **sizes) -> dict:
    """Phase 15, the sharded fleet on ``device``: (a)+(b) ``_sharded_fleet``,
    (c) ``_sharded_hot``, (d) ``_sharded_tree``, (e) ``_sharded_entry``, one
    JSON line each (see the module docstring).  ``path(name, fn, ...)``
    runs each part as a main-path path of its own (launch counts);
    ``sizes`` cut each part for a rehearsal (``fleet=dict(...)``,
    ``hot=dict(...)``, ``entry=dict(...)``)."""
    path = path or (lambda _name, fn, *a, **k: fn(*a, **k))
    t_all = time.perf_counter()
    parts = (
        ("fleet", "sharded_fleet", lambda: _sharded_fleet(seed, card, device, traffic,
                                                          **sizes.get("fleet", {}))),
        ("hot", "sharded_hot", lambda: _sharded_hot(seed, card, device, traffic,
                                                    **sizes.get("hot", {}))),
        ("tree", "sharded_tree", lambda: _sharded_tree(seed, card, device, churn)),
        ("entry", "sharded_entry", lambda: _sharded_entry(device, traffic,
                                                          **sizes.get("entry", {}))),
    )
    out = {}
    for name, path_name, part in parts:
        t = time.perf_counter()
        line = path(path_name, part)
        line["part_s"] = time.perf_counter() - t
        emit({"phase": "sharded", "part": name, "card": card, **line})
        out[name] = line
        gc.collect()
    out["wall_s"] = time.perf_counter() - t_all
    emit({"phase": "sharded", "part": "total", "card": card, "wall_s": out["wall_s"]})
    return out


# ------------------------------------------------------ string client path

# Config 1's single document (``bench.py`` ``bench_config1``, four writers)
# as the client path holds it: one KernelMergeTree replica a client at the
# hot document's geometry; remove, prop and obliterate slots and the insert
# chunk stay the reference's defaults (4, 4, 8, 64).
STRING_CLIENT_GEOM = dict(max_segments=16_384, text_capacity=131_072)
STRING_CLIENT_KINDS = "koko"   # clients 0 and 2 on KernelMergeTree, 1 and 3 on RefMergeTree


class _StringClients:
    """Phase 16's document: four ``ContainerRuntime`` clients over one
    ``LocalService`` document, each holding a ``sharedString`` "s"."""

    def __init__(self, device: str, geom: dict):
        from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
        from fluidframework_tpu_torch.server.local_service import LocalService

        self.make_kernel = lambda: KernelMergeTree(**geom, device=device)
        self.doc = LocalService().document("phase16")
        self.clients = [self.container(f"C{i}", k) for i, k in enumerate(STRING_CLIENT_KINDS)]
        self.epoch = [0] * len(self.clients)
        self.doc.process_all()

    def container(self, name: str, kind: str, stash: str | None = None):
        from fluidframework_tpu_torch.dds import channels
        from fluidframework_tpu_torch.runtime import ContainerRuntime

        channels.set_string_backend_factory(self.make_kernel if kind == "k" else None)
        try:
            rt = ContainerRuntime(channels.default_registry(), container_id=name)
            rt.create_datastore("root").create_channel("sharedString", "s")
            rt.connect(self.doc, name, stash=stash)
        finally:
            channels.set_string_backend_factory(None)
        return rt

    def s(self, i: int):
        return self.clients[i].datastore("root").get_channel("s")

    def kernels(self) -> list:
        return [self.s(i).backend for i, k in enumerate(STRING_CLIENT_KINDS) if k == "k"]

    def act(self, action: tuple) -> None:
        kind, i, *rest = action
        rt = self.clients[i]
        if kind == "edit":
            _string_edit(self.s(i), rest[0])
        elif kind == "flush":
            rt.flush()
        elif kind == "sync":
            for c in self.clients:
                c.flush()
            self.doc.process_all()
        elif kind == "drop":
            rt.disconnect()
        elif kind == "rejoin":
            self.epoch[i] += 1
            rt.connect(self.doc, f"C{i}.r{self.epoch[i]}")
            self.doc.process_all()
        elif kind == "rehydrate":
            stash = rt.get_pending_local_state()
            rt.close()
            self.epoch[i] += 1
            self.clients[i] = self.container(f"C{i}.s{self.epoch[i]}", STRING_CLIENT_KINDS[i],
                                             stash=stash)
            self.doc.process_all()
        else:
            raise ValueError(kind)

    def views(self, i: int) -> tuple:
        s = self.s(i)
        return (s.text, json.dumps(s.annotations(), sort_keys=True),
                sorted(json.dumps(iv.to_json(), sort_keys=True)
                       for iv in s.get_interval_collection("f")))


def _gen_string_edit(rng, s) -> tuple:
    n = len(s.position_text())
    kind = rng.choices(["ins", "rem", "ann", "ob", "obs", "iv"], [42, 20, 12, 7, 4, 15])[0]
    if kind == "ins" or n == 0:
        return ("ins", rng.randint(0, n), rng.choice("abcdefgh") * rng.randint(1, 8))
    p1 = rng.randrange(n)
    p2 = rng.randint(p1 + 1, min(n, p1 + 8))
    if kind == "rem":
        return ("rem", p1, p2)
    if kind == "ann":
        return ("ann", p1, p2, rng.choice(["bold", "color"]), rng.choice([True, "red", 7]))
    if kind == "ob":
        return ("ob", p1, p2)
    if kind == "obs":
        c2 = rng.randint(p1, min(n - 1, p1 + 8))
        s1, s2 = rng.random() < 0.5, rng.random() < 0.5
        if p1 == c2 and not s1 and s2:
            s1 = True
        return ("obs", (p1, s1), (c2, s2))
    return ("iv", p1, rng.randint(p1, min(n - 1, p1 + 16)))


def _string_edit(s, op: tuple) -> None:
    kind, *a = op
    if kind == "ins":
        s.insert_text(*a)
    elif kind == "rem":
        s.remove_range(*a)
    elif kind == "ann":
        s.annotate_range(*a)
    elif kind == "ob":
        s.obliterate_range(*a)
    elif kind == "obs":
        s.obliterate_range_sided(*a)
    else:
        s.get_interval_collection("f").add(*a)


def _string_client_run(device: str, geom: dict, seed: int, n_edits: int,
                       reconnect_every: int, script=None, sink=None) -> dict:
    """One run of phase 16's script.  With ``script`` None the seeded
    script is made as it runs (from the acting client's view), each action
    passed to ``sink`` as it is taken (and None at the end); otherwise the
    actions of ``script`` (any iterable) are replayed one by one.  Every
    sync checks that the four clients' texts, resolved annotations and
    intervals are equal."""
    import random

    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    fleet = _StringClients(device, geom)
    rng = random.Random(seed)
    record = script is None
    taken: list = []
    edits = syncs = peak_nseg = 0
    t0 = time.perf_counter()

    def run(action):
        nonlocal edits, syncs, peak_nseg
        taken.append(action)
        if record and sink is not None:
            sink(action)
        fleet.act(action)
        if action[0] == "edit":
            edits += 1
        if action[0] == "sync":
            syncs += 1
            views = [fleet.views(i) for i in range(len(fleet.clients))]
            check(all(v == views[0] for v in views[1:]),
                  f"string_client ({device}): the clients diverged at sync {syncs}")
            peak_nseg = max([peak_nseg] + [int(k.state.nseg) for k in fleet.kernels()])

    if record:
        stash_round = (n_edits // 12) // 2
        r = 0
        while edits < n_edits:
            for i in rng.sample(range(4), 4):
                for _ in range(rng.randint(1, 3)):
                    run(("edit", i, _gen_string_edit(rng, fleet.s(i))))
                run(("flush", i))
            if r % reconnect_every == reconnect_every - 1 or r == stash_round:
                # A kernel client drops with its pending ops, edits offline
                # and comes back (or rehydrates its stash): its pending ops
                # regenerate through K5 against everything sequenced since.
                j = 2 * ((r // reconnect_every) % 2)
                run(("drop", j))
                for _ in range(rng.randint(1, 3)):
                    run(("edit", j, _gen_string_edit(rng, fleet.s(j))))
                run(("rehydrate" if r == stash_round else "rejoin", j))
            run(("sync", 0))
            r += 1
        if sink is not None:
            sink(None)
    else:
        for action in script:
            run(action)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels = fleet.kernels()
    return {
        "edits": edits, "syncs": syncs, "seconds": seconds,
        "edits_per_s": edits / seconds, "peak_nseg": peak_nseg,
        "regenerated": sum(k.regenerated for k in kernels),
        "rehydrated": sum(1 for a in taken if a[0] == "rehydrate"),
        "reconnects": sum(1 for a in taken if a[0] == "rejoin"),
        "states": [[x.cpu().numpy() for x in mk.leaves(k.state)] for k in kernels],
        "errors": [k.check_errors() for k in kernels],
        "summaries": [json.dumps(k.export_summary(), sort_keys=True) for k in kernels],
        "stream": [dict(json.loads(m.to_json()), timestamp=0) for m in fleet.doc.sequencer.log],
        "text": fleet.s(0).text, "kernels": kernels,
    }


def _string_client_replay_main(conn, geom: dict, seed: int, n_edits: int,
                               reconnect_every: int) -> None:
    """Phase 16's CPU run in its own process: replays the actions the card
    run sends as it takes them, then sends back its result.  Four intra-op
    threads, to leave the host's other cores to the card run."""
    import torch

    torch.set_num_threads(4)
    try:
        out = _string_client_run("cpu", geom, seed, n_edits, reconnect_every,
                                 script=iter(conn.recv, None))
        out.pop("kernels")
        conn.send(out)
    except Exception:  # the parent reports it and fails the phase
        import traceback

        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()


def _squash_regeneration(device: str, geom: dict, summary: dict, last_seq: int,
                         seed: int) -> tuple:
    """Reconnect regeneration with squash on one replica restored from the
    document's summary (the runtime never asks for squash, as the
    reference's does not; ``KernelMergeTree.regenerate_pending`` is the
    entry the channel's squash resubmit calls): pending inserts, pending
    removes over half of them (squashed pairs: ``drop_squashed``), pending
    annotates, and a pending obliterate whose range a concurrent remote
    remove takes (retired: ``strip_stamp``).  Returns the re-minted ops and
    the replica."""
    import random

    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED, LOCAL_BASE

    rng = random.Random(seed)
    kmt = KernelMergeTree(**geom, device=device)
    kmt.import_summary(summary)
    me = kmt.local_client
    ls = 0

    def local(name, *args):
        nonlocal ls
        ls += 1
        getattr(kmt, name)(*args, LOCAL_BASE + ls, me, ALL_ACKED)

    # The obliterate goes first, while the local view is the acked one, so
    # the remote remove (which sees no pending op) lands on its range.
    p = rng.randint(8, kmt.visible_length() - 8)
    local("apply_obliterate", p, 0, p + 3, 1)
    kmt.apply_remove(p - 2, p + 6, last_seq + 1, 0, last_seq)
    for _ in range(16):
        p = rng.randint(0, kmt.visible_length())
        local("apply_insert", p, "sq" * rng.randint(1, 4))
        if rng.random() < 0.5:
            local("apply_remove", p, p + 2)
        if rng.random() < 0.3:
            local("apply_annotate", max(p - 3, 0), p + 1, 0, 5)
    fresh = iter(range(ls + 1, ls + 10_000)).__next__
    plans = [kmt.regenerate_pending(i, fresh, squash=True) for i in range(1, ls + 1)]
    return plans, kmt


def _time_one_doc_programs(card: str, kmt) -> dict:
    """The one-doc programs of the client path timed alone on a kernel
    replica's final state (S=16,384): ``apply_op`` (one insert), K3
    (``set_min_seq`` + ``compact``), and K5 (``restamp`` of every class,
    ``drop_squashed``, ``strip_stamp``); each result held against the
    same call on the CPU; bytes bounds at 3.35 TB/s.  Called outside the
    path: its launches are not the path's."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    s = kmt.state
    S = s.seg_len.shape[0]
    host = mk.from_numpy(mk.to_numpy(s), device="cpu")
    n = kmt.visible_length()
    op, payload = mk.encode_insert(n // 2, "timing", 1 << 29, 1, 1 << 28, kmt.max_insert_len)[0]
    mask = (torch.arange(S) % 3 == 0).numpy()
    key = int(mk.to_numpy(s).ins_key[0])
    ob_flag = bool((s.ob_key >= 0).any())  # the gate as the path decides it: on the host
    per_seg = [s.seg_start, s.seg_len, s.ins_key, s.ins_client, s.seg_uid, s.seg_obpre,
               *s.rem_keys, *s.rem_clients, *s.prop_keys, *s.prop_vals]
    restamp_cols = [s.ins_key, s.ins_client, *s.rem_keys, *s.rem_clients, *s.prop_keys,
                    s.seg_obpre, s.ob_key, s.ob_client]
    ob_cols = [s.ob_key, s.ob_start_uid, s.ob_end_uid]
    progs = {
        "apply_op": (lambda st: mk.apply_op(st, op, payload, ob_flag=ob_flag),
                     2 * nbytes_of(mk.leaves(s)) + op.nbytes + payload.nbytes),
        "compact": (lambda st: mk.doc_row(mk.compact(
            mk.set_min_seq(mk.one_doc_batch(st), [int(st.min_seq) + 1])), 0),
            2 * nbytes_of(per_seg) + nbytes_of(ob_cols)),
        "restamp": (lambda st: mk.restamp(st, mask, key, key + 1, 3, True, True, True, True),
                    2 * nbytes_of(restamp_cols) + mask.nbytes),
        "drop_squashed": (mk.drop_squashed, 2 * nbytes_of(per_seg) + nbytes_of(ob_cols)),
        "strip_stamp": (lambda st: mk.strip_stamp(st, key),
                        2 * nbytes_of([*s.rem_keys, *s.rem_clients, s.ob_key])),
    }
    out = {}
    for name, (fn, nbytes) in progs.items():
        want = [x.numpy() for x in mk.leaves(fn(host))]
        got = [x.cpu().numpy() for x in mk.leaves(fn(s))]
        err = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))
                  for a, b in zip(got, want))
        check(err == 0, f"{name} on the card disagrees with the CPU")
        out[name] = {"S": S, "ms": cuda_ms(lambda: fn(s), 20, warmup=1), "max_abs_err": err,
                     "bound_bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}
    # Device times after every call time: the profiler's session leaves
    # later launches dearer on the host.
    for name, (fn, _nbytes) in progs.items():
        out[name]["device_ms"] = _device_sum(device_ms_by_name(lambda: fn(s), 10))
    emit({"phase": "string_client_programs", "card": card, **out})
    return out


def phase_string_client(seed: int, card: str, device: str = "cuda", geom: dict | None = None,
                        n_edits: int = 4000, reconnect_every: int = 6) -> dict:
    """Phase 16: the SharedString client path (``ContainerRuntime`` +
    ``LocalService`` + ``SharedStringChannel``), two ``KernelMergeTree``
    replicas on ``device`` and two ``RefMergeTree`` ones, a seeded script
    of ``n_edits`` edits with reconnects and one stash; then the same
    script with the kernel replicas on the CPU: every kernel replica's raw
    state, error latch and summary identical between the runs; then the
    squash regeneration on one replica restored from the summary, held
    against the CPU.  The CPU run replays the card run's actions in a
    process of its own, alongside.  Returns the line and a kernel replica on ``device``
    (``_time_one_doc_programs`` times the one-doc programs on its state)."""
    import multiprocessing

    geom = dict(STRING_CLIENT_GEOM if geom is None else geom)
    t0 = time.perf_counter()
    # The CPU run replays the card run's actions in its own process as they
    # are taken, so the two runs share the wall clock.
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_string_client_replay_main,
                       args=(child, geom, seed, n_edits, reconnect_every), daemon=True)
    proc.start()
    child.close()
    try:
        card_run = _string_client_run(device, geom, seed, n_edits, reconnect_every,
                                      sink=parent.send)
        cpu_run = parent.recv()
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    check("error" not in cpu_run, f"string_client: the CPU run failed: {cpu_run.get('error')}")
    check(card_run["errors"] == cpu_run["errors"] == [0, 0],
          f"string_client: error latches {card_run['errors']} / {cpu_run['errors']}")
    for k, (a, b) in enumerate(zip(card_run["states"], cpu_run["states"])):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"string_client: kernel replica {k}'s state differs between {device} and the CPU")
    check(card_run["summaries"] == cpu_run["summaries"],
          "string_client: kernel summaries differ between the card and the CPU")
    check(card_run["stream"] == cpu_run["stream"] and card_run["text"] == cpu_run["text"],
          "string_client: the sequenced streams differ between the card and the CPU")
    check(card_run["regenerated"] > 0 and card_run["rehydrated"] == 1,
          "string_client: no op was regenerated, or the stash never rehydrated")
    summary = json.loads(card_run["summaries"][0])
    last_seq = card_run["stream"][-1]["sequenceNumber"]
    plans, sq = _squash_regeneration(device, geom, summary, last_seq, seed)
    cpu_plans, sq_cpu = _squash_regeneration("cpu", geom, summary, last_seq, seed)
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    check(plans == cpu_plans and all(
        np.array_equal(x.cpu().numpy(), y.numpy())
        for x, y in zip(mk.leaves(sq.state), mk.leaves(sq_cpu.state))),
        "string_client: squash regeneration differs between the card and the CPU")
    check(not plans[0], "string_client: the pending obliterate was not retired")
    line = {
        "phase": "string_client", "card": card, "clients": STRING_CLIENT_KINDS,
        "geometry": geom, "edits": card_run["edits"], "syncs": card_run["syncs"],
        "reconnects": card_run["reconnects"], "stash_rehydrations": card_run["rehydrated"],
        "regenerated_ops": card_run["regenerated"], "peak_nseg": card_run["peak_nseg"],
        "text_len": len(card_run["text"]), "sequenced": len(card_run["stream"]),
        "edits_per_s": card_run["edits_per_s"], "cpu_edits_per_s": cpu_run["edits_per_s"],
        "run_s": card_run["seconds"], "cpu_run_s": cpu_run["seconds"],
        "squash_plans": len(plans), "identical_to_cpu": True,
    }
    line["phase_s"] = time.perf_counter() - t0
    emit(line)
    return line, card_run["kernels"][0]



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None,
                    help="write the recorded turns' Chrome traces here (none by default)")
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
        from fluidframework_tpu_torch.ops import cuda_build
        from fluidframework_tpu_torch.ops import resolve_kernel as rk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    card = card_label()
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    emit({"phase": "build", "card": card, "build_s": time.perf_counter() - t0,
          "library": str(cuda_build.library_path().name),
          "sources": [src.name for src in cuda_build.sources()]})

    # The main path, phase by phase: the launch counts of K1, of the fleet
    # programs (K2, K3, K6), of the tree programs (K7, K8), of K9 and of the
    # map and matrix programs are set to 0 just before each path and read
    # just after it.  A path that runs a kernel fails if it never launched:
    # K1 on the segment lane and the long-document plane, K7 on every tree
    # path, K8 on the tree fleet (its faulted docs pass the compaction
    # watermark) and the churn path, K9 on the device rebase path, the map
    # and matrix programs on theirs.  The
    # fleet runs at recovery="grow" and then, to price recovery's per-step
    # error-count read and log, in turns off, grow, grow, off; every turn
    # ingests a round through one ingest_batch call except the first grow
    # of the turns (per-message ingest), and the second grow of the turns
    # runs with a flight recorder installed.
    from fluidframework_tpu_torch.models import doc_batch_engine as dbe
    from fluidframework_tpu_torch.ops import map_kernel as mpk
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    counters = {"resolve_positions": rk.resolve_positions,
                "apply_megastep": mk.apply_megastep, "compact": mk.compact,
                "apply_megastep_seg": mk.apply_megastep_seg, "compact_seg": mk.compact_seg,
                "apply_nested_megastep": tk.apply_nested_megastep,
                "compact_nested": tk.compact_nested, "rebase_window": rk9.rebase_window,
                "apply_batch_fleet": mpk.apply_batch_fleet,
                "apply_ops_fleet": mxk.apply_ops_fleet,
                "gather_cohort": dbe.gather_cohort, "scatter_cohort": dbe.scatter_cohort,
                "apply_op": mk.apply_op, "restamp": mk.restamp,
                "drop_squashed": mk.drop_squashed, "strip_stamp": mk.strip_stamp}
    paths = {name: {} for name in counters}

    def path(name, fn, *args, **kw):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kw)
        for prog, c in counters.items():
            paths[prog][name] = c.launches
        return out

    # Phase 16 (the SharedString client path) runs first, before any
    # torch.profiler session: its rate is host issue, one op at a time, and
    # a profiler session leaves every later launch dearer on the host.
    _line, string_kmt = path("string_client", phase_string_client, args.seed, card, "cuda")
    for prog, what in (("apply_op", "the one-doc apply_op"), ("compact", "K3"),
                       ("restamp", "K5's restamp"), ("drop_squashed", "K5's drop_squashed"),
                       ("strip_stamp", "K5's strip_stamp")):
        check(paths[prog]["string_client"] > 0,
              f"{what} was never launched on the string_client path")
    k = phase_kernels(args.seed, card)
    k9 = phase_rebase_kernel(args.seed, card)
    one_doc = _time_one_doc_programs(card, string_kmt)
    del string_kmt

    # One traffic for every fleet turn, the recovery phase (which takes two
    # rounds past the fleet's 16) and the fleet programs' timing, made
    # outside the timed runs.
    t0 = time.perf_counter()
    traffic = fleet_traffic(10_000, 18, FLEET_GEOM["ops_per_step"], 8, args.seed)
    emit({"phase": "traffic", "docs": 10_000, "rounds": 18,
          "traffic_gen_s": time.perf_counter() - t0})
    path("fleet", phase_fleet, args.seed, card, "cuda", traffic, recovery="grow")
    for recovery, ingest, record in (("off", "batch", False), ("grow", "message", False),
                                     ("grow", "batch", True), ("off", "batch", False)):
        phase_fleet(args.seed, card, "cuda", traffic, recovery=recovery, ingest=ingest,
                    record=record, trace_dir=args.trace_dir)
    path("recovery", phase_recovery, args.seed, card, "cuda", traffic)
    path("hot_doc", phase_hot_doc, args.seed, card, "cuda")
    path("long_doc", phase_long_doc, args.seed, card, "cuda")
    phase_fleet_programs(args.seed, card, traffic)
    _line, ring = path("tree_fleet", phase_tree_fleet, args.seed, card, "cuda",
                       record=True, trace_dir=args.trace_dir)
    _line, deep = path("tree_deep", phase_tree_deep, args.seed, card, "cuda")
    _line, churn = path("tree_churn", phase_tree_churn, args.seed, card, "cuda")
    path("wire_ingest", phase_wire_ingest, args.seed, card, "cuda", churn)
    tree = time_tree_programs(card, ring)
    del ring
    path("tree_rebase", phase_tree_rebase, args.seed, card, "cuda", deep,
         trace_dir=args.trace_dir)
    del deep
    mp_line = path("map_lww", phase_map_lww, args.seed, card, "cuda")
    mx_line = path("matrix", phase_matrix, args.seed, card, "cuda")
    path("serving", phase_serving, args.seed, card, "cuda", traffic, churn)
    sharded = phase_sharded(args.seed, card, "cuda", traffic, churn, path=path)
    del traffic, churn
    for name in ("hot_doc", "long_doc", "sharded_hot"):
        check(paths["resolve_positions"][name] > 0, f"K1 was never launched on the {name} path")
    for prog, what in (("apply_megastep_seg", "K6"), ("compact_seg", "K6's compaction")):
        check(paths[prog]["sharded_hot"] > 0, f"{what} was never launched on the sharded_hot path")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"),
                       ("gather_cohort", "the cohort gather"),
                       ("scatter_cohort", "the cohort scatter")):
        check(paths[prog]["sharded_fleet"] > 0, f"{what} was never launched on the sharded_fleet path")
    check(paths["apply_nested_megastep"]["sharded_tree"] > 0,
          "K7 was never launched on the sharded_tree path")
    for name in ("tree_fleet", "tree_deep", "tree_churn", "wire_ingest", "tree_rebase"):
        check(paths["apply_nested_megastep"][name] > 0, f"K7 was never launched on the {name} path")
    check(paths["apply_megastep"]["wire_ingest"] > 0,
          "the fleet program was never launched on the wire_ingest path")
    check(paths["rebase_window"]["tree_rebase"] > 0, "K9 was never launched on the tree_rebase path")
    check(paths["apply_batch_fleet"]["map_lww"] > 0, "the map program never ran on the map_lww path")
    check(paths["apply_ops_fleet"]["matrix"] > 0, "the matrix program never ran on the matrix path")
    for name in ("tree_fleet", "tree_churn"):
        check(paths["compact_nested"][name] > 0, f"K8 was never launched on the {name} path")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"), ("apply_nested_megastep", "K7"),
                       ("compact_nested", "K8"), ("apply_batch_fleet", "the map program"),
                       ("apply_ops_fleet", "the matrix program")):
        check(paths[prog]["serving"] > 0, f"{what} was never launched on the serving path")

    emit({"phase": "fleet_programs_launches", **{prog: paths[prog] for prog in (
        "apply_megastep", "compact", "apply_megastep_seg", "compact_seg", "gather_cohort",
        "scatter_cohort")}})
    k6n4 = sharded["hot"]["k6_n4"]
    cohort = sharded["fleet"]["cohort_programs"]
    k7, k8 = tree["k7"], tree["k8"]
    k9m = k9["microbench_256"]
    mp_prog, mx_prog = mp_line["fleet_program"], mx_line["step_program"]
    emit({"kernels": [{
        "name": "resolve_positions", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/resolve_positions.cu",
        "replaces": "fluidframework_tpu/ops/pallas_kernels.py:65",
        "launches": sum(paths["resolve_positions"].values()),
        "launches_by_path": paths["resolve_positions"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "device_ms": k["kernel_device_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    }, {
        "name": "apply_nested_megastep", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/tree_kernel.py",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:648",
        "launches": sum(paths["apply_nested_megastep"].values()),
        "launches_by_path": paths["apply_nested_megastep"],
        "max_abs_err": k7["max_abs_err"], "ms": k7["ms"], "device_ms": k7["device_ms"],
        "plain_ms": None, "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "library_ms": None,
    }, {
        "name": "compact_nested", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/tree_kernel.py",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:666",
        "launches": sum(paths["compact_nested"].values()),
        "launches_by_path": paths["compact_nested"],
        "max_abs_err": k8["max_abs_err"], "ms": k8["ms"], "device_ms": k8["device_ms"],
        "plain_ms": None, "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "library_ms": None,
    }, {
        "name": "rebase_window", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/rebase_window.cu",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:1146",
        "launches": sum(paths["rebase_window"].values()),
        "launches_by_path": paths["rebase_window"],
        "max_abs_err": max(k9[n]["max_abs_err"] for n in (
            "microbench_256", "microbench_4096", "tree_deep_window", "serving_16")),
        "shape": [k9m["W"], k9m["C"]], "ms": k9m["ms"], "device_ms": k9m["device_ms"],
        "us_per_step": k9m["us_per_step"],
        "plain_ms": k9m["plain_ms"], "bound_ms": k9m["bound_ms"], "bound_by": k9m["bound_by"],
        "library_ms": None, "host_fold_ms": k9m["host_fold_ms"],
    }, {
        "name": "apply_batch_fleet", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/map_kernel.py",
        "replaces": "fluidframework_tpu/ops/map_kernel.py:59",
        "launches": sum(paths["apply_batch_fleet"].values()),
        "launches_by_path": paths["apply_batch_fleet"],
        "max_abs_err": mp_prog["max_abs_err"], "shape": mp_prog["shape"],
        "ms": mp_prog["ms"], "device_ms": mp_prog["device_ms"], "plain_ms": None,
        "bound_ms": mp_prog["bound_ms"], "bound_by": mp_prog["bound_by"], "library_ms": None,
    }, {
        "name": "apply_ops_fleet", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/matrix_kernel.py",
        "replaces": "fluidframework_tpu/ops/matrix_kernel.py:184",
        "launches": sum(paths["apply_ops_fleet"].values()),
        "launches_by_path": paths["apply_ops_fleet"],
        "max_abs_err": mx_prog["max_abs_err"], "shape": mx_prog["shape"],
        "ms": mx_prog["ms"], "device_ms": mx_prog["device_ms"], "plain_ms": None,
        "bound_ms": mx_prog["bound_ms"], "bound_by": mx_prog["bound_by"], "library_ms": None,
    }, {
        "name": "apply_megastep_seg", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": "fluidframework_tpu/ops/mergetree_kernel.py:1291",
        "launches": sum(paths["apply_megastep_seg"].values()),
        "launches_by_path": paths["apply_megastep_seg"],
        "max_abs_err": 0, "seg_shards": k6n4["seg_shards"], "shape": k6n4["shape"],
        "ms": k6n4["ms"], "device_ms": k6n4["device_ms"], "plain_ms": None,
        "bound_ms": k6n4["bound_ms"], "bound_by": k6n4["bound_by"], "library_ms": None,
    }] + [{
        "name": f"{name}_cohort", "route": "torch",
        "source": "fluidframework_tpu_torch/models/doc_batch_engine.py",
        "replaces": f"fluidframework_tpu/models/doc_batch_engine.py:{line}",
        "launches": sum(paths[f"{name}_cohort"].values()),
        "launches_by_path": paths[f"{name}_cohort"],
        "max_abs_err": 0, "lanes": cohort[name]["lanes"],
        "ms": cohort[name]["ms"], "device_ms": cohort[name]["device_ms"], "plain_ms": None,
        "bound_ms": cohort[name]["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, line in (("gather", 222), ("scatter", 249))] + [{
        "name": name, "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": f"fluidframework_tpu/ops/mergetree_kernel.py:{line}",
        "launches": sum(paths[name].values()), "launches_by_path": paths[name],
        "max_abs_err": one_doc[name]["max_abs_err"], "S": one_doc[name]["S"],
        "ms": one_doc[name]["ms"], "device_ms": one_doc[name]["device_ms"], "plain_ms": None,
        "bound_ms": one_doc[name]["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, line in (("apply_op", 775), ("drop_squashed", 1556), ("strip_stamp", 1571),
                         ("restamp", 1590))]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
