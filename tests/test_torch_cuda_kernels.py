"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against the CPU path.  Every test here needs a card: it
carries the ``cuda`` marker and skips (deciding inside the fixture) where
``torch.cuda.is_available()`` is false.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs with the repository conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.ops import resolve_kernel as rk

pytestmark = pytest.mark.cuda


# Cases around the edges of K1's tiles of ``rk.TILE`` segments, shared with
# tests/test_torch_resolve_kernel.py: segment counts one below, at and one
# past a tile, a ragged third tile, and whole zero-sum tiles at the start, in
# the middle and at the end (the last full tile and the ragged tail).
TILE_CASES = ("S=T-1", "S=T", "S=T+1", "S=2T+3", "zero-start", "zero-middle", "zero-end")


def tile_queries(lens, tile, rng, n=300):
    """``n`` queries (more than one query chunk of the kernel): the prefix at
    every tile start and the total, one below each, one past the end, and
    random positions in [0, total + 3)."""
    incl = np.cumsum(lens, dtype=np.int64)
    total = int(incl[-1])
    edges = np.unique(np.concatenate([[0], incl[tile - 1::tile], [total]]))
    fixed = np.concatenate([edges, edges - 1, [total + 5]])
    rand = rng.integers(0, total + 3, size=n - len(fixed))
    return np.concatenate([fixed, rand]).astype(np.int32)


def _tile_lens(rng, shape):
    lens = rng.integers(0, 9, size=shape).astype(np.int32)
    return np.where(rng.random(shape) < 0.7, lens, 0).astype(np.int32)


def tile_case(name, tile, seed=0):
    """(lens[S], queries[300]) of one of ``TILE_CASES``."""
    rng = np.random.default_rng([seed, TILE_CASES.index(name)])
    S = {"S=T-1": tile - 1, "S=T": tile, "S=T+1": tile + 1, "S=2T+3": 2 * tile + 3}
    lens = _tile_lens(rng, S.get(name, 3 * tile + 3))
    for t in {"zero-start": [0], "zero-middle": [1], "zero-end": [2, 3]}.get(name, []):
        lens[t * tile:(t + 1) * tile] = 0
    return lens, tile_queries(lens, tile, rng)


def batched_tile_case(tile, seed=0):
    """The batched form, D=3 docs of 2 * tile + 3 segments: one random, one
    with a zero first tile, one with a zero second tile and tail."""
    rng = np.random.default_rng([seed, len(TILE_CASES)])
    lens = _tile_lens(rng, (3, 2 * tile + 3))
    lens[1, :tile] = 0
    lens[2, tile:] = 0
    return lens, np.stack([tile_queries(row, tile, rng) for row in lens])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(seed, n_segs, n_queries=256):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, size=n_segs).astype(np.int32)
    lens = np.where(rng.random(n_segs) < 0.7, lens, 0).astype(np.int32)
    total = int(lens.sum())
    qs = rng.integers(-3, total + 4, size=n_queries).astype(np.int32)
    return lens, qs


def _assert_kernel_matches_plain(device, lens, qs):
    lt = torch.from_numpy(lens).to(device)
    qt = torch.from_numpy(qs).to(device)
    before = rk.resolve_positions.launches
    got = rk.resolve_positions(lt, qt)
    torch.cuda.synchronize()
    assert rk.resolve_positions.launches == before + 1
    want = rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))
    for g, p, w in zip(got, rk.resolve_positions_plain(lt, qt), want):
        assert torch.equal(g, p) and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_segs", [1, 1023, 1025, 262_144])
def test_kernel_matches_plain_on_card(cuda_device, n_segs):
    _assert_kernel_matches_plain(cuda_device, *_case(n_segs, n_segs))


def test_kernel_repeated_and_swept_matches_plain(cuda_device):
    """K1 at the long-document shape launched 2,000 times on one upload and
    200 times on fresh uploads, then 200 random shapes (one doc or three;
    densities, lengths and segment counts drawn, tile-edge queries): every
    launch equals the plain version on the CPU."""
    lens, qs = _case(262_144, 262_144)
    want = [w.to(cuda_device) for w in
            rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))]
    lt, qt = torch.from_numpy(lens).to(cuda_device), torch.from_numpy(qs).to(cuda_device)
    for i in range(2_200):
        if i >= 2_000:
            lt, qt = torch.from_numpy(lens).to(cuda_device), torch.from_numpy(qs).to(cuda_device)
        got = rk.resolve_positions(lt, qt)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"launch {i}"
    rng = np.random.default_rng(7)
    for i in range(200):
        D = int(rng.choice([1, 3]))
        S = int(rng.choice([262_144, 100_003, 2048 * int(rng.integers(1, 200)) + int(rng.integers(0, 4))]))
        lens = rng.integers(0, int(rng.choice([2, 9, 100])), size=(D, S)).astype(np.int32)
        lens = np.where(rng.random((D, S)) < rng.uniform(0.05, 1.0), lens, 0).astype(np.int32)
        qs = np.stack([tile_queries(row, rk.TILE, rng, n=700) for row in lens])
        got = rk.resolve_positions(torch.from_numpy(lens).to(cuda_device),
                                   torch.from_numpy(qs).to(cuda_device))
        want = rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), f"shape {i}: D={D}, S={S}"


@pytest.mark.parametrize("name", TILE_CASES)
def test_kernel_matches_plain_at_tile_edges(cuda_device, name):
    _assert_kernel_matches_plain(cuda_device, *tile_case(name, rk.TILE))


def _assert_batched_kernel_matches_plain(device, lens, qs):
    lt = torch.from_numpy(lens).to(device)
    qt = torch.from_numpy(qs).to(device)
    for g, p in zip(rk.resolve_positions(lt, qt), rk.resolve_positions_plain(lt, qt)):
        assert torch.equal(g, p)


def test_batched_kernel_matches_plain_on_card(cuda_device):
    cases = [_case(s, 3000, 64) for s in range(3)]
    _assert_batched_kernel_matches_plain(
        cuda_device, np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases])
    )


def test_batched_kernel_matches_plain_at_tile_edges(cuda_device):
    _assert_batched_kernel_matches_plain(cuda_device, *batched_tile_case(rk.TILE))


def test_seg_lane_on_card_matches_cpu(cuda_device):
    """The segment lane (K1 inside), at one and at four stacked shards, on
    the card equals the same lane on the CPU, leaf for leaf."""
    rng = np.random.default_rng(0)
    K, B, L = 2, 8, 8
    ops = np.zeros((K, B, tk.OP_FIELDS), np.int32)
    pays = np.zeros((K, B, L), np.int32)
    length = 0
    for i in range(K * B):
        k, b = divmod(i, B)
        if length > 4 and i % 3 == 2:
            p = int(rng.integers(0, length - 2))
            ops[k, b] = [tk.OpKind.REMOVE, i + 1, i % 4, i, p, p + 2, 0, 0]
        else:
            n = int(rng.integers(1, L + 1))
            ops[k, b] = [tk.OpKind.INSERT, i + 1, i % 4, i, int(rng.integers(0, length + 1)), 0, n, 0]
            pays[k, b, :n] = rng.integers(97, 123, n)
            length += n
    for n in (1, 4):  # the lane's shards stacked on one device
        out = {}
        for dev in ("cpu", "cuda"):
            st = tk.seg_shard_state(tk.init_state(256, 4, 2, 1024, 4, device=dev), n)
            st = tk.seg_stack(tk.tree_map(lambda x: x.to(dev), st))
            before = rk.resolve_positions.launches
            out[dev] = tk.apply_megastep_seg(st, ops, pays)
            if dev == "cuda":
                assert rk.resolve_positions.launches > before
        for a, b in zip(tk.leaves(out["cpu"]), tk.leaves(out["cuda"])):
            assert torch.equal(a, b.cpu())


def test_tree_megastep_and_compact_on_card_match_cpu(cuda_device):
    """A tiny nested-forest megastep (K7) and compaction (K8) on the card
    equal the same calls on the CPU, leaf for leaf, and count their
    launches on the card only."""
    from fluidframework_tpu_torch.ops import tree_kernel as nk

    rng = np.random.default_rng(1)
    K, D, B, L, N, P = 2, 4, 8, 8, 32, 64
    t = nk._TGT
    shape = (K, D, B)
    ops = np.zeros(shape + (nk.NESTED_OP_FIELDS,), np.int32)
    ops[..., 0] = rng.choice([1, 1, 2, 3, 4, 5], size=shape)
    ops[..., 1] = 1 + np.arange(K * D * B).reshape(shape)
    ops[..., 2] = rng.choice([0, 0, 1], size=shape)
    ops[..., 3] = 0
    ops[..., 4] = rng.integers(0, 3, size=shape)
    ops[..., t] = rng.integers(0, 2, size=shape)
    ops[..., t + 1] = rng.integers(0, 3, size=shape)
    ops[..., t + 2] = rng.integers(0, 3, size=shape)
    ops[..., t + 3] = rng.integers(0, 4, size=shape)
    vk = rng.integers(0, 5, size=shape)
    ops[..., t + 5] = vk
    ops[..., t + 4] = np.where((vk == nk.VKIND_STR) | (vk == nk.VKIND_F64),
                               rng.integers(0, L + 1, size=shape), rng.integers(0, 99, size=shape))
    pays = rng.integers(0, 200, size=shape + (L,)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        st = nk.batch_nested(nk.init_nested_forest(N, P, device=dev), D)
        before = (nk.apply_nested_megastep.launches, nk.compact_nested.launches)
        st = nk.apply_nested_megastep(st, torch.from_numpy(ops).to(dev),
                                      torch.from_numpy(pays).to(dev), host_ops=ops[..., :3])
        out[dev] = (st, nk.compact_nested(st))
        after = (nk.apply_nested_megastep.launches, nk.compact_nested.launches)
        assert [a - b for a, b in zip(after, before)] == ([1, 1] if dev == "cuda" else [0, 0])
    for (a_st, a_c), (b_st, b_c) in [(out["cpu"], out["cuda"])]:
        for a, b in zip(list(a_st) + list(a_c), list(b_st) + list(b_c)):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b.cpu())
    assert int(out["cpu"][0].nrow.max()) > 0


# ------------------------------------------------------------------- K9

def rebase_windows(seed, W, C):
    """Packed K9 inputs (c [W, 76], xs [W, C, 76], elig [W, C] uint8) from
    seeded random encodings: every field in its range, so collisions,
    value drops, detached removes, shared spines and dead steps occur."""
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9
    from fluidframework_tpu_torch.ops import tree_kernel as ttk

    M, PD = ttk.REBASE_MAX_MARKS, ttk.REBASE_MAX_DEPTH
    rng = np.random.default_rng(seed)

    def encs(n):
        kind = np.zeros((n, M), np.int64)
        cnt = np.zeros((n, M), np.int64)
        live = rng.integers(0, M + 1, n)
        for w in range(n):
            kind[w, :live[w]] = rng.integers(1, 5, live[w])
            cnt[w, :live[w]] = rng.integers(1, 5, live[w])
        fields = (rng.integers(0, PD + 1, n), rng.integers(-1, 3, (n, PD + 1)),
                  rng.integers(0, 4, (n, PD)), rng.integers(0, 2, (n, PD + 1)), kind, cnt,
                  (rng.random((n, M)) < 0.1) * (kind == 3), live,
                  rng.integers(0, M, (n, M)), rng.integers(0, M, (n, M)))
        return rk9.pack_enc(ttk.rebase_enc_from_numpy(fields, "cpu"))

    c = encs(W)
    xs = encs(W * C).view(W, C, rk9.ENC_WORDS)
    elig = torch.as_tensor((rng.random((W, C)) < 0.95).astype(np.uint8))
    return c, xs, elig


def window_commit(pool, rng, mixed=False):
    """One pooled commit of one field under a shared interior path:
    ``bench.py``'s microbench commit (4 one-leaf inserts at distinct
    positions of 32), or with ``mixed`` a random canonical list of skips,
    removes, inserts and value modifies."""
    from fluidframework_tpu_torch.dds.tree.changeset import (
        Commit, Insert, Modify, NodeChange, Remove, Skip, _wrap,
    )
    from fluidframework_tpu_torch.dds.tree.mark_pool import pool_commit
    from fluidframework_tpu_torch.dds.tree.schema import leaf

    marks = []
    if not mixed:
        cur = 0
        for p in sorted(int(p) for p in rng.choice(32, size=4, replace=False)):
            if p > cur:
                marks.append(Skip(p - cur))
                cur = p
            marks.append(Insert([leaf(int(rng.integers(1000)))]))
    else:
        n = int(rng.integers(0, 8))
        pos, last = 0, None
        while pos < n:
            r = rng.random()
            if r < 0.25 and last != "S" and pos < n - 1:
                k = int(rng.integers(1, n - pos))
                marks.append(Skip(k))
                pos, last = pos + k, "S"
            elif r < 0.5 and last != "R":
                k = int(rng.integers(1, n - pos + 1))
                marks.append(Remove(k))
                pos, last = pos + k, "R"
            elif r < 0.75 and last != "I":
                marks.append(Insert([leaf(int(rng.integers(99))) for _ in range(int(rng.integers(1, 3)))]))
                last = "I"
            else:
                marks.append(Modify(NodeChange(value=(int(rng.integers(9)),))))
                pos, last = pos + 1, "M"
        if rng.random() < 0.4 and last != "I":
            marks.append(Insert([leaf(7)]))
    return pool_commit(pool, Commit([_wrap([("", 0)], NodeChange(fields={"kids": marks}))]))


def commit_windows(seed, W, C, mixed=False):
    """Packed K9 inputs from ``window_commit``s encoded by ``DeviceRebaser``:
    every entry is eligible and every step engages (one shared field)."""
    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
    from fluidframework_tpu_torch.dds.tree.mark_pool import MarkPool

    rng = np.random.default_rng(seed)
    pool = MarkPool()
    reb = DeviceRebaser(pool, device="cpu")

    def row():
        while True:
            enc = reb.encode_commit(window_commit(pool, rng, mixed))
            if enc is not None:
                return enc.row

    c = torch.from_numpy(np.stack([row() for _ in range(W)]))
    xs = torch.from_numpy(np.stack([row() for _ in range(W * C)]).reshape(W, C, -1))
    return c, xs, torch.ones((W, C), dtype=torch.uint8)


# Random encodings (every field in range) and pooled commits; C across the
# kernel's staging chunks of 16 rows and not a power of two.
K9_CARD_CASES = [("random", 1, 1), ("random", 1, 64), ("random", 37, 8), ("random", 300, 3),
                 ("random", 2, 17), ("random", 3, 35), ("insert", 256, 8), ("insert", 1, 16),
                 ("mixed", 64, 19), ("mixed", 1, 256)]


def k9_case_id(case):
    """A K9 case's test id: ``W-C`` for random encodings, ``kind-W-C`` for
    commit windows."""
    kind, W, C = case
    return f"{W}-{C}" if kind == "random" else f"{kind}-{W}-{C}"


def k9_case(kind, W, C):
    if kind == "random":
        return rebase_windows(W * 1000 + C, W, C)
    return commit_windows(W * 1000 + C, W, C, mixed=kind == "mixed")


@pytest.mark.parametrize("kind,W,C", K9_CARD_CASES, ids=map(k9_case_id, K9_CARD_CASES))
def test_rebase_window_matches_plain_on_card(cuda_device, kind, W, C):
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    c, xs, elig = k9_case(kind, W, C)
    want_final, want_steps = rk9.rebase_window_plain(c, xs, elig)
    before = rk9.rebase_window.launches
    final, steps = rk9.rebase_window(c.to(cuda_device), xs.to(cuda_device), elig.to(cuda_device))
    torch.cuda.synchronize()
    assert rk9.rebase_window.launches == before + 1
    assert torch.equal(final.cpu(), want_final)
    assert torch.equal(steps.cpu(), want_steps)
    # the plain form on the card's tensors is the same function
    pf, ps = rk9.rebase_window_plain(c.to(cuda_device), xs.to(cuda_device), elig.to(cuda_device))
    assert torch.equal(pf.cpu(), want_final) and torch.equal(ps.cpu(), want_steps)


def test_rebase_window_takes_unaligned_rows_on_card(cuda_device):
    """Entry rows that do not start on 16 bytes (a view one word into a
    buffer) are copied before the kernel stages them, never misread."""
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    c, xs, elig = commit_windows(11, 5, 19, mixed=True)
    buf = torch.empty(1 + xs.numel(), dtype=torch.int32, device=cuda_device)
    view = buf[1:].view(xs.shape)
    view.copy_(xs)
    assert view.data_ptr() % 16
    got = rk9.rebase_window(c.to(cuda_device), view, elig.to(cuda_device))
    for g, w in zip(got, rk9.rebase_window_plain(c, xs, elig)):
        assert torch.equal(g.cpu(), w)


def test_rebase_window_refuses_bad_inputs_on_card(cuda_device):
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    c, xs, elig = (t.to(cuda_device) for t in rebase_windows(5, 4, 3))
    with pytest.raises(TypeError):
        rk9.rebase_window(c, xs, elig.to(torch.int32))
    with pytest.raises(ValueError):
        rk9.rebase_window(c, xs[:, :, :-1], elig)
    with pytest.raises(ValueError):
        rk9.rebase_window(c, xs, elig.cpu())


def test_kernels_on_a_card_that_is_not_current(cuda_device):
    """K1 and K9 on tensors on ``cuda:1`` while ``cuda:0`` is the current
    device equal their plain versions: each launcher launches on the
    tensors' card, with that card's stream.  Needs two cards."""
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        lens, qs = _case(7, 262_144)
        got = rk.resolve_positions(torch.from_numpy(lens).to(other), torch.from_numpy(qs).to(other))
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == 0
        for g, w in zip(got, rk.resolve_positions_plain(torch.from_numpy(lens),
                                                         torch.from_numpy(qs))):
            assert g.device == other and torch.equal(g.cpu(), w)
        c, xs, elig = k9_case("mixed", 64, 19)
        final, steps = rk9.rebase_window(c.to(other), xs.to(other), elig.to(other))
        torch.cuda.synchronize(other)
        want_final, want_steps = rk9.rebase_window_plain(c, xs, elig)
        assert torch.equal(final.cpu(), want_final) and torch.equal(steps.cpu(), want_steps)


def test_flat_forest_on_card_matches_cpu(cuda_device):
    """K11 (the flat forest and the rebase position arithmetic) on the card
    equals the same calls on the CPU, column for column and latch for
    latch, and counts one launch a call on the card only."""
    from fluidframework_tpu_torch.ops import tree_kernel as nk

    rng = np.random.default_rng(11)
    M, Q, D, N, B, P = 16, 64, 8, 32, 12, 4
    kinds = rng.integers(0, 6, (D, M)).astype(np.int32)
    counts = rng.integers(-2, 9, (D, M)).astype(np.int32)
    pos = rng.integers(-3, 40, (D, Q)).astype(np.int32)
    idx = rng.integers(-2, N + 2, (D, 2 * B)).astype(np.int32)
    vals = rng.integers(-99, 99, (D, 2 * B)).astype(np.int32)
    seqs = np.stack([rng.permutation(2 * B) + 1 for _ in range(D)]).astype(np.int32)
    ops = np.zeros((D, B, nk.FOREST_OP_FIELDS), np.int32)
    ops[..., 0] = rng.integers(-1, 6, (D, B))
    ops[..., 1] = 1 + np.arange(B)
    ops[..., 2] = rng.integers(-2, 10, (D, B))
    ops[..., 3] = rng.integers(-1, 6, (D, B))
    ops[..., 4] = rng.integers(-1, 12, (D, B))
    ops[..., 5] = rng.integers(0, 99, (D, B))
    pays = rng.integers(0, 99, (D, B, P)).astype(np.int32)
    fns = (nk.rebase_insert_positions, nk.rebase_node_positions, nk.apply_value_sets_fleet,
           nk.apply_forest_ops_fleet, nk.apply_forest_ops, nk.apply_forest_op)
    out = {}
    for dev in ("cpu", "cuda"):
        before = [f.launches for f in fns]
        chunk = nk.ChunkState(torch.zeros((D, N), dtype=torch.int32, device=dev),
                              torch.zeros((D, N), dtype=torch.int32, device=dev))
        forest = nk.batch_forest(nk.init_forest(N, device=dev), D)
        res = [nk.rebase_insert_positions(pos, kinds, counts, True, device=dev),
               *nk.rebase_node_positions(pos, kinds, counts, device=dev),
               *nk.apply_value_sets_fleet(chunk, idx, vals, seqs),
               *nk.apply_forest_ops_fleet(forest, ops, pays),
               *nk.apply_forest_ops(nk.init_forest(N, device=dev), ops[0], pays[0]),
               *nk.apply_forest_op(nk.init_forest(N, device=dev), ops[0, 0], pays[0, 0])]
        out[dev] = [r.cpu() for r in res]
        delta = [f.launches - b for f, b in zip(fns, before)]
        assert delta == ([1] * len(fns) if dev == "cuda" else [0] * len(fns)), (dev, delta)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
