"""The port's flat-forest programs (K11) against the JAX package's, exact.

``encode_marks``, ``rebase_insert_positions`` / ``rebase_node_positions``,
``apply_value_sets`` (and its doc-batched engine) and the ``ForestState``
ops of ``fluidframework_tpu_torch/ops/tree_kernel.py`` run on the CPU on
the same seeded numpy inputs as the reference's jnp functions (jitted, and
vmapped over docs where the reference's callers vmap them).  Every output
column, the live count and the error latch must be equal, dtype int32 —
on the edge lanes too: negative and out-of-range positions and indices,
padding lanes, overflow and range latches, kinds outside the switch, and
int32 sums that wrap.  One geometry per function so the reference
compiles once.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.tree import changeset as rcs
from fluidframework_tpu.dds.tree.schema import leaf as rleaf
from fluidframework_tpu.ops import tree_kernel as rtk
from fluidframework_tpu_torch.dds.tree import changeset as pcs
from fluidframework_tpu_torch.dds.tree.schema import leaf as pleaf
from fluidframework_tpu_torch.ops import tree_kernel as tk

M, Q = 16, 24           # marks per change, query positions
N, B, P, D = 16, 8, 4, 8  # forest capacity, ops per batch, payload width, docs
I32_MAX = 2**31 - 1

_ref_ins = {a: jax.jit(lambda p, k, c, a=a: rtk.rebase_insert_positions(p, k, c, a))
            for a in (True, False)}
_ref_node = jax.jit(rtk.rebase_node_positions)
_ref_sets = jax.jit(rtk.apply_value_sets)
_ref_op = jax.jit(rtk.apply_forest_op)
_ref_ops = jax.jit(rtk.apply_forest_ops)
_ref_fleet = jax.jit(jax.vmap(rtk.apply_forest_ops))


def rand_marks(rng: random.Random, n: int, mod) -> list:
    """A random incoming change over an n-node field, built from ``mod``'s
    mark classes (the two packages' changesets)."""
    leaf = rleaf if mod is rcs else pleaf
    marks = []
    pos = 0
    while pos < n:
        r = rng.random()
        if r < 0.35:
            k = rng.randint(1, n - pos)
            marks.append(mod.Skip(k)); pos += k
        elif r < 0.6:
            k = rng.randint(1, n - pos)
            marks.append(mod.Remove(k)); pos += k
        elif r < 0.8:
            marks.append(mod.Insert([leaf(rng.randint(0, 99)) for _ in range(rng.randint(1, 3))]))
        else:
            marks.append(mod.Modify(mod.NodeChange(value=(1,)))); pos += 1
    if rng.random() < 0.5:
        marks.append(mod.Insert([leaf(7)]))
    return marks


def raw_marks(rng: np.random.Generator):
    """Raw mark columns the encoder never writes: any kind code, negative
    counts, and counts near int32's top so the geometry's sums wrap."""
    kinds = rng.integers(-1, 8, M).astype(np.int32)
    counts = rng.integers(-4, 12, M).astype(np.int32)
    big = rng.random(M) < 0.15
    counts[big] = I32_MAX - rng.integers(0, 4, int(big.sum()))
    return kinds, counts


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32))


def eq(port, ref, what=""):
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.dtype == np.int32 and b.dtype == np.int32, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------------ marks + rebase


@pytest.mark.parametrize("seed", range(4))
def test_encode_marks_matches_reference(seed):
    for i in range(50):
        n = random.Random(seed * 1000 + i).randint(0, 10)
        rm = rand_marks(random.Random(seed * 1000 + i), n, rcs)
        pm = rand_marks(random.Random(seed * 1000 + i), n, pcs)
        if len(rm) > M:
            continue
        for got, want in zip(tk.encode_marks(pm, M), rtk.encode_marks(rm, M)):
            eq(got, want, f"seed={seed} i={i}")
    with pytest.raises(AssertionError):
        tk.encode_marks([pcs.Skip(1)] * (M + 1), M)


@pytest.mark.parametrize("a_after", [True, False])
def test_rebase_insert_positions_match_reference(a_after):
    rng = np.random.default_rng(int(a_after))
    for seed in range(120):
        if seed % 3:
            r = random.Random(seed)
            n = r.randint(0, 10)
            marks = rand_marks(r, n, pcs)
            if len(marks) > M:
                continue
            kinds, counts = tk.encode_marks(marks, M)
        else:
            kinds, counts = raw_marks(rng)
        pos = rng.integers(-3, 14, Q).astype(np.int32)
        got = tk.rebase_insert_positions(pos, kinds, counts, a_after, device="cpu")
        eq(got, _ref_ins[a_after](pos, kinds, counts), f"seed={seed}")


def test_rebase_node_positions_match_reference():
    rng = np.random.default_rng(7)
    for seed in range(120):
        if seed % 3:
            r = random.Random(seed + 10_000)
            marks = rand_marks(r, r.randint(1, 10), pcs)
            if len(marks) > M:
                continue
            kinds, counts = tk.encode_marks(marks, M)
        else:
            kinds, counts = raw_marks(rng)
        pos = rng.integers(-3, 14, Q).astype(np.int32)
        got = tk.rebase_node_positions(t(pos), t(kinds), t(counts), device="cpu")
        want = _ref_node(pos, kinds, counts)
        eq(got[0], want[0], f"seed={seed} positions")
        eq(got[1], want[1], f"seed={seed} survival")


def test_rebase_positions_match_host_algebra():
    """The port's kernel against the port's own changeset rebase, as the
    reference's tests hold the jnp kernel against its algebra."""
    for seed in range(150):
        rng = random.Random(seed)
        n = rng.randint(1, 8)
        b = rand_marks(rng, n, pcs)
        if len(b) > M:
            continue
        kinds, counts = tk.encode_marks(b, M)
        for a_after in (True, False):
            got = tk.rebase_insert_positions(np.arange(n + 1), kinds, counts, a_after,
                                             device="cpu").tolist()
            for p in range(n + 1):
                a = ([pcs.Skip(p)] if p else []) + [pcs.Insert([pleaf(-1)])]
                out, at = pcs.rebase_marks(a, b, a_after=a_after), 0
                for m in out:
                    if isinstance(m, pcs.Insert):
                        break
                    at += m.count
                assert got[p] == at, (seed, p, a_after)
        pos, live = tk.rebase_node_positions(np.arange(n), kinds, counts, device="cpu")
        for p in range(n):
            a = ([pcs.Skip(p)] if p else []) + [pcs.Modify(pcs.NodeChange(value=(42,)))]
            out, at, found = pcs.rebase_marks(a, b, a_after=True), 0, False
            for m in out:
                if isinstance(m, pcs.Modify):
                    found = True
                    break
                at += m.count
            assert bool(live[p]) == found, (seed, p)
            if found:
                assert int(pos[p]) == at, (seed, p)


def test_rebase_batched_over_docs():
    """A leading doc axis broadcasts: each row equals its one-change call."""
    rng = np.random.default_rng(3)
    kinds = np.stack([raw_marks(rng)[0] for _ in range(D)])
    counts = np.stack([raw_marks(rng)[1] for _ in range(D)])
    pos = rng.integers(-3, 14, (D, Q)).astype(np.int32)
    got = tk.rebase_insert_positions(pos, kinds, counts, True, device="cpu")
    node = tk.rebase_node_positions(pos, kinds, counts, device="cpu")
    for d in range(D):
        eq(got[d], _ref_ins[True](pos[d], kinds[d], counts[d]), f"doc {d}")
        want = _ref_node(pos[d], kinds[d], counts[d])
        eq(node[0][d], want[0]), eq(node[1][d], want[1])


# -------------------------------------------------------------- value sets


def value_batch(rng: np.random.Generator, n: int, b: int):
    """Writes over n rows: padding lanes (negative), lanes past the column
    (idx >= n), repeated rows, distinct positive seqs in shuffled order."""
    idx = rng.integers(0, n, b).astype(np.int32)
    r = rng.random(b)
    idx[r < 0.15] = -rng.integers(1, 5, int((r < 0.15).sum()))
    idx[(r >= 0.15) & (r < 0.25)] = n + rng.integers(0, 3, int(((r >= 0.15) & (r < 0.25)).sum()))
    vals = rng.integers(-1000, 1000, b).astype(np.int32)
    seqs = rng.permutation(np.arange(1, b + 1)).astype(np.int32)
    return idx, vals, seqs


def test_apply_value_sets_matches_reference():
    rng = np.random.default_rng(11)
    for seed in range(60):
        base = rng.integers(-50, 50, N).astype(np.int32)
        vseq = rng.integers(0, 3, N).astype(np.int32)
        idx, vals, seqs = value_batch(rng, N, 2 * B)
        got = tk.apply_value_sets(tk.ChunkState(t(base), t(vseq)), idx, vals, seqs)
        want = _ref_sets(rtk.ChunkState(jnp.asarray(base), jnp.asarray(vseq)), idx, vals, seqs)
        eq(got.values, want.values, f"seed={seed} values")
        eq(got.val_seq, want.val_seq, f"seed={seed} val_seq")
    s = tk.init_chunk(np.arange(5), device="cpu")
    eq(s.values, rtk.init_chunk(np.arange(5)).values)
    eq(s.val_seq, rtk.init_chunk(np.arange(5)).val_seq)


def test_batched_value_engine_matches_reference():
    rng = np.random.default_rng(12)
    base = rng.integers(0, 100, (D, N)).astype(np.int32)
    cols = [value_batch(rng, N, 2 * B) for _ in range(D)]
    idx, vals, seqs = (np.stack(c) for c in zip(*cols))
    got = tk.batched_value_engine(D)(tk.ChunkState(t(base), t(np.zeros_like(base))),
                                     idx, vals, seqs)
    want = rtk.batched_value_engine(D)(
        rtk.ChunkState(jnp.asarray(base), jnp.zeros((D, N), jnp.int32)), idx, vals, seqs)
    eq(got.values, want.values)
    eq(got.val_seq, want.val_seq)
    with pytest.raises(ValueError):
        tk.batched_value_engine(D + 1)(tk.ChunkState(t(base), t(base)), idx, vals, seqs)


# ------------------------------------------------------------------ forest


def forest_ops(rng: np.random.Generator, b: int, edge: bool):
    """``b`` op rows and payloads.  ``edge``: any kind (outside [0, 4]
    too), positions and counts off either end, overflowing inserts;
    otherwise mostly valid ops against a host count of the live nodes."""
    ops = np.zeros((b, tk.FOREST_OP_FIELDS), np.int32)
    pay = rng.integers(-99, 99, (b, P)).astype(np.int32)
    n = 0
    for i in range(b):
        if edge:
            ops[i, :6] = [rng.integers(-1, 7), i + 1, rng.integers(-N - 2, N + 3),
                          rng.integers(-3, 8), rng.integers(-3, N + 3), rng.integers(-9, 9)]
            if rng.random() < 0.1:
                ops[i, 2:4] = [I32_MAX - 1, 3]  # pos + count wraps
            continue
        kind = rng.choice([1, 1, 2, 3, 4]) if n else 1
        pos = int(rng.integers(0, n + 1))
        if kind == 1:
            ops[i, :4] = [kind, i + 1, pos, rng.integers(1, P + 1)]
            n = min(N, n + int(ops[i, 3])) if n + ops[i, 3] <= N else n
        elif kind == 3:
            ops[i, :6] = [kind, i + 1, min(pos, n - 1), 0, 0, rng.integers(0, 99)]
        else:
            pos = min(pos, n - 1)
            cnt = int(rng.integers(1, n - pos + 1))
            ops[i, :5] = [kind, i + 1, pos, cnt, rng.integers(0, n + 1)]
            if kind == 2:
                n -= cnt
    return ops, pay


def ref_forest(vals, vseq, nnode, err):
    return rtk.ForestState(jnp.asarray(vals), jnp.asarray(vseq),
                           jnp.asarray(nnode), jnp.asarray(err))


def port_forest(vals, vseq, nnode, err):
    return tk.ForestState(t(vals), t(vseq), t(nnode), t(err))


def forest_eq(port, ref, what):
    for name in tk.ForestState._fields:
        eq(getattr(port, name), getattr(ref, name), f"{what} {name}")


def random_forest(rng):
    """A start state with junk past the live count (padding remnants) and
    a live count anywhere in [0, N]."""
    return (rng.integers(-9, 99, N).astype(np.int32), rng.integers(0, 9, N).astype(np.int32),
            np.int32(rng.integers(0, N + 1)), np.int32(rng.integers(0, 2)))


@pytest.mark.parametrize("edge", [False, True])
def test_apply_forest_ops_matches_reference(edge):
    rng = np.random.default_rng(21 + edge)
    for seed in range(40):
        start = random_forest(rng) if seed % 2 else (
            np.zeros(N, np.int32), np.zeros(N, np.int32), np.int32(0), np.int32(0))
        ops, pay = forest_ops(rng, B, edge)
        got = tk.apply_forest_ops(port_forest(*start), ops, pay)
        forest_eq(got, _ref_ops(ref_forest(*start), ops, pay), f"seed={seed}")
        one = tk.apply_forest_op(port_forest(*start), ops[0], pay[0])
        forest_eq(one, _ref_op(ref_forest(*start), ops[0], pay[0]), f"seed={seed} op0")


def test_forest_latches_each_failure():
    """One op per failure path, each against the reference: an overflowing
    insert latches both bits when it is also off the end, a range error
    leaves the columns as they were, and SET at a negative position writes
    the slot the reference's wrap names."""
    base = (np.arange(N, dtype=np.int32) + 100, np.arange(N, dtype=np.int32),
            np.int32(6), np.int32(0))
    cases = [
        [1, 9, 3, N, 0, 0],        # insert: overflow
        [1, 9, 7, 2, 0, 0],        # insert: past the end
        [1, 9, 8, N, 0, 0],        # insert: both
        [2, 9, 4, 3, 0, 0],        # remove: past the end
        [2, 9, 2, -2, 0, 0],       # remove: negative count grows the count
        [3, 9, 6, 0, 0, 5],        # set: pos == n
        [3, 9, -1, 0, 0, 5],       # set: pos -1 writes the last slot
        [3, 9, -N, 0, 0, 5],       # set: wraps to slot 0
        [3, 9, -N - 1, 0, 0, 5],   # set: still negative, dropped
        [4, 9, 1, 2, 7, 0],        # move: dst past the end
        [4, 9, 5, 2, 0, 0],        # move: range past the end
        [4, 9, 1, 2, 5, 0],        # move: right
        [4, 9, 3, 2, 0, 0],        # move: left
        [-1, 9, 0, 1, 0, 0],       # kind below the switch: NOOP
        [7, 9, 1, 1, 4, 0],        # kind above the switch: MOVE
        [1, 9, I32_MAX, 2, 0, 0],  # insert: pos + count wraps
    ]
    pay = np.arange(P, dtype=np.int32) + 50
    for row in cases:
        op = np.zeros(tk.FOREST_OP_FIELDS, np.int32)
        op[:6] = row
        got = tk.apply_forest_op(port_forest(*base), op, pay)
        forest_eq(got, _ref_op(ref_forest(*base), op, pay), f"op {row}")


def test_apply_forest_ops_fleet_matches_vmapped_reference():
    rng = np.random.default_rng(31)
    starts = [random_forest(rng) for _ in range(D)]
    batches = [forest_ops(rng, B, d % 2 == 1) for d in range(D)]
    cols = [np.stack(c) for c in zip(*starts)]
    ops, pay = (np.stack(c) for c in zip(*batches))
    got = tk.apply_forest_ops_fleet(port_forest(*cols), ops, pay)
    forest_eq(got, _ref_fleet(ref_forest(*cols), ops, pay), "fleet")
    for d in range(D):
        one = tk.apply_forest_ops(port_forest(*starts[d]), ops[d], pay[d])
        for name in tk.ForestState._fields:
            eq(getattr(one, name), getattr(got, name)[d], f"doc {d} {name}")


def test_dry_run_case_over_docs():
    """The reference's multichip dry run: insert three, move one, set one,
    over 8 docs -> [99, 30, 10]."""
    proto = tk.init_forest(16, device="cpu")
    s = tk.batch_forest(proto, 8)
    ops = np.zeros((8, 3, tk.FOREST_OP_FIELDS), np.int32)
    pay = np.zeros((8, 3, 8), np.int32)
    ops[:, 0] = [tk.ForestOpKind.INSERT, 1, 0, 3, 0, 0, 0, 0]
    pay[:, 0, :3] = [10, 20, 30]
    ops[:, 1] = [tk.ForestOpKind.MOVE, 2, 0, 1, 3, 0, 0, 0]
    ops[:, 2] = [tk.ForestOpKind.SET, 3, 0, 0, 0, 99, 0, 0]
    out = tk.apply_forest_ops_fleet(s, ops, pay)
    assert int(out.error.sum()) == 0
    for d in range(8):
        assert list(tk.forest_values(tk.ForestState(*(x[d] for x in out)))) == [99, 30, 10]
    ref = rtk.init_forest(16)
    for name in tk.ForestState._fields:
        eq(getattr(proto, name), getattr(ref, name), name)


def test_forest_move_directions():
    """The reference engine test's moves (tests/test_tree_batch_engine.py)."""
    s = tk.init_forest(16, device="cpu")
    op = np.array([tk.ForestOpKind.INSERT, 1, 0, 5, 0, 0, 0, 0], np.int32)
    pay = np.array([10, 11, 12, 13, 14, 0, 0, 0], np.int32)
    s = tk.apply_forest_op(s, op, pay)
    s = tk.apply_forest_op(s, np.array([tk.ForestOpKind.MOVE, 2, 0, 2, 4, 0, 0, 0], np.int32), pay)
    assert list(tk.forest_values(s)) == [12, 13, 10, 11, 14]
    s = tk.apply_forest_op(s, np.array([tk.ForestOpKind.MOVE, 3, 3, 2, 1, 0, 0, 0], np.int32), pay)
    assert list(tk.forest_values(s)) == [12, 11, 14, 13, 10]


def test_entry_points_ask_for_the_card_and_count_only_there():
    """The default device is the card: without one every constructor and
    rebase entry point raises.  CPU runs count no launch."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: tk.init_forest(4), lambda: tk.init_chunk(np.arange(3)),
                 lambda: tk.rebase_insert_positions([0], [1], [1], True),
                 lambda: tk.rebase_node_positions([0], [1], [1])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    fns = (tk.rebase_insert_positions, tk.rebase_node_positions, tk.apply_value_sets,
           tk.apply_value_sets_fleet, tk.apply_forest_op, tk.apply_forest_ops,
           tk.apply_forest_ops_fleet)
    before = [f.launches for f in fns]
    test_dry_run_case_over_docs()
    tk.rebase_node_positions([0], [1], [1], device="cpu")
    assert [f.launches for f in fns] == before
