"""The port's nested-forest programs against the JAX package's, exact.

K7 (``apply_nested_op`` / ``apply_nested_ops`` / ``apply_nested_megastep``)
and K8 (``compact_nested``) of ``fluidframework_tpu_torch/ops/tree_kernel.py``
run on the CPU on the same seeded numpy rings as the reference's jnp
functions (vmapped over docs as the reference engine runs them); every
leaf — padding remnants, the word pool and the error latch included — must
be equal, dtype int32.  One small geometry (N=32 rows, P=64 pool words,
D=8 docs, B=8 ops, L=8 payload words) so the reference compiles once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_kernel as rtk
from fluidframework_tpu_torch.ops import tree_kernel as tk

N, P, D, B, L = 32, 64, 8, 8, 8

_ref_ops = jax.jit(jax.vmap(rtk.apply_nested_ops))
_ref_op = jax.jit(jax.vmap(rtk.apply_nested_op))
_ref_mega = jax.jit(rtk.apply_nested_megastep)
_ref_compact = jax.jit(jax.vmap(rtk.compact_nested))


def ref_fleet():
    proto = rtk.init_nested_forest(N, P)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (D,) + x.shape), proto)


def port_fleet():
    return tk.batch_nested(tk.init_nested_forest(N, P, device="cpu"), D)


def assert_forests_equal(ref, port, what=""):
    for name, x, y in zip(tk.NestedForestState._fields, ref, port):
        x = np.asarray(x)
        y = y.numpy()
        assert x.dtype == np.int32 and y.dtype == np.int32, (what, name, x.dtype, y.dtype)
        assert np.array_equal(x, y), (what, name, np.argwhere(x != y)[:5].tolist())


KINDS = (0, 1, 1, 1, 2, 3, 3, 4, 5, -1, 6, 9)  # NOOP..REPLACE_FIELD and out of range


def ring(rng, shape, kinds=KINDS):
    """A seeded op ring ``shape + (NESTED_OP_FIELDS,)`` whose ops mostly
    resolve (depths 0-2 over small field ids and indices, small positions
    and counts) and often fail: bad positions, unresolved paths, node and
    pool overflow; pooled STR/F64 values carry a word count in 0..L,
    inline INT/BOOL/NONE a value."""
    t = tk._TGT
    ops = np.zeros(shape + (tk.NESTED_OP_FIELDS,), np.int32)
    pays = rng.integers(-50, 200, size=shape + (L,)).astype(np.int32)
    ops[..., 0] = rng.choice(kinds, size=shape)
    ops[..., 1] = 1 + np.arange(int(np.prod(shape))).reshape(shape)
    ops[..., 2] = rng.choice([0, 0, 0, 1, 1, 2], size=shape)
    for k in range(tk.MAX_PATH):
        ops[..., 3 + 2 * k] = rng.integers(0, 2, size=shape)
        ops[..., 4 + 2 * k] = rng.integers(0, 3, size=shape)
    ops[..., t] = rng.integers(0, 2, size=shape)
    ops[..., t + 1] = rng.integers(0, 4, size=shape)
    ops[..., t + 2] = rng.integers(0, 4, size=shape)
    ops[..., t + 3] = rng.integers(0, 5, size=shape)
    vk = rng.integers(0, 5, size=shape)
    ops[..., t + 5] = vk
    pooled = (vk == tk.VKIND_STR) | (vk == tk.VKIND_F64)
    ops[..., t + 4] = np.where(pooled, rng.integers(0, L + 1, size=shape),
                               rng.integers(-9, 99, size=shape))
    ops[..., t + 6] = rng.integers(0, 3, size=shape)
    return ops, pays


def test_init_and_state_transfer():
    """Both packages start from the same forest: the port's state made
    from the reference's leaves (``nested_state_from_numpy``) after a
    reference ring, then one more ring through each."""
    ref = ref_fleet()
    assert_forests_equal(ref, port_fleet(), "init")
    rng = np.random.default_rng(4)
    ops, pays = ring(rng, (D, B))
    ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
    port = tk.nested_state_from_numpy([np.asarray(x) for x in ref], device="cpu")
    assert_forests_equal(ref, port, "from numpy")
    ops, pays = ring(rng, (D, B))
    ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
    port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
    assert_forests_equal(ref, port, "after")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_ops_match_reference(seed):
    """Several [D, B] rings in a row (the reference engine's K=1 path):
    state, pool and error latch equal after each."""
    rng = np.random.default_rng(seed)
    ref, port = ref_fleet(), port_fleet()
    for it in range(6):
        ops, pays = ring(rng, (D, B))
        ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
        assert_forests_equal(ref, port, f"ring {it}")
    assert np.asarray(ref.error).any(), "the rings never failed an op"


@pytest.mark.parametrize("K", [1, 4])
def test_k7_megastep_matches_reference(K):
    rng = np.random.default_rng(10 + K)
    ref, port = ref_fleet(), port_fleet()
    for it in range(3):
        ops, pays = ring(rng, (K, D, B))
        ref = _ref_mega(ref, jnp.asarray(ops), jnp.asarray(pays))
        # The host ring as numpy, as the engine passes it.
        port = tk.apply_nested_megastep(port, torch.from_numpy(ops), torch.from_numpy(pays),
                                        host_ops=ops[..., :3])
        assert_forests_equal(ref, port, f"megastep {it}")


@pytest.mark.parametrize("route", ["masked", "gathered"])
def test_k7_branch_routes_agree(route, monkeypatch):
    """Every kind's pass run masked over the batch, or on the gathered rows
    of the docs holding it, gives the reference's state."""
    monkeypatch.setattr(tk, "SUBSET_FRACTION", 10**6 if route == "masked" else 0)
    rng = np.random.default_rng(21)
    ref, port = ref_fleet(), port_fleet()
    for it in range(4):
        ops, pays = ring(rng, (D, B))
        ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
        assert_forests_equal(ref, port, f"{route} {it}")


def test_out_of_range_kinds_clamp_like_lax_switch():
    """Kinds below 0 run as NOOP and above 5 as REPLACE_FIELD."""
    rng = np.random.default_rng(3)
    ref, port = ref_fleet(), port_fleet()
    for it, kinds in enumerate(((1, 1, 3), (-7, -1, 6, 9, 1), (6, 100, 2, 4))):
        ops, pays = ring(rng, (D, B), kinds=kinds)
        ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
        assert_forests_equal(ref, port, f"kinds {kinds}")


def _op(kind, seq=1, steps=(), fld=0, pos=0, count=0, dst=0, value=0, vkind=0, ntype=0):
    t = tk._TGT
    op = np.zeros((tk.NESTED_OP_FIELDS,), np.int32)
    op[0], op[1], op[2] = kind, seq, len(steps)
    for k, (f, i) in enumerate(steps):
        op[3 + 2 * k], op[4 + 2 * k] = f, i
    op[t:t + 7] = [fld, pos, count, dst, value, vkind, ntype]
    return op


def _words(s):
    pay = np.zeros((L,), np.int32)
    pay[:len(s)] = [ord(c) for c in s]
    return pay


def test_failures_latch_and_leave_the_state():
    """A bad position, an unresolved path, node overflow and pool
    overflow each OR their bit into ``error`` and leave every other
    column, the pool and both watermarks as they were; pooled STR/F64 and
    inline INT/BOOL values round-trip through ``nested_to_json``."""
    K = tk.NestedOpKind
    f64 = tk.encode_pooled_words(2.5)[2]
    seeds = [
        (_op(K.INSERT, pos=0, count=1, value=3, vkind=tk.VKIND_STR, ntype=1), _words("abc")),
        (_op(K.INSERT, pos=1, count=1, value=2, vkind=tk.VKIND_F64, ntype=2),
         np.array(f64 + [0] * (L - 2), np.int32)),
        (_op(K.INSERT, pos=2, count=3, vkind=tk.VKIND_INT), np.array([7, -8, 9] + [0] * (L - 3), np.int32)),
        (_op(K.INSERT, pos=0, count=1, vkind=tk.VKIND_BOOL, ntype=3), np.array([1] + [0] * (L - 1), np.int32)),
        (_op(K.SET, steps=(), pos=0, value=5, vkind=tk.VKIND_STR), _words("hello")),
        (_op(K.INSERT, steps=((0, 1),), fld=1, pos=0, count=2, vkind=tk.VKIND_INT), np.arange(L, dtype=np.int32)),
    ]
    failing = [
        (_op(K.INSERT, pos=99, count=1, vkind=tk.VKIND_INT), np.zeros(L, np.int32)),       # bad pos
        (_op(K.REMOVE, steps=((0, 40),), fld=1, pos=0, count=1), np.zeros(L, np.int32)),  # no parent
        (_op(K.SET, pos=77, value=1, vkind=tk.VKIND_INT), np.zeros(L, np.int32)),          # no row
        (_op(K.MOVE, pos=0, count=2, dst=50), np.zeros(L, np.int32)),                      # bad dst
        (_op(K.INSERT, pos=0, count=N, vkind=tk.VKIND_INT), np.zeros(L, np.int32)),        # rows
        (_op(K.INSERT, pos=0, count=1, value=P, vkind=tk.VKIND_STR), _words("x" * L)),    # pool
        (_op(K.SET, pos=0, value=P, vkind=tk.VKIND_STR), _words("y" * L)),                 # pool
        (_op(K.REPLACE_FIELD, steps=((0, 9),), fld=2, count=1, vkind=tk.VKIND_INT),
         np.zeros(L, np.int32)),                                                           # no parent
    ]
    ref, port = ref_fleet(), port_fleet()
    rows = np.zeros((D, len(seeds), tk.NESTED_OP_FIELDS), np.int32)
    rpay = np.zeros((D, len(seeds), L), np.int32)
    for j, (op, pay) in enumerate(seeds):
        rows[:, j], rpay[:, j] = op, pay
    ref = _ref_ops(ref, jnp.asarray(rows), jnp.asarray(rpay))
    port = tk.apply_nested_ops(port, torch.from_numpy(rows), torch.from_numpy(rpay))
    assert_forests_equal(ref, port, "seeded")
    names = ({0: "", 1: "kids", 2: "meta"}, {0: "n", 1: "s", 2: "f", 3: "b"})
    one = tk.tree_map(lambda x: x[0], port)
    got = tk.nested_to_json(one, *names)
    assert got == rtk.nested_to_json(jax.tree.map(lambda x: x[0], ref), *names)
    # The SET at index 0 overwrote the BOOL inserted there last.
    assert [n.get("v") for n in got] == ["hello", "abc", 2.5, 7, -8, 9]
    before = port
    # Doc d runs failing op d (one per doc), a NOOP elsewhere.
    fops = np.zeros((D, 1, tk.NESTED_OP_FIELDS), np.int32)
    fpay = np.zeros((D, 1, L), np.int32)
    for d, (op, pay) in enumerate(failing):
        fops[d, 0], fpay[d, 0] = op, pay
    ref = _ref_ops(ref, jnp.asarray(fops), jnp.asarray(fpay))
    port = tk.apply_nested_ops(port, torch.from_numpy(fops), torch.from_numpy(fpay))
    assert_forests_equal(ref, port, "failing")
    err = port.error.numpy()
    assert err.tolist() == [2, 2, 2, 2, 1, 4, 4, 2]
    for name in tk.NestedForestState._fields[:-1]:
        assert torch.equal(getattr(before, name), getattr(port, name)), name


def test_apply_nested_op_single():
    rng = np.random.default_rng(5)
    ref, port = ref_fleet(), port_fleet()
    for it in range(12):
        ops, pays = ring(rng, (D,))
        ref = _ref_op(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_nested_op(port, torch.from_numpy(ops), torch.from_numpy(pays))
        assert_forests_equal(ref, port, f"op {it}")


def test_k8_compact_after_churn():
    """Insert/remove/replace churn with pooled values, then compaction:
    live rows packed with their parents remapped and the pool's live spans
    packed; and applying more ops after it stays equal."""
    rng = np.random.default_rng(8)
    churn = (1, 1, 1, 2, 2, 3, 5)
    ref, port = ref_fleet(), port_fleet()
    for it in range(5):
        ops, pays = ring(rng, (D, B), kinds=churn)
        ref = _ref_ops(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
        if it % 2 == 1:
            assert (port.alive.sum(-1) < port.nrow).any(), "no dead rows to compact"
            ref = _ref_compact(ref)
            port = tk.compact_nested(port)
            assert_forests_equal(ref, port, f"compact {it}")
    assert_forests_equal(ref, port, "after")


def test_compact_leaves_the_input_alone():
    rng = np.random.default_rng(9)
    port = port_fleet()
    ops, pays = ring(rng, (D, B), kinds=(1, 2, 3))
    port = tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
    copy = tk.tree_map(torch.clone, port)
    tk.compact_nested(port)
    tk.apply_nested_ops(port, torch.from_numpy(ops), torch.from_numpy(pays))
    for a, b in zip(copy, port):
        assert torch.equal(a, b)


@pytest.mark.parametrize("value", [None, True, False, 0, -5, 2**31 - 1, -(2**31), 0.1,
                                   -2.5e-308, 1.7976931348623157e308, "", "héllo", 2**31, {}])
def test_pooled_words_codec(value):
    try:
        want = rtk.encode_pooled_words(value)
    except ValueError:
        with pytest.raises(ValueError):
            tk.encode_pooled_words(value)
        return
    got = tk.encode_pooled_words(value)
    assert got == want
    vk, val, words = got
    pool = np.asarray(words or [0], np.int32)
    off, vlen = (0, val) if words is not None else (val, 0)
    dec = tk.decode_pooled_value(vk, off if words is not None else val, vlen, pool)
    assert repr(dec) == repr(rtk.decode_pooled_value(vk, off if words is not None else val, vlen, pool))
