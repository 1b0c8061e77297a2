"""The PyTorch port's merge-tree fleet program against the JAX package.

Same seeded op rings into ``apply_megastep`` and ``set_min_seq`` +
``compact`` of both packages; after every megastep and every compact the
FULL raw state columns (padding remnants included) and the per-doc error
latch must be equal (tolerance 0: everything is int32).  Traces: the
multi-writer palette of tests/test_dispatch_backends.py ``make_trace``
(multi-chunk inserts, removes, annotates, sided obliterates, pending
inserts and acks; poison ops latch ERR_POS_RANGE) and the four-writer
trace of tests/test_segment_parallel.py, once at a geometry that never
overflows and once at one that latches ERR_SEG_OVERFLOW,
ERR_TEXT_OVERFLOW and ERR_OB_OVERFLOW.

The reference programs are compiled at geometries no other test file
uses: worker processes share the persistent compile cache, and two
workers compiling one program at once is a hazard this file should not
add to.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.models.doc_batch_engine import _fleet_compact_body
from fluidframework_tpu.ops import mergetree_kernel as mk
from fluidframework_tpu_torch.models.doc_batch_engine import (
    _fleet_compact_body as port_compact_body,
)
from fluidframework_tpu_torch.ops import mergetree_kernel as tk

from test_dispatch_backends import make_trace
from test_segment_parallel import four_writer_trace


def _names(state) -> list[str]:
    out = []
    for f in mk.DocState._fields:
        v = getattr(state, f)
        out += [f"{f}[{i}]" for i in range(len(v))] if isinstance(v, tuple) else [f]
    return out


def assert_states_equal(ref, port, tag: str) -> None:
    """Every leaf of a JAX DocState equals the port's, byte for byte."""
    assert tuple(port._fields) == tuple(mk.DocState._fields)
    ref_leaves = jax.tree.leaves(ref)
    port_leaves = tk.leaves(port)
    assert len(ref_leaves) == len(port_leaves)
    for name, x, y in zip(_names(ref), ref_leaves, port_leaves):
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        x = np.asarray(x)
        assert y.dtype == np.int32, f"{tag}: {name} is {y.dtype}"
        assert x.shape == y.shape and np.array_equal(x, y), f"{tag}: {name} diverged"


def _fleets(D, S, R, P, T, OB):
    proto = mk.init_state(S, R, P, T, OB)
    ref = jax.tree.map(lambda x: jnp.broadcast_to(x, (D,) + x.shape), proto)
    port = tk.batch_state(tk.init_state(S, R, P, T, OB, device="cpu"), D)
    return ref, port


_ref_megastep = jax.jit(mk.apply_megastep)
_ref_compact = jax.jit(_fleet_compact_body)


@pytest.mark.parametrize(
    "seed,S,subset_fraction",
    [
        (0, 40, tk.SUBSET_FRACTION), (3, 40, tk.SUBSET_FRACTION), (0, 40, 0),
        (0, 40, 10**9), (4, 24, tk.SUBSET_FRACTION), (5, 24, tk.SUBSET_FRACTION),
    ],
    ids=["seed0", "seed3", "seed0-gathered", "seed0-masked", "seed4-S24", "seed5-S24"],
)
def test_megastep_and_compact_match_reference(seed, S, subset_fraction, monkeypatch):
    """Default branch routing, and every branch forced onto gathered rows
    (fraction 0) or forced masked over the whole batch (fraction 1e9)."""
    monkeypatch.setattr(tk, "SUBSET_FRACTION", subset_fraction)
    D, K, B, L = 8, 3, 8, 6
    ref, port = _fleets(D, S, 3, 2, 320, 4)
    assert_states_equal(ref, port, "init")
    rings, seqs = make_trace(seed, D, K, B, L, n_rings=5)
    for i, (ops, pays) in enumerate(rings):
        ref = _ref_megastep(ref, jnp.asarray(ops), jnp.asarray(pays))
        port = tk.apply_megastep(port, ops, pays)
        assert_states_equal(ref, port, f"seed {seed} ring {i}")
        mins = np.array([max(0, s - 7 - i) for s in seqs], np.int32)
        ref = _ref_compact(ref, jnp.asarray(mins))
        port = port_compact_body(port, mins)
        assert_states_equal(ref, port, f"seed {seed} ring {i} compact")
    errs = port.error.numpy()
    assert (errs & mk.ERR_POS_RANGE).any() and (errs & mk.ERR_SEG_OVERFLOW).any()


def _four_writer_rings(D, K=7, B=16):
    traces = [four_writer_trace(seed) for seed in range(D)]
    ops = np.stack([t[0] for t in traces]).reshape(D, K, B, mk.OP_FIELDS)
    pays = np.stack([t[1] for t in traces]).reshape(D, K, B, -1)
    return ops.transpose(1, 0, 2, 3).copy(), pays.transpose(1, 0, 2, 3).copy()


@pytest.mark.parametrize(
    "geom,bits",
    [
        ((512, 8192, 16), 0),
        ((24, 160, 2), mk.ERR_SEG_OVERFLOW | mk.ERR_TEXT_OVERFLOW | mk.ERR_OB_OVERFLOW),
    ],
    ids=["clean", "overflow"],
)
def test_four_writer_fleet_matches_reference(geom, bits):
    S, T, OB = geom
    D = 6
    ref, port = _fleets(D, S, 4, 4, T, OB)
    ops, pays = _four_writer_rings(D)
    ref = jax.jit(mk.apply_megastep)(ref, jnp.asarray(ops), jnp.asarray(pays))
    port = tk.apply_megastep(port, ops, pays)
    assert_states_equal(ref, port, f"four-writer {geom}")
    errs = np.bitwise_or.reduce(port.error.numpy())
    assert (errs & bits) == bits
    assert bits or not errs
    mins = np.full((D,), 30, np.int32)
    ref = jax.jit(_fleet_compact_body)(ref, jnp.asarray(mins))
    port = port_compact_body(port, mins)
    assert_states_equal(ref, port, f"four-writer {geom} compact")


def test_apply_ops_matches_reference_single_doc():
    """The single-lane spine (apply_ops over one doc, as a D=1 batch)."""
    ops, pays = four_writer_trace(1)
    ref = jax.jit(mk.apply_ops)(
        mk.init_state(480, 4, 4, 8192, 16), jnp.asarray(ops), jnp.asarray(pays)
    )
    port = tk.apply_ops(
        tk.batch_state(tk.init_state(480, 4, 4, 8192, 16, device="cpu"), 1),
        ops[None], pays[None],
    )
    assert_states_equal(ref, tk.doc_row(port, 0), "apply_ops")
    assert tk.visible_text(tk.doc_row(port, 0)) == mk.visible_text(ref)
    assert tk.annotations(tk.doc_row(port, 0)) == mk.annotations(ref)
    assert tk.visible_length(tk.doc_row(port, 0)) == mk.visible_length(ref)
    assert tk.canonical_doc(tk.doc_row(port, 0)).keys() == mk.canonical_doc(ref).keys()


def test_apply_does_not_mutate_its_input():
    port = tk.batch_state(tk.init_state(64, 2, 2, 256, 4, device="cpu"), 2)
    before = [x.clone() for x in tk.leaves(port)]
    rings, _ = make_trace(2, 2, 2, 4, 6, n_rings=1)
    tk.apply_megastep(port, *rings[0])
    assert all(torch.equal(a, b) for a, b in zip(before, tk.leaves(port)))


def test_init_state_matches_reference():
    assert_states_equal(mk.init_state(16, 2, 3, 64, 5),
                        tk.init_state(16, 2, 3, 64, 5, device="cpu"), "init_state")


def test_encoders_match_reference():
    rng = np.random.default_rng(3)
    texts = ["", "a", "hello world", "x" * 17, "é中\U0001f600ab"]
    pos = rng.integers(0, 50, len(texts))
    keys = rng.integers(1, 99, len(texts))
    clients = rng.integers(0, 4, len(texts))
    refs = rng.integers(0, 9, len(texts))
    for a, b in zip(
        mk.encode_insert_batch(pos, texts, keys, clients, refs, 4),
        tk.encode_insert_batch(pos, texts, keys, clients, refs, 4),
    ):
        np.testing.assert_array_equal(a, b)
    for t in texts:
        for (oa, pa), (ob, pb) in zip(
            mk.encode_insert(3, t, 7, 1, 2, 4), tk.encode_insert(3, t, 7, 1, 2, 4)
        ):
            np.testing.assert_array_equal(oa, ob)
            np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(
        mk.encode_obliterate(1, 0, 5, 1, 9, 2, 4), tk.encode_obliterate(1, 0, 5, 1, 9, 2, 4)
    )
    np.testing.assert_array_equal(mk.make_noop(), tk.make_noop())


def test_primitives_follow_jnp_rules():
    """The torch forms of jnp's first-hit argmax, clamped gather and
    shift-right used by every branch."""
    rng = np.random.default_rng(0)
    masks = rng.random((5, 9)) < 0.2
    masks[0] = False
    got = tk._first_true(torch.from_numpy(masks), 7).numpy()
    want = [int(np.argmax(m)) if m.any() else 7 for m in masks]
    assert list(got) == want
    vals = rng.integers(-3, 3, (5, 9)).astype(np.int32)
    assert list(tk._argmax_first(torch.from_numpy(vals)).numpy()) == list(np.argmax(vals, 1))
    assert list(tk._argmin_first(torch.from_numpy(vals)).numpy()) == list(np.argmin(vals, 1))
    arr = torch.arange(20, dtype=torch.int32).reshape(2, 10)
    k = torch.tensor([12, -4], dtype=torch.int32)
    assert tk._take(arr, k).tolist() == [9, 10]
    shifted = tk._shift_right(
        arr, torch.tensor([3, 0], dtype=torch.int32),
        torch.tensor([-1, -2], dtype=torch.int32), torch.tensor([True, False]),
    )
    ref = mk._shift_right(jnp.arange(10, dtype=jnp.int32), 3, -1)
    assert shifted[0].tolist() == np.asarray(ref).tolist()
    assert torch.equal(shifted[1], arr[1])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.init_state(8, 1, 1, 16, 2)
