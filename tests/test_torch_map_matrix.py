"""The port's SharedMap and SharedMatrix kernels (K10) against the JAX
package's, exact.

Seeded op batches (made with numpy) go through both packages on the CPU:

* map: one map and a fleet of maps, SET/DELETE/NOOP with CLEARs and keys
  outside the slot range — every state column, ``host_items`` and the
  summary JSON equal, and each package's summary restores in the other;
* matrix: one matrix and a fleet, row/column inserts and removes from one
  writer interleaved with SET_CELL storms from several writers with
  ref_seq lag, FWW set on some cells, positions outside the perspective
  and handle overflow (the ``ERR_HANDLE_RANGE`` latch) — every raw column
  (both permutation merge-trees included), ``visible_handles``,
  ``to_grid`` and the summary JSON equal, codecs in both directions.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import map_kernel as rmap
from fluidframework_tpu.ops import matrix_kernel as rmx
from fluidframework_tpu_torch.ops import map_kernel as pmap
from fluidframework_tpu_torch.ops import matrix_kernel as pmx


def _leaves(x) -> list:
    out = []
    for f in x:
        if isinstance(f, tuple):
            out += _leaves(f)
        else:
            out.append(f.numpy() if isinstance(f, torch.Tensor) else np.asarray(f))
    return out


def assert_states_equal(ref, port, what=""):
    a, b = _leaves(ref), _leaves(port)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y), (what, i)


def _json(x) -> str:
    return json.dumps(x)


# ---------------------------------------------------------------------------
# SharedMap
# ---------------------------------------------------------------------------


def map_batches(seed, n_batches, B, K, lead=()):
    """(kinds, keys, values, seqs) per batch, shaped lead + (B,): SET and
    DELETE mostly, some NOOPs and CLEARs (key -1), and keys outside
    [0, K)."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (B,)
    out, seq = [], 0
    for _ in range(n_batches):
        kinds = rng.choice([0, 1, 1, 1, 2, 2, 3], size=shape, p=[.05, .3, .25, .2, .1, .07, .03])
        keys = rng.integers(0, K, size=shape)
        keys = np.where(rng.random(shape) < 0.05, rng.choice([-2, K, K + 3], size=shape), keys)
        keys = np.where((kinds == 0) | (kinds == 3), -1, keys)
        vals = rng.integers(0, 1 << 20, size=shape)
        seqs = seq + 1 + np.arange(np.prod(shape)).reshape(shape)
        seq += int(np.prod(shape))
        out.append(tuple(a.astype(np.int32) for a in (kinds, keys, vals, seqs)))
    return out


def test_map_matches_reference():
    K = 32
    ref, port = rmap.init_state(K), pmap.init_state(K, device="cpu")
    apply_ref = jax.jit(rmap.apply_batch)
    saw_clear = False
    for batch in map_batches(0, 12, 24, K):
        saw_clear |= bool((batch[0] == rmap.MapOpKind.CLEAR).any())
        ref = apply_ref(ref, *map(jnp.asarray, batch))
        port = pmap.apply_batch(port, *batch)
        assert_states_equal(ref, port)
        assert pmap.host_items(port) == rmap.host_items(ref)
    assert saw_clear and pmap.host_items(port)
    # Codecs: byte-identical JSON, and each restores the other's summary.
    summary = pmap.state_to_summary(port)
    assert _json(summary) == _json(rmap.state_to_summary(ref))
    assert_states_equal(rmap.summary_to_state(summary), pmap.summary_to_state(summary, device="cpu"))
    back = pmap.summary_to_state(rmap.state_to_summary(ref), device="cpu")
    assert_states_equal(ref, back)
    assert_states_equal(ref, pmap.map_state_from_numpy(ref, device="cpu"))
    with pytest.raises(ValueError):
        pmap.summary_to_state(summary, max_keys=1, device="cpu")


def test_map_fleet_matches_reference():
    D, K = 6, 16
    ref = jax.tree_util.tree_map(lambda x: jnp.stack([x] * D), rmap.init_state(K))
    port = pmap.batch_state(pmap.init_state(K, device="cpu"), D)
    fleet_ref = jax.jit(rmap.apply_batch_fleet)
    for batch in map_batches(1, 8, 20, K, lead=(D,)):
        ref = fleet_ref(ref, *map(jnp.asarray, batch))
        port = pmap.apply_batch_fleet(port, *batch)
        assert_states_equal(ref, port)
    for d in range(D):
        one_ref = jax.tree_util.tree_map(lambda x: x[d], ref)
        one = pmap.MapState(*(x[d] for x in port))
        assert pmap.host_items(one) == rmap.host_items(one_ref)
        assert _json(pmap.state_to_summary(one)) == _json(rmap.state_to_summary(one_ref))
    assert pmap.apply_batch_fleet.launches == 0  # the CPU never counts


# ---------------------------------------------------------------------------
# SharedMatrix
# ---------------------------------------------------------------------------


GEOM = dict(max_rows=16, max_cols=12, max_segments=24, remove_slots=2)


def matrix_ops(seed, n_ops, seed_rows=6, seed_cols=5, writers=4, grow_past=False):
    """One matrix's sequenced ops [n_ops + 2, 8]: writer 0 seeds rows and
    columns, then SET_CELL storms from ``writers`` writers (ref_seq lagging
    up to 3 ops, some positions outside the grid, FWW on some cells) with
    writer 0's row/column inserts and removes interleaved.  ``grow_past``
    inserts rows past the handle capacity."""
    rng = np.random.default_rng(seed)
    K = pmx.MatrixOpKind
    ops = [[K.INSERT_ROWS, 1, 0, 0, 0, seed_rows, 0, 0],
           [K.INSERT_COLS, 2, 0, 1, 0, seed_cols, 0, 0]]
    rows, cols, seq = seed_rows, seed_cols, 2
    row_handles, col_handles = seed_rows, seed_cols
    for _ in range(n_ops):
        seq += 1
        ref = max(0, seq - 1 - int(rng.integers(0, 4)))
        r = rng.random()
        n = int(rng.integers(1, 3 if not grow_past else 9))
        if (r < 0.08 or (grow_past and r < 0.2)) and (
                grow_past or row_handles + n <= GEOM["max_rows"]):
            ops.append([K.INSERT_ROWS, seq, 0, seq - 1, int(rng.integers(0, rows + 1)), n, 0, 0])
            rows += n
            row_handles += n
        elif 0.08 <= r < 0.14 and col_handles + n <= GEOM["max_cols"]:
            ops.append([K.INSERT_COLS, seq, 0, seq - 1, int(rng.integers(0, cols + 1)), n, 0, 0])
            cols += n
            col_handles += n
        elif r < 0.18 and rows > 2:
            ops.append([K.REMOVE_ROWS, seq, 0, seq - 1, int(rng.integers(0, rows - 1)), 1, 0, 0])
            rows -= 1
        elif r < 0.22 and cols > 2:
            ops.append([K.REMOVE_COLS, seq, 0, seq - 1, int(rng.integers(0, cols - 1)), 1, 0, 0])
            cols -= 1
        elif r < 0.24:
            ops.append([K.NOOP, seq, 0, seq - 1, 0, 0, 0, 0])
        else:
            w = int(rng.integers(0, writers))
            ops.append([K.SET_CELL, seq, w, ref, int(rng.integers(0, rows + 1)),
                        int(rng.integers(0, cols + 1)), int(rng.integers(0, 1 << 20)),
                        int(rng.random() < 0.15)])
    return np.asarray(ops, np.int32)


def _ref_matrix_views(s):
    """Visible handles, summary JSON and, while every handle fits the grid
    (both packages' ``to_grid`` index it), the grid."""
    rows, cols = rmx.visible_handles(s.rows), rmx.visible_handles(s.cols)
    fits = int(s.next_row_handle) <= s.cell_val.shape[0]
    return (rows, cols, rmx.to_grid(s) if fits else None, _json(rmx.state_to_summary(s)))


def _port_matrix_views(s):
    rows, cols = pmx.visible_handles(s.rows), pmx.visible_handles(s.cols)
    fits = int(s.next_row_handle) <= s.cell_val.shape[0]
    return (rows, cols, pmx.to_grid(s) if fits else None, _json(pmx.state_to_summary(s)))


@pytest.mark.parametrize("grow_past", [False, True], ids=["in_range", "handle_overflow"])
def test_matrix_matches_reference(grow_past):
    ops = matrix_ops(2 + grow_past, 62, grow_past=grow_past)
    ref = rmx.init_state(**GEOM)
    port = pmx.init_state(**GEOM, device="cpu")
    apply_ref = jax.jit(rmx.apply_ops)
    for chunk in np.split(ops, 8):
        ref = apply_ref(ref, jnp.asarray(chunk))
        port = pmx.apply_ops(port, chunk)
        assert_states_equal(ref, port)
    assert _port_matrix_views(port) == _ref_matrix_views(ref)
    grid = pmx.to_grid(port) if not grow_past else _port_matrix_views(port)[2]
    assert grow_past or any(v is not None for row in grid for v in row)
    assert int(port.fww) == 1
    latched = int(port.error) & pmx.ERR_HANDLE_RANGE
    assert latched  # positions outside a lagging perspective, or overflowed handles
    if grow_past:
        assert int(port.next_row_handle) > GEOM["max_rows"]
    # Codecs both ways (the error latch is not part of a summary).
    summary = pmx.state_to_summary(port)
    back_ref = rmx.summary_to_state(summary)
    back = pmx.summary_to_state(summary, device="cpu")
    assert_states_equal(back_ref, back)
    assert _port_matrix_views(back) == _ref_matrix_views(back_ref)
    assert_states_equal(pmx.summary_to_state(rmx.state_to_summary(ref), device="cpu"), back)
    assert_states_equal(ref, pmx.matrix_state_from_numpy(ref, device="cpu"))


def test_matrix_fleet_matches_reference():
    D = 4
    ops = np.stack([matrix_ops(10 + d, 38, seed_rows=4 + d, grow_past=d == 3) for d in range(D)])
    # A kind outside [0, 5] clamps as lax.switch clamps it.
    ops[1, 9, 0] = 9
    ops[2, 11, 0] = -2
    ref = jax.tree_util.tree_map(lambda x: jnp.stack([x] * D), rmx.init_state(**GEOM))
    port = pmx.batch_state(pmx.init_state(**GEOM, device="cpu"), D)
    fleet_ref = jax.jit(rmx.apply_ops_fleet)
    for chunk in np.split(ops, 4, axis=1):
        ref = fleet_ref(ref, jnp.asarray(chunk))
        port = pmx.apply_ops_fleet(port, torch.as_tensor(chunk))
        assert_states_equal(ref, port)
    for d in range(D):
        one_ref = jax.tree_util.tree_map(lambda x: x[d], ref)
        assert _port_matrix_views(pmx.matrix_row(port, d)) == _ref_matrix_views(one_ref)
