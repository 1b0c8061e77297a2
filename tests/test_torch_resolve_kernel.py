"""K1 (position resolution) in the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs on CPU tensors) is held
exactly against ``resolve_positions_reference`` and the Pallas kernel in
interpret mode, on the sizes of tests/test_pallas_kernels.py: negative
and out-of-range queries, all-invisible lengths, segment counts that are
not a multiple of the block, the batched [D, S] form, and the edges of
the two-level search's tiles (cases shared with the card tests).  The CUDA
kernel itself is tested on the card by tests/test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops.pallas_kernels import (
    resolve_positions_pallas,
    resolve_positions_reference,
)
from fluidframework_tpu_torch.ops import resolve_kernel as rk

from test_torch_cuda_kernels import TILE_CASES, batched_tile_case, tile_case


def random_case(rng, n_segs, n_queries, max_len=9, vis_p=0.7):
    lens = rng.integers(0, max_len, size=n_segs).astype(np.int32)
    lens = np.where(rng.random(n_segs) < vis_p, lens, 0).astype(np.int32)
    total = int(lens.sum())
    qs = rng.integers(0, max(total, 1) + 3, size=n_queries).astype(np.int32)
    extra = np.asarray([-1, -7, total, total + 5], np.int32)
    return lens, np.concatenate([qs, extra])


def _port(lens, qs):
    out = rk.resolve_positions(torch.from_numpy(lens), torch.from_numpy(qs))
    return [o.numpy() for o in out]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))


@pytest.mark.parametrize("n_segs", [1, 7, 128, 1500])
def test_plain_matches_reference_and_pallas(n_segs):
    rng = np.random.default_rng(n_segs)
    for _trial in range(3):
        lens, qs = random_case(rng, n_segs, 37)
        got = _port(lens, qs)
        _assert_same(got, resolve_positions_reference(lens, qs))
        _assert_same(got, resolve_positions_pallas(lens, qs, interpret=True))


@pytest.mark.parametrize("name", TILE_CASES)
def test_plain_matches_reference_and_pallas_at_tile_edges(name):
    """The two-level search at the edges of its tiles: segment counts around
    a tile, zero-sum tiles, queries on every tile's first position and one
    below it, 300 queries."""
    lens, qs = tile_case(name, rk.TILE)
    got = _port(lens, qs)
    assert got[2].any() and not got[2].all()
    _assert_same(got, resolve_positions_reference(lens, qs))
    _assert_same(got, resolve_positions_pallas(lens, qs, interpret=True))


def test_batched_form_at_tile_edges():
    lens, qs = batched_tile_case(rk.TILE)
    got = rk.resolve_positions(torch.from_numpy(lens), torch.from_numpy(qs))
    for d in range(lens.shape[0]):
        row = [g[d].numpy() for g in got]
        _assert_same(row, resolve_positions_reference(lens[d], qs[d]))
        _assert_same(row, resolve_positions_pallas(lens[d], qs[d], interpret=True))


def test_misses_are_zero():
    lens = np.asarray([3, 0, 2], np.int32)
    qs = np.asarray([0, 2, 3, 4, 5, 99, -1], np.int32)
    idx, off, hit = _port(lens, qs)
    _assert_same((idx, off, hit), resolve_positions_reference(lens, qs))
    assert list(idx) == [0, 0, 2, 2, 0, 0, 0]
    assert list(off) == [0, 2, 0, 1, 0, 0, 0]
    assert list(hit) == [1, 1, 1, 1, 0, 0, 0]


def test_all_invisible_and_empty():
    idx, off, hit = _port(np.zeros(256, np.int32), np.asarray([0, 1, 2], np.int32))
    assert not idx.any() and not off.any() and not hit.any()
    idx, off, hit = _port(np.zeros(0, np.int32), np.asarray([0, 3], np.int32))
    assert not idx.any() and not off.any() and not hit.any()


def test_batched_form_matches_per_doc():
    rng = np.random.default_rng(5)
    cases = [random_case(rng, 300, 20) for _ in range(4)]
    lens = np.stack([c[0] for c in cases])
    qs = np.stack([c[1] for c in cases])
    got = rk.resolve_positions(torch.from_numpy(lens), torch.from_numpy(qs))
    for d, (ln, q) in enumerate(cases):
        _assert_same([g[d].numpy() for g in got], resolve_positions_reference(ln, q))


def test_wrapper_checks_its_inputs():
    with pytest.raises(TypeError):
        rk.resolve_positions(torch.zeros(4, dtype=torch.int64), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        rk.resolve_positions(torch.zeros((2, 4), dtype=torch.int32), torch.zeros(3, dtype=torch.int32))


def test_cpu_tensors_never_launch():
    before = rk.resolve_positions.launches
    _port(*random_case(np.random.default_rng(0), 50, 5))
    assert rk.resolve_positions.launches == before
