"""The port's long-document query plane against the JAX package at one
shard: ``visible_length``, ``resolve_positions`` (the K1 route) and
``mark_range`` of ``make_sharded_ops``, on a 1-device ``segs`` mesh in the
reference, compared exactly."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fluidframework_tpu.parallel.long_doc import make_sharded_ops, shard_doc_state
from fluidframework_tpu.protocol.stamps import ALL_ACKED
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.parallel import long_doc as tld
from fluidframework_tpu_torch.parallel import mesh as tpm

from test_long_doc import build_doc
from test_torch_mergetree_kernel import assert_states_equal


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("segs",))


def _both(mesh, **kw):
    state = build_doc(**kw)
    ref_ops = make_sharded_ops(mesh, state)
    ref_state = shard_doc_state(state, mesh)
    tmesh = tpm.doc_mesh("cpu")
    port_state = tld.shard_doc_state(tk.from_numpy(jax.tree.map(np.asarray, state), "cpu"), tmesh)
    port_ops = tld.make_sharded_ops(tmesh, port_state)
    return state, ref_state, ref_ops, port_state, port_ops


@pytest.mark.parametrize("view", [(ALL_ACKED, -2), (70, 0), (30, 5)])
def test_resolve_and_length_match_reference(mesh, view):
    ref_seq, client = view
    state, ref_state, ref_ops, port_state, port_ops = _both(
        mesh, n_segs=96, seg_len=3, removed_every=5
    )
    ref_len = int(ref_ops[0](ref_state, ref_seq, client))
    assert int(port_ops[0](port_state, ref_seq, client)) == ref_len
    rng = np.random.default_rng(ref_seq)
    queries = np.concatenate([
        rng.integers(0, max(ref_len, 1), 61), [-1, ref_len, ref_len + 4]
    ]).astype(np.int32)
    gi, off = ref_ops[1](ref_state, jnp.asarray(queries), ref_seq, client)
    pgi, poff = port_ops[1](port_state, queries, ref_seq, client)
    np.testing.assert_array_equal(np.asarray(gi), pgi.numpy())
    np.testing.assert_array_equal(np.asarray(off), poff.numpy())


def test_mark_range_matches_reference(mesh):
    state, ref_state, ref_ops, port_state, port_ops = _both(
        mesh, n_segs=80, seg_len=4, removed_every=9
    )
    ref_out = jax.device_get(ref_ops[2](ref_state, 40, 200, 500, 3, ALL_ACKED, -2))
    port_out = port_ops[2](port_state, 40, 200, 500, 3, ALL_ACKED, -2)
    assert_states_equal(ref_out, port_out, "mark_range")


@pytest.mark.parametrize("view", [(ALL_ACKED, -2), (70, 0)])
def test_four_shard_plane_matches_reference(view):
    """``make_sharded_ops`` over 4 shards of the stacked group (one K1 call
    over the [4, 64] blocks) against the reference's 4-device segs mesh:
    visible length, resolve and mark_range, exact."""
    ref_seq, client = view
    rmesh = Mesh(np.asarray(jax.devices()[:4]), ("segs",))
    state = build_doc(n_segs=150, seg_len=3, removed_every=5)
    ref_ops = make_sharded_ops(rmesh, state)
    ref_state = shard_doc_state(state, rmesh)
    tmesh = tpm.docs_segs_mesh(["cpu"] * 4, seg_shards=4)
    port_state = tld.shard_doc_state(tk.from_numpy(jax.tree.map(np.asarray, state), "cpu"), tmesh)
    port_ops = tld.make_sharded_ops(tmesh, port_state)
    ref_len = int(ref_ops[0](ref_state, ref_seq, client))
    assert int(port_ops[0](port_state, ref_seq, client)) == ref_len
    rng = np.random.default_rng(ref_seq)
    queries = np.concatenate([
        rng.integers(0, max(ref_len, 1), 61), [-1, 0, ref_len - 1, ref_len]
    ]).astype(np.int32)
    gi, off = ref_ops[1](ref_state, jnp.asarray(queries), ref_seq, client)
    pgi, poff = port_ops[1](port_state, queries, ref_seq, client)
    np.testing.assert_array_equal(np.asarray(gi), pgi.numpy())
    np.testing.assert_array_equal(np.asarray(off), poff.numpy())
    ref_out = jax.device_get(ref_ops[2](ref_state, 40, 300, 500, 3, ref_seq, client))
    port_out = port_ops[2](port_state, 40, 300, 500, 3, ref_seq, client)
    assert_states_equal(ref_out, port_out, "mark_range over 4 shards")
