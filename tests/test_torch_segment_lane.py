"""The port's one-shard segment lane against the JAX package.

``apply_megastep_seg`` (whose containment searches go through K1) and
``compact_seg`` of the port, at one shard, against the JAX
``apply_megastep_seg``/``compact_seg`` under a 1-device
``mesh_seg_program`` with ``mk.SEG_RESOLVE_PALLAS = True`` (the JAX path
that reaches the Pallas kernel; off the TPU it runs the kernel's jnp
reference).  Compared on every raw leaf of the seg-sharded state, then
after ``seg_gather_state`` against the port's own single lane.  The host
packing (``seg_shard_state``/``seg_gather_state``/``seg_rebalance_state``)
is held against the JAX packing at one and four shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.ops import mergetree_kernel as mk
from fluidframework_tpu.parallel import mesh as pm
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.parallel import mesh as tpm

from test_segment_parallel import four_writer_trace
from test_torch_mergetree_kernel import assert_states_equal

S, T, OB = 512, 8192, 16
K, B = 7, 16


@pytest.fixture(scope="module")
def ref_programs():
    """JAX seg-lane programs on a 1-device docs x segs mesh with the
    Pallas resolve route on; built uncached (``__wrapped__``) so the
    trace-time flag is the one this module sets, and the flag restored."""
    saved = mk.SEG_RESOLVE_PALLAS
    mk.SEG_RESOLVE_PALLAS = True
    try:
        mesh = pm.docs_segs_mesh(jax.devices()[:1], seg_shards=1)
        specs = pm.seg_state_specs(mk.init_state(S, 4, 4, T, OB))
        mega = pm.mesh_seg_program.__wrapped__(mk.apply_megastep_seg, mesh, specs)
        comp = pm.mesh_seg_program.__wrapped__(
            mk.compact_seg, mesh, specs, arg_specs=(pm.P(),)
        )
        yield mesh, mega, comp
    finally:
        mk.SEG_RESOLVE_PALLAS = saved


def _port_lane():
    mesh = tpm.docs_segs_mesh("cpu", seg_shards=1)
    blocked = tk.seg_shard_state(tk.init_state(S, 4, 4, T, OB, device="cpu"), 1)
    mega = tpm.mesh_seg_program(tk.apply_megastep_seg, mesh, tpm.seg_state_specs(blocked))
    comp = tpm.mesh_seg_program(tk.compact_seg, mesh)
    return mega, comp, tpm.shard_seg_state(blocked, mesh)


@pytest.mark.parametrize("seed", [0, 2])
def test_seg_lane_matches_reference_and_single_lane(ref_programs, seed):
    mesh, ref_mega, ref_comp = ref_programs
    ops, pays = four_writer_trace(seed)
    ops = ops.reshape(K, B, mk.OP_FIELDS)
    pays = pays.reshape(K, B, -1)
    ref = pm.shard_seg_state(mk.seg_shard_state(mk.init_state(S, 4, 4, T, OB), 1), mesh)
    ref = ref_mega(ref, jnp.asarray(ops), jnp.asarray(pays))
    mega, comp, port = _port_lane()
    port = mega(port, ops, pays)
    assert_states_equal(ref, port, f"seg lane seed {seed}")
    assert int(port.error) == 0

    single = tk.apply_megastep(
        tk.batch_state(tk.init_state(S, 4, 4, T, OB, device="cpu"), 1),
        ops[:, None], pays[:, None],
    )
    a = tk.canonical_doc(tk.doc_row(single, 0))
    b = tk.canonical_doc(tk.seg_gather_state(port, max_segments=S))
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []

    ref = ref_comp(ref, jnp.asarray(40, jnp.int32))
    port = comp(port, 40)
    assert_states_equal(ref, port, f"compact_seg seed {seed}")


def test_seg_lane_rebalance_midstream(ref_programs):
    """A re-block between two halves of the trace is unobservable, and the
    port's rebalanced state equals the reference's."""
    mesh, ref_mega, _ = ref_programs
    ops, pays = four_writer_trace(3)
    ops = ops.reshape(K, B, mk.OP_FIELDS)
    pays = pays.reshape(K, B, -1)
    ref = pm.shard_seg_state(mk.seg_shard_state(mk.init_state(S, 4, 4, T, OB), 1), mesh)
    mega, _, port = _port_lane()
    ref = ref_mega(ref, jnp.asarray(ops[:3]), jnp.asarray(pays[:3]))
    port = mega(port, ops[:3], pays[:3])
    ref = pm.shard_seg_state(mk.seg_rebalance_state(jax.tree.map(np.asarray, ref)), mesh)
    port = tk.seg_rebalance_state(port)
    assert_states_equal(ref, port, "rebalanced")
    ref = ref_mega(ref, jnp.asarray(ops[3:]), jnp.asarray(pays[3:]))
    port = mega(port, ops[3:], pays[3:])
    assert_states_equal(ref, port, "after rebalance")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_host_packing_matches_reference(n_shards):
    ops, pays = four_writer_trace(5)
    # One segment-capacity below S: a single-lane program no other file compiles.
    single = jax.jit(mk.apply_ops)(
        mk.init_state(S - 32, 4, 4, T, OB), jnp.asarray(ops), jnp.asarray(pays)
    )
    host = jax.tree.map(np.asarray, single)
    port_single = tk.from_numpy(host, device="cpu")
    ref_b = mk.seg_shard_state(host, n_shards, text_capacity=T + 64)
    port_b = tk.seg_shard_state(port_single, n_shards, text_capacity=T + 64)
    assert_states_equal(ref_b, port_b, "seg_shard_state")
    assert_states_equal(mk.seg_gather_state(ref_b, S), tk.seg_gather_state(port_b, S), "gather")
    assert_states_equal(mk.seg_rebalance_state(ref_b), tk.seg_rebalance_state(port_b), "rebalance")
    assert tk.canonical_doc(tk.seg_gather_state(port_b, S)).keys() == mk.canonical_doc(single).keys()


def test_multi_shard_lanes_are_not_ported():
    with pytest.raises(NotImplementedError):
        tpm.docs_segs_mesh("cpu", seg_shards=2)
    with pytest.raises(NotImplementedError):
        tk.shard_group(4)
