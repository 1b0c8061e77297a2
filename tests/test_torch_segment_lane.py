"""The port's segment lane against the JAX package.

``apply_megastep_seg`` (whose containment searches go through K1) and
``compact_seg`` of the port, at one shard and over n = 2, 4 and 8 shards of
the stacked group, against the JAX ``apply_megastep_seg``/``compact_seg``
under an n-device ``mesh_seg_program`` with ``mk.SEG_RESOLVE_PALLAS = True``
(the JAX path that reaches the Pallas kernel; off the TPU it runs the
kernel's jnp reference).  Compared on every raw leaf of the seg-sharded
state (the port's stacked state unstacked to the reference's blocked
layout, after checking that its n replicas agree), then after
``seg_gather_state`` against the port's own single lane.  The host packing
(``seg_shard_state``/``seg_gather_state``/``seg_rebalance_state``) is held
against the JAX packing at one and four shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as mk
from fluidframework_tpu.parallel import mesh as pm
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.parallel import mesh as tpm

from test_segment_parallel import four_writer_trace
from test_torch_mergetree_kernel import assert_states_equal

S, T, OB = 512, 8192, 16
K, B = 7, 16


def _ref_programs(n: int):
    """JAX seg-lane programs on an n-device docs x segs mesh with the
    Pallas resolve route on; built uncached (``__wrapped__``) so the
    trace-time flag is the one set here, and the flag restored."""
    saved = mk.SEG_RESOLVE_PALLAS
    mk.SEG_RESOLVE_PALLAS = True
    try:
        mesh = pm.docs_segs_mesh(jax.devices()[:n], seg_shards=n)
        specs = pm.seg_state_specs(mk.init_state(S, 4, 4, T, OB))
        mega = pm.mesh_seg_program.__wrapped__(mk.apply_megastep_seg, mesh, specs)
        comp = pm.mesh_seg_program.__wrapped__(
            mk.compact_seg, mesh, specs, arg_specs=(pm.P(),)
        )
        return mesh, mega, comp
    finally:
        mk.SEG_RESOLVE_PALLAS = saved


@pytest.fixture(scope="module")
def ref_programs():
    return _ref_programs(1)


def _port_lane(n: int = 1):
    mesh = tpm.docs_segs_mesh(["cpu"] * n, seg_shards=n)
    blocked = tk.seg_shard_state(tk.init_state(S, 4, 4, T, OB, device="cpu"), n)
    mega = tpm.mesh_seg_program(tk.apply_megastep_seg, mesh, tpm.seg_state_specs(blocked))
    comp = tpm.mesh_seg_program(tk.compact_seg, mesh)
    return mega, comp, tpm.shard_seg_state(blocked, mesh)


def assert_lane_equal(ref, port, tag: str) -> None:
    """The port's stacked lane state holds n agreeing replicas and, in the
    blocked layout, equals the reference's state leaf for leaf."""
    assert tk.seg_replica_mismatch(port) == [], f"{tag}: replicas disagree"
    assert_states_equal(ref, tk.seg_unstack(port), tag)


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
    assert_lane_equal(ref, port, f"seg lane seed {seed}")
    assert int(port.error[0]) == 0

    single = tk.apply_megastep(
        tk.batch_state(tk.init_state(S, 4, 4, T, OB, device="cpu"), 1),
        ops[:, None], pays[:, None],
    )
    a = tk.canonical_doc(tk.doc_row(single, 0))
    b = tk.canonical_doc(tk.seg_gather_state(port, max_segments=S))
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []

    ref = ref_comp(ref, jnp.asarray(40, jnp.int32))
    port = comp(port, 40)
    assert_lane_equal(ref, port, f"compact_seg seed {seed}")


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
    port = tpm.shard_seg_state(tk.seg_rebalance_state(port), tpm.docs_segs_mesh("cpu"))
    assert_lane_equal(ref, port, "rebalanced")
    ref = ref_mega(ref, jnp.asarray(ops[3:]), jnp.asarray(pays[3:]))
    port = mega(port, ops[3:], pays[3:])
    assert_lane_equal(ref, port, "after rebalance")


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
    """Multi-shard lanes are ported (below); what stays refused is a mesh
    over distinct devices, naming its ROADMAP item, and a segs axis that
    does not divide the mesh."""
    for devices in ([torch.device("cpu"), torch.device("meta")], ["cpu", "meta", "cpu"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            tpm.docs_segs_mesh(devices, seg_shards=1)
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            tpm.doc_mesh(devices)
    with pytest.raises(ValueError):
        tpm.docs_segs_mesh(["cpu"] * 4, seg_shards=3)
    assert tk.shard_group(4).size == 4


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 2])
def test_multi_shard_lane_matches_reference(n, seed):
    """K6 over n shards: the stacked lane equals the reference's n-device
    shard_map programs on every leaf, after the megastep and after
    compact_seg, and gathers to the single lane's document."""
    mesh, ref_mega, ref_comp = _ref_programs(n)
    ops, pays = four_writer_trace(seed)
    ops = ops.reshape(K, B, mk.OP_FIELDS)
    pays = pays.reshape(K, B, -1)
    ref = pm.shard_seg_state(mk.seg_shard_state(mk.init_state(S, 4, 4, T, OB), n), mesh)
    ref = ref_mega(ref, jnp.asarray(ops), jnp.asarray(pays))
    mega, comp, port = _port_lane(n)
    assert port.seg_len.shape == (n, S // n) and port.text.shape == (n, T)
    port = mega(port, ops, pays)
    assert_lane_equal(ref, port, f"n={n} seed {seed}")
    if int(port.error[0]):
        # Inserts land shard-local: at 8 shards of 64 slots the hot shard
        # overflows on some traces, latching ERR_SEG_OVERFLOW exactly as
        # the reference's lane does (the engine recovers such a lane).
        assert n == 8 and int(port.error[0]) & tk.ERR_SEG_OVERFLOW
        return
    single = tk.apply_megastep(
        tk.batch_state(tk.init_state(S, 4, 4, T, OB, device="cpu"), 1),
        ops[:, None], pays[:, None],
    )
    a = tk.canonical_doc(tk.doc_row(single, 0))
    b = tk.canonical_doc(tk.seg_gather_state(port, max_segments=S))
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []
    assert tk.seg_occupancy(port).sum() == b["nseg"]
    ref = ref_comp(ref, jnp.asarray(40, jnp.int32))
    port = comp(port, 40)
    assert_lane_equal(ref, port, f"compact_seg n={n} seed {seed}")


@pytest.mark.parametrize("n", [4])
def test_replicas_agree_after_every_op(n):
    """The replication invariant of the reference's shards: op by op, the
    n copies of every replicated leaf agree, and the op-by-op lane ends
    where the whole-ring lane does."""
    ops, pays = four_writer_trace(1)
    mega, _comp, port = _port_lane(n)
    whole = mega(port, ops.reshape(K, B, -1), pays.reshape(K, B, -1))
    for i in range(ops.shape[0]):
        port = mega(port, ops[i : i + 1, None], pays[i : i + 1, None])
        assert tk.seg_replica_mismatch(port) == [], f"op {i}"
    for x, y in zip(tk.leaves(whole), tk.leaves(port)):
        assert torch.equal(x, y)
