"""The port's rebase window (K9) and its EditManager hook against the JAX
package's, exact.

* Flat legs: ``rebase_flat_pair_kernel`` of both packages on seeded
  canonical move-free mark columns (collisions included): every output of
  both legs equal, and some legs flagged ``bad``.
* Windows: ``rebase_window_kernel`` (the port's plain form, batched over W)
  against the reference's ``rebase_window_batched`` on seeded windows of
  encodings: every output of every step equal, the steps after the first
  invalid one included; the packed-row wrapper ``rebase_window`` (which
  takes the plain form on the CPU) equal to it.
* EditManager: ``device_rebase`` with a CPU ``DeviceRebaser`` against the
  port's pooled fold and against the reference's ``device_rebase=True``
  fold on the shared fuzz streams — trunk commits, fold stages, summaries,
  the applied forest and the rebaser's gauges, on clean streams (every step
  on the window) and mixed ones (fallbacks counted).
* TreeBatchEngine: ``device_rebase=True`` against ``False`` and against
  the reference engine's gauges.
"""

from __future__ import annotations

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.tree.changeset import clone_commit as ref_clone_commit
from fluidframework_tpu.dds.tree.changeset import commit_to_json as ref_commit_to_json
from fluidframework_tpu.dds.tree.editmanager import EditManager as RefEditManager
from fluidframework_tpu.dds.tree.mark_pool import MarkPool as RefMarkPool
from fluidframework_tpu.dds.tree.mark_pool import pool_commit_from_json as ref_pool_from_json
from fluidframework_tpu.models.tree_batch_engine import TreeBatchEngine as RefEngine
from fluidframework_tpu.ops import tree_kernel as rtk
from fluidframework_tpu_torch.dds.tree.changeset import (
    Insert,
    Modify,
    NodeChange,
    Remove,
    Skip,
    apply_commit,
    clone_commit,
    commit_to_json,
)
from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
from fluidframework_tpu_torch.dds.tree.editmanager import EditManager
from fluidframework_tpu_torch.dds.tree.forest import Forest
from fluidframework_tpu_torch.dds.tree.mark_pool import (
    F_CANONICAL,
    MarkPool,
    pool_commit_from_json,
    pool_marks,
)
from fluidframework_tpu_torch.dds.tree.schema import leaf
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.ops import rebase_kernel as rk
from fluidframework_tpu_torch.ops import tree_kernel as tk

from test_mark_pool import _engine_msgs, _fuzz_edits
from test_torch_cuda_kernels import window_commit

M = tk.REBASE_MAX_MARKS
PD = tk.REBASE_MAX_DEPTH


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_equal(ref, port, what):
    """Every leaf of two (nested) NamedTuples equal as int64."""
    ra, pa = jax.tree_util.tree_leaves(ref), []

    def walk(t):
        for f in t:
            if isinstance(f, tuple):
                walk(f)
            else:
                pa.append(f)
    walk(port)
    assert len(ra) == len(pa), what
    for i, (a, b) in enumerate(zip(ra, pa)):
        a, b = _np(a).astype(np.int64), _np(b).astype(np.int64)
        assert a.shape == b.shape and np.array_equal(a, b), (what, i)


# ---------------------------------------------------------------------------
# Flat legs
# ---------------------------------------------------------------------------


def _rand_marks(rng, n):
    """Canonical-biased random mark list over an n-node context (the
    reference test's generator, with the port's mark classes)."""
    marks, pos = [], 0
    last = None
    while pos < n:
        r = rng.random()
        if r < 0.25 and last != "S" and pos < n - 1:
            k = rng.randint(1, n - pos - 1)
            marks.append(Skip(k))
            pos += k
            last = "S"
        elif r < 0.5 and last != "R":
            k = rng.randint(1, n - pos)
            marks.append(Remove(k))
            pos += k
            last = "R"
        elif r < 0.75 and last != "I":
            marks.append(Insert([leaf(rng.randint(0, 99)) for _ in range(rng.randint(1, 3))]))
            last = "I"
        else:
            marks.append(Modify(NodeChange(value=(rng.randint(0, 9),))))
            pos += 1
            last = "M"
    if rng.random() < 0.4 and last != "I":
        marks.append(Insert([leaf(7)]))
    return marks


def test_flat_legs_match_reference():
    pool = MarkPool()
    ref_pair = jax.jit(rtk.rebase_flat_pair_kernel)
    total = bad = 0
    for seed in range(160):
        rng = random.Random(seed ^ 0x9E3779B9)
        cols = []
        for _ in range(2):
            try:
                pm = pool_marks(pool, _rand_marks(rng, rng.randint(0, 7)))
                k, c, _ = pm.columns_padded(M)
            except ValueError:
                break  # wider than the kernel: the encoder gates these out
            if not pm.flags & F_CANONICAL:
                break
            cols += [k, c]
        if len(cols) < 4:
            continue
        total += 1
        want = ref_pair(*map(jnp.asarray, cols))
        got = tk.rebase_flat_pair_kernel(*(torch.as_tensor(c) for c in cols))
        _assert_trees_equal(want, got, f"seed {seed}")
        bad += int(got[0].bad) + int(got[1].bad)
    assert total > 100
    # The generator is Modify-heavy: some collisions must be flagged.
    assert bad > 0


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def _rand_encs(rng, W):
    """W encodings of random fields in their ranges (collisions, value
    drops, detached removes and shared spines all occur)."""
    dep = rng.integers(0, PD + 1, W)
    fld = rng.integers(-1, 3, (W, PD + 1))
    pos = rng.integers(0, 4, (W, PD))
    val = rng.integers(0, 2, (W, PD + 1))
    kind = np.zeros((W, M), np.int64)
    cnt = np.zeros((W, M), np.int64)
    n = rng.integers(0, M + 1, W)
    for w in range(W):
        kind[w, :n[w]] = rng.integers(1, 5, n[w])
        cnt[w, :n[w]] = rng.integers(1, 5, n[w])
    det = (rng.random((W, M)) < 0.1) * (kind == 3)
    slo = rng.integers(0, M, (W, M))
    shi = rng.integers(0, M, (W, M))
    return [a.astype(np.int32) for a in (dep, fld, pos, val, kind, cnt, det, n, slo, shi)]


def window_case(seed, W, C):
    """(c fields [W, ...], xs fields [W, C, ...], elig [W, C]) as numpy."""
    rng = np.random.default_rng(seed)
    c = _rand_encs(rng, W)
    xs = [a.reshape(W, C, *a.shape[1:]) for a in _rand_encs(rng, W * C)]
    return c, xs, rng.random((W, C)) < 0.95


@pytest.mark.parametrize("seed,W,C", [(0, 24, 6), (1, 7, 8), (3, 1, 16)])
def test_window_matches_reference(seed, W, C):
    c, xs, elig = window_case(seed, W, C)
    want = rtk.rebase_window_batched(
        rtk.RebaseEnc(*map(jnp.asarray, c)), rtk.RebaseEnc(*map(jnp.asarray, xs)),
        jnp.asarray(elig))
    got = tk.rebase_window_kernel(
        tk.rebase_enc_from_numpy(c, "cpu"), tk.rebase_enc_from_numpy(xs, "cpu"),
        torch.as_tensor(elig))
    _assert_trees_equal(want, got, "window")
    valid = got[1].valid.numpy()
    # Dead steps occur and are compared too; so do valid ones.
    assert valid.any() and not valid.all()
    if W == 1:
        # the reference's one-window program is the same function
        one = rtk.rebase_window_jit(
            rtk.RebaseEnc(*(jnp.asarray(a[0]) for a in c)),
            rtk.RebaseEnc(*(jnp.asarray(a[0]) for a in xs)), jnp.asarray(elig[0]))
        _assert_trees_equal(one, jax.tree_util.tree_map(lambda a: a[0], want), "one window")


def test_packed_wrapper_matches_the_plain_form():
    c, xs, elig = window_case(3, 9, 5)
    ce, xe = tk.rebase_enc_from_numpy(c, "cpu"), tk.rebase_enc_from_numpy(xs, "cpu")
    final, outs = tk.rebase_window_kernel(ce, xe, torch.as_tensor(elig))
    before = rk.rebase_window.launches
    pf, ps = rk.rebase_window(rk.pack_enc(ce), rk.pack_enc(xe),
                              torch.as_tensor(elig.astype(np.uint8)))
    assert rk.rebase_window.launches == before  # the CPU never counts a launch
    assert pf.shape == (9, rk.ENC_WORDS) and ps.shape == (9, 5, rk.STEP_WORDS)
    _assert_trees_equal(final, rk.unpack_enc(pf), "final")
    steps = rk.unpack_steps(ps)
    for a, b in ((outs.valid, steps.valid), (outs.id_c, steps.id_c), (outs.id_x, steps.id_x)):
        assert torch.equal(a.to(torch.int32), b)
    _assert_trees_equal((outs.x, outs.stage, outs.x_drop), (steps.x, steps.stage, steps.x_drop),
                        "steps")
    # Shapes and types the kernel does not take are refused on every device.
    with pytest.raises(TypeError):
        rk.rebase_window(pf, rk.pack_enc(xe), torch.as_tensor(elig))
    with pytest.raises(ValueError):
        rk.rebase_window(pf[:, :-1], rk.pack_enc(xe), torch.as_tensor(elig.astype(np.uint8)))


# ---------------------------------------------------------------------------
# EditManager: device window == pooled fold == the reference's device window
# ---------------------------------------------------------------------------


def _run(edits, rebase: bool, ref: bool = False):
    """One stream through an EditManager of either package (pooled, device
    window on or off); returns its JSON views and the rebaser's stats."""
    if ref:
        em = RefEditManager(mark_pool=RefMarkPool(), device_rebase=rebase or None)
        from fluidframework_tpu.dds.tree.changeset import apply_commit as ref_apply
        from fluidframework_tpu.dds.tree.forest import Forest as RefForest
        forest, apply_, pool_from_json = RefForest(), ref_apply, ref_pool_from_json
        to_json, clone = ref_commit_to_json, ref_clone_commit
    else:
        pool = MarkPool()
        em = EditManager(mark_pool=pool,
                         device_rebase=DeviceRebaser(pool, device="cpu") if rebase else None)
        forest, apply_, pool_from_json = Forest(), apply_commit, pool_commit_from_json
        to_json, clone = commit_to_json, clone_commit
    trunk = []
    for w, ref_seq, seq, min_seq, commit in edits:
        wire = ref_commit_to_json(ref_clone_commit(commit))
        ret = em.add_sequenced(client_id=f"w{w}", revision=(w, seq),
                               change=pool_from_json(em.pool, wire),
                               ref_seq=ref_seq, seq=seq)
        trunk.append(json.dumps(to_json(clone(ret))))
        apply_(forest.root, ret)
        em.advance_min_seq(min_seq)
    stages = {cid: [[[tseq, to_json(cm)] for tseq, cm in st] for st in br.stages]
              for cid, br in em.peers.items()}
    return ((json.dumps(em.summarize(), sort_keys=True), json.dumps(stages, sort_keys=True),
             trunk, json.dumps(forest.to_json(), sort_keys=True)),
            em.rebaser.stats() if rebase else None)


def _assert_manager_identity(edits):
    views, stats = _run(edits, rebase=True)
    pooled, _ = _run(edits, rebase=False)
    ref_views, ref_stats = _run(edits, rebase=True, ref=True)
    for name, a, b, r in zip(("summary", "stages", "trunk", "forest"), views, pooled, ref_views):
        assert a == b, f"{name} differs from the port's pooled fold"
        assert a == r, f"{name} differs from the reference's device window"
    assert stats == ref_stats
    steps = stats["device_rebase_steps"] + stats["rebase_fallbacks"]
    assert steps and stats["device_rebase_fraction"] == round(
        stats["device_rebase_steps"] / steps, 4)
    return stats


@pytest.mark.parametrize("seed", [3, 4])
def test_manager_identity_mixed(seed):
    """Mixed streams (moves, optional, undo, constraints): the ineligible
    share falls back — counted — and every view still matches."""
    stats = _assert_manager_identity(_fuzz_edits(seed, rounds=5, writers=3))
    assert stats["rebase_fallbacks"] + stats["rebase_encode_rejects"] > 0
    assert 0.0 < stats["device_rebase_fraction"] < 1.0


def test_manager_identity_clean_full_device():
    """Insert/remove/set-only streams run every step on the window."""
    edits = _fuzz_edits(1, rounds=5, writers=3, with_moves=False, with_optional=False,
                        with_undo=False, with_constraints=False)
    stats = _assert_manager_identity(edits)
    assert stats["rebase_fallbacks"] == 0 and stats["device_rebase_fraction"] == 1.0


def test_private_rebaser_runs_on_the_card():
    """``device_rebase=True`` builds a private rebaser on the card, as every
    port entry point defaults to it: without one it raises, never a silent
    CPU fold.  Without ``mark_pool`` the option is ignored, as in the
    reference."""
    assert EditManager(device_rebase=True).rebaser is None
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EditManager(mark_pool=True, device_rebase=True)


# ---------------------------------------------------------------------------
# Engine: identity and gauges
# ---------------------------------------------------------------------------


def test_engine_device_rebase_identity_and_gauges():
    msgs = _engine_msgs(3)

    def run(cls, device_rebase, **kw):
        eng = cls(2, capacity=4096, ops_per_step=16, pool_capacity=32768,
                  mark_pool=True, device_rebase=device_rebase, **kw)
        for m in msgs:
            eng.ingest(0, m)
            eng.ingest(1, m)
        sums = [json.dumps(eng.hosts[d].em.summarize(), sort_keys=True) for d in range(2)]
        eng.step()
        trees = [json.dumps(eng.tree_json(d), sort_keys=True) for d in range(2)]
        return eng, sums, trees

    e1, s1, t1 = run(TreeBatchEngine, True, device="cpu")
    e0, s0, t0 = run(TreeBatchEngine, False, device="cpu")
    er, sr, tr = run(RefEngine, True)
    assert s1 == s0 == sr and t1 == t0 == tr
    h, hr = e1.health(), er.health()
    assert h["device_rebase_fraction"] == 1.0
    assert h["rebase_fallbacks"] == 0
    assert h["rebase_windows"] > 0
    keys = [k for k in hr if "rebase" in k]
    assert len(keys) == 5 and {k: h[k] for k in keys} == {k: hr[k] for k in keys}
    assert "device_rebase_fraction" not in e0.health()
    assert e1.rebaser.device == torch.device("cpu")


def test_restored_engine_gauges_match_reference(tmp_path):
    """A restore rebuilds EditManagers without the rebaser in both
    packages: after checkpointing doc 0 of a ``device_rebase=True`` engine,
    restoring it into a fresh engine and feeding both docs the whole log,
    the summaries, trees and every ``rebase`` gauge equal the reference's
    (doc 1 still folds on the window, the restored doc 0 on the host)."""
    from fluidframework_tpu.server.ordered_log import CheckpointStore as RefStore
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    msgs = _engine_msgs(3)
    half = len(msgs) // 2

    def run(cls, store, **kw):
        make = lambda: cls(2, capacity=4096, ops_per_step=16, pool_capacity=32768,
                           mark_pool=True, device_rebase=True, checkpoint_store=store, **kw)
        first = make()
        for m in msgs[:half]:
            first.ingest(0, m)
        first.step()
        assert first.maybe_checkpoint(force=True, docs=[0]) == [0]
        eng = make()
        assert eng.restore_from_checkpoints() == [0]
        for m in msgs:
            eng.ingest(0, m)
            eng.ingest(1, m)
        sums = [json.dumps(eng.hosts[d].em.summarize(), sort_keys=True) for d in range(2)]
        eng.step()
        trees = [json.dumps(eng.tree_json(d), sort_keys=True) for d in range(2)]
        h = eng.health()
        return sums, trees, {k: v for k, v in h.items() if "rebase" in k}, h

    sums, trees, gauges, h = run(TreeBatchEngine, CheckpointStore(str(tmp_path / "port")),
                                 device="cpu")
    ref_sums, ref_trees, ref_gauges, ref_h = run(RefEngine, RefStore(str(tmp_path / "ref")))
    assert sums == ref_sums and trees == ref_trees
    assert len(gauges) == 5 and gauges == ref_gauges
    assert 0 < gauges["device_rebase_steps"] and gauges["rebase_windows"] > 0
    assert h["checkpointed_ops_skipped"] == ref_h["checkpointed_ops_skipped"] > 0


def _fold_json(c, xs) -> str:
    return json.dumps([commit_to_json(c)] + [commit_to_json(x) for x in xs])


def test_concurrent_folds_through_one_rebaser():
    """Two threads folding different windows through one CPU
    ``DeviceRebaser`` (one reused host buffer per window cap, one shared
    MarkPool) get the pooled fold's result on every fold."""
    import threading

    from fluidframework_tpu_torch.dds.tree.mark_pool import rebase_pair

    pool = MarkPool()
    reb = DeviceRebaser(pool, device="cpu")
    rngs = [np.random.default_rng(50 + t) for t in range(2)]
    windows = [[(window_commit(pool, rng), [window_commit(pool, rng) for _ in range(8)])
                for _ in range(6)] for rng in rngs]
    want = []
    for ws in windows:
        out = []
        for c, xs in ws:
            new_xs = []
            for x in xs:
                c, xw = rebase_pair(c, x)
                new_xs.append(xw)
            out.append(_fold_json(c, new_xs))
        want.append(out)
    rounds = 8
    wrong = [0, 0]

    def worker(t):
        for _ in range(rounds):
            for (c, xs), w in zip(windows[t], want[t]):
                fc, fx, _stages = reb.fold(c, xs)
                wrong[t] += _fold_json(fc, fx) != w

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads), "the folds did not finish within 120 s"
    assert wrong == [0, 0]
    stats = reb.stats()
    assert stats["rebase_windows"] == 2 * rounds * 6 and stats["rebase_fallbacks"] == 0
