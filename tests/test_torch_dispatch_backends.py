"""The port's dispatch planes against the reference's lax programs.

The twin of ``tests/test_dispatch_backends.py``: every dispatch plane of
the port — the default torch plane (``parallel.mesh``) and the native
plane (``parallel.native_plane`` over ``native/megastep.cpp``) — is held,
on the CPU, to:

- **byte identity with the reference's lax programs** (``jax.jit`` of the
  JAX package's ``apply_megastep`` and ``_fleet_compact_body``) over the
  reference's seeded multi-writer traces (``make_trace``: the full op
  palette, poison and capacity ops included), on the FULL raw columns —
  padding remnants included — after every ring and every compact, plus
  the per-doc error latch;
- **engine-level equivalence**: a ``DocBatchEngine`` on the native plane
  gives the same raw state, texts, annotations and digest as one on the
  torch plane, and the same texts as the reference's engine;
- **plane-invariant checkpoints**: a checkpoint written on one plane
  restores on the other, both directions;
- **the counted seg-lane downgrade**: the native plane has no segment
  programs, and an engine asked for them serves on the fleet path with
  ``seg_plane_unsupported`` = 1;
- **the provider variable**: ``FFTPU_TORCH_DISPATCH_PLANE`` selects a
  plane in a fresh process, the reference's ``FFTPU_DISPATCH_PLANE`` loads
  nothing into the port, and a provider that registers nothing raises.

Tier-1 runs seeds 0 and 1; ``-m slow`` the reference's deep seeds 2-7.
Geometry stays at D <= 8, S <= 64.  Tolerance 0 throughout.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import DocBatchEngine as RefEngine
from fluidframework_tpu.models.doc_batch_engine import _fleet_compact_body as ref_compact_body
from fluidframework_tpu.ops import mergetree_kernel as mk
from fluidframework_tpu_torch.models import dispatch
from fluidframework_tpu_torch.models.doc_batch_engine import (
    DocBatchEngine,
    _fleet_compact_body,
    fleet_digest,
)
from fluidframework_tpu_torch.native import megastep_native
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

from test_dispatch_backends import make_trace
from test_engine_checkpoint import _ins, _join
from test_megastep import _schedule
from test_torch_mergetree_kernel import assert_states_equal

ROOT = Path(__file__).resolve().parent.parent
TORCH_PLANE = "fluidframework_tpu_torch.parallel.mesh"
NATIVE_PLANE = "fluidframework_tpu_torch.parallel.native_plane"

PLANES = [pytest.param(TORCH_PLANE, id="torch"), pytest.param(NATIVE_PLANE, id="native")]

_ref_megastep = jax.jit(mk.apply_megastep)
_ref_compact = jax.jit(ref_compact_body)


def _register(name: str):
    mod = importlib.import_module(name)
    dispatch.register_dispatch_plane(mod)
    return mod


def _restore_default_plane() -> None:
    _register(TORCH_PLANE)


@pytest.fixture(params=PLANES)
def plane(request):
    """Register the plane under test; ALWAYS hand the registry back to the
    torch plane afterwards (registration is last-wins process state)."""
    try:
        yield _register(request.param)
    finally:
        _restore_default_plane()


# --------------------------------------------------- program conformance

def _run_conformance(plane_mod, seed, D=8, K=3, B=8, L=6, S=32, T=256, n_rings=4):
    """Replay one trace through the plane's fleet programs and through the
    reference's lax programs; compare every raw column after every ring
    and every compact."""
    proto = mk.init_state(S, 3, 2, T, 4)
    oracle = jax.tree.map(lambda x: jnp.broadcast_to(x, (D,) + x.shape), proto)
    mesh = plane_mod.doc_mesh("cpu")
    state = plane_mod.shard_fleet_state(
        tk.batch_state(tk.init_state(S, 3, 2, T, 4, device="cpu"), D), mesh)
    mega = plane_mod.mesh_fleet_program(tk.apply_megastep, mesh)
    compact = plane_mod.mesh_fleet_program(_fleet_compact_body, mesh)

    rings, seqs = make_trace(seed, D, K, B, L, n_rings)
    for i, (ops, pays) in enumerate(rings):
        kinds = ops[..., 0]
        state = mega(state, ops, pays, kinds=kinds)
        oracle = _ref_megastep(oracle, jnp.asarray(ops), jnp.asarray(pays))
        assert_states_equal(oracle, state, f"seed {seed} ring {i}")
        mins = np.array([max(0, s - 7 - i) for s in seqs], np.int32)
        state = compact(state, plane_mod.shard_docs(tk._as_tensor(mins, "cpu"), mesh))
        oracle = _ref_compact(oracle, jnp.asarray(mins))
        assert_states_equal(oracle, state, f"seed {seed} ring {i} post-compact")
    want = np.asarray(oracle.error)
    assert plane_mod.error_count(state.error) == int(np.count_nonzero(want))
    return want


@pytest.mark.parametrize("seed", [0, 1])
def test_megastep_conformance_short(plane, seed):
    errs = _run_conformance(plane, seed)
    assert errs.any(), "trace never latched an error bit (weak trace)"


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 3, 4, 5, 6, 7])
def test_megastep_conformance_deep(plane, seed):
    _run_conformance(plane, seed, D=8, K=4, B=12, L=8, S=64, T=1024, n_rings=8)


def test_native_programs_leave_their_input_alone():
    """The native twins copy the state out; the caller's leaves (which the
    engine may still hold) are never written."""
    D, K, B, L = 4, 2, 4, 4
    state = tk.batch_state(tk.init_state(32, 3, 2, 128, 4, device="cpu"), D)
    before = [x.clone() for x in tk.leaves(state)]
    (ops, pays), = make_trace(5, D, K, B, L, 1)[0][:1]
    assert megastep_native.available()
    out = megastep_native.megastep(state, ops, pays)
    megastep_native.fleet_compact(out, np.full((D,), 3, np.int32))
    for x, y in zip(tk.leaves(state), before):
        assert x.equal(y)
    assert all(x.device.type == "cpu" and x.dtype == tk.I32 for x in tk.leaves(out))


# ---------------------------------------------------- engine conformance

def _run_engine(n_docs, sched, step_every=17, **kw):
    eng = DocBatchEngine(
        n_docs, remove_slots=4, max_insert_len=8, ops_per_step=4, use_mesh=True,
        megastep_k=4, max_segments=64, text_capacity=1024, device="cpu", **kw)
    for d in range(n_docs):
        eng.ingest(d, _join("w0", 0))
    for i, (d, msg) in enumerate(sched):
        eng.ingest(d, msg)
        if (i + 1) % step_every == 0:
            eng.step()
    eng.step()
    return eng


@pytest.fixture(scope="module")
def ref_texts():
    """The reference engine's texts and annotations for the engine schedule
    (``use_mesh=False``: robust under test-worker load)."""
    D = 8
    sched = _schedule(D, 16, seed=11, obliterate=True)
    ref = RefEngine(D, remove_slots=4, max_insert_len=8, ops_per_step=4, use_mesh=False,
                    megastep_k=4, max_segments=64, text_capacity=1024)
    for d in range(D):
        ref.ingest(d, _join("w0", 0))
    for i, (d, msg) in enumerate(sched):
        ref.ingest(d, msg)
        if (i + 1) % 17 == 0:
            ref.step()
    ref.step()
    return sched, [ref.text(d) for d in range(D)], [ref.annotations(d) for d in range(D)]


def test_engine_on_plane_matches_torch_plane(plane, ref_texts):
    """The whole serving path — ingest, staging ring, megastep dispatch,
    error readback, compaction — on the plane under test, against the same
    schedule on the torch plane (raw state and digest) and the reference's
    engine (texts and annotations)."""
    sched, texts, annos = ref_texts
    D = len(texts)
    eng = _run_engine(D, sched)
    assert not eng.errors().any()
    assert [eng.text(d) for d in range(D)] == texts
    assert [eng.annotations(d) for d in range(D)] == annos

    _restore_default_plane()
    ctl = _run_engine(D, sched)
    for a, b in zip(tk.leaves(eng.state), tk.leaves(ctl.state)):
        assert a.equal(b)
    assert fleet_digest(eng.state).equal(fleet_digest(ctl.state))


# ------------------------------------------------ cross-plane restore

@pytest.mark.parametrize(
    "writer_plane,reader_plane",
    [(NATIVE_PLANE, TORCH_PLANE), (TORCH_PLANE, NATIVE_PLANE)],
    ids=["native-to-torch", "torch-to-native"],
)
def test_checkpoint_round_trip_across_planes(writer_plane, reader_plane, tmp_path):
    """Checkpoints are plane-invariant: a checkpoint written under one
    plane restores under the other, and a full re-feed there is skipped
    and converges."""
    D = 8
    sched = _schedule(D, 10, seed=12)
    geom = dict(max_insert_len=8, ops_per_step=4, use_mesh=True, megastep_k=4,
                max_segments=64, text_capacity=1024, device="cpu")
    try:
        _register(writer_plane)
        eng = DocBatchEngine(D, checkpoint_store=CheckpointStore(str(tmp_path)),
                             checkpoint_every=3, **geom)
        for d in range(D):
            eng.ingest(d, _join("w0", 0))
        for i, (d, m) in enumerate(sched):
            eng.ingest(d, m)
            if i % 5 == 4:
                eng.step()
        eng.step()
        eng.maybe_checkpoint(force=True)
        expected = [eng.text(d) for d in range(D)]
        assert not eng.errors().any()
        del eng

        _register(reader_plane)
        eng2 = DocBatchEngine(D, checkpoint_store=CheckpointStore(str(tmp_path)), **geom)
        assert sorted(eng2.restore_from_checkpoints()) == list(range(D))
        assert [eng2.text(d) for d in range(D)] == expected
        for d in range(D):
            eng2.ingest(d, _join("w0", 0))
        for d, m in sched:
            eng2.ingest(d, m)
        eng2.step()
        assert [eng2.text(d) for d in range(D)] == expected
        assert eng2.health()["checkpointed_ops_skipped"] > 0
        assert not eng2.errors().any()
    finally:
        _restore_default_plane()


# --------------------------------------------- seg-lane loud degradation

def test_native_plane_seg_lanes_fall_back_loudly():
    """The native plane has no segment-parallel programs: an engine asked
    for seg_shards > 1 must not crash and must not pretend — it serves on
    the fleet path and counts the downgrade."""
    try:
        _register(NATIVE_PLANE)
        eng = DocBatchEngine(8, max_insert_len=8, ops_per_step=4, use_mesh=True,
                             seg_shards=2, max_segments=64, text_capacity=512, device="cpu")
        assert eng.seg_shards == 1
        assert eng._seg_megastep is None and eng._seg_compact is None
        assert eng.health()["seg_plane_unsupported"] == 1
        assert eng.enable_segment_sharding(0) is False
        eng.ingest(0, _join("w0", 0))
        eng.ingest(0, _ins(1, 0, "ab"))
        eng.step()
        assert eng.text(0) == "ab"
    finally:
        _restore_default_plane()


def test_torch_plane_keeps_seg_lanes():
    """The downgrade is the native plane's alone: on the torch plane the
    same request builds the lane programs and counts nothing."""
    eng = DocBatchEngine(8, max_insert_len=8, ops_per_step=4, use_mesh=True,
                         seg_shards=2, max_segments=64, text_capacity=512, device="cpu")
    assert eng.seg_shards == 2 and eng._seg_megastep is not None
    assert eng.health().get("seg_plane_unsupported", 0) == 0


def test_native_plane_raises_without_its_library(monkeypatch):
    """No fallback hides the plane: a library that does not build makes
    the engine's program factory raise."""
    plane = _register(NATIVE_PLANE)
    try:
        monkeypatch.setattr(megastep_native, "warm", lambda: False)
        with pytest.raises(RuntimeError, match="libtpumegastep"):
            plane.mesh_fleet_program(tk.apply_megastep, plane.doc_mesh("cpu"))
        with pytest.raises(RuntimeError, match="libtpumegastep"):
            DocBatchEngine(2, device="cpu", max_segments=32, text_capacity=128)
    finally:
        _restore_default_plane()


def test_native_library_is_the_ports_own():
    """The library is built from the port's own source into the port's
    ``_build/``, never from or into the repository-root ``native/``."""
    pkg = ROOT / "fluidframework_tpu_torch"
    assert megastep_native.SRC == pkg / "native" / "megastep.cpp"
    assert megastep_native.available()
    lib = megastep_native.library_path()
    assert lib.parent == pkg / "_build" and lib.name.startswith("libtpumegastep-")
    assert lib.exists()


# ---------------------------------------------------- the provider variable

_PROBE = (
    "import sys\n"
    "from fluidframework_tpu_torch.models.dispatch import dispatch_plane\n"
    "print(dispatch_plane().__name__)\n"
    "print(any(m == 'fluidframework_tpu' or m.startswith('fluidframework_tpu.')"
    " for m in sys.modules))\n"
)


def _probe(**env_vars) -> list[str]:
    env = {k: v for k, v in os.environ.items()
           if k not in ("FFTPU_TORCH_DISPATCH_PLANE", "FFTPU_DISPATCH_PLANE")}
    env.update(env_vars, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_provider_variable_selects_the_native_plane():
    assert _probe(FFTPU_TORCH_DISPATCH_PLANE=NATIVE_PLANE) == [NATIVE_PLANE, "False"]
    assert _probe() == [TORCH_PLANE, "False"]


def test_reference_provider_variable_loads_nothing_into_the_port():
    assert _probe(FFTPU_DISPATCH_PLANE="fluidframework_tpu.parallel.native_plane") == [
        TORCH_PLANE, "False"]


def test_provider_that_registers_nothing_raises(monkeypatch):
    monkeypatch.setattr(dispatch, "_PLANE", None)
    monkeypatch.setenv(dispatch.PROVIDER_ENV, "fluidframework_tpu_torch.utils.telemetry")
    try:
        with pytest.raises(RuntimeError, match="did not register a plane"):
            dispatch.dispatch_plane()
    finally:
        _restore_default_plane()
