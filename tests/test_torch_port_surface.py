"""The port's boundaries: it imports without JAX or the JAX package, its
entry points refuse to fall back to the CPU, and the chip smoke script
refuses to run without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKER = textwrap.dedent(
    """
    import importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "fluidframework_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Blocker())
    import fluidframework_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        fluidframework_tpu_torch.__path__, "fluidframework_tpu_torch.")]
    for name in names:
        __import__(name)
    import chip_smoke
    sys.path.insert(0, "tests")
    import torch_rank_worker  # a rank of the cross-card tests' gloo worlds
    leaked = sorted(m for m in sys.modules
                    if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print(" ".join(names))
    """
)

# Modules the blocker must reach by name (the walk finds every module; these
# pin that the wire-ingest, observability and serving layers, the
# SharedString client path, the tree, matrix and map channels with the
# flat forest, the loader, drivers and network service plane, and the
# lambda pipeline with the native sequencer, the fault, replay and
# virtual-storage drivers, the fuzz harness and the chaos soak, and the
# native dispatch plane, the loadgen plant, the tools and utils/config, and
# the rest of the DDS family, the legacy v1 sequence snapshots, the snapshot
# corpus and reference-artifact loaders, the rest of the framework, and the
# static analyzer with the debugger driver and devtools are among them).
_REQUIRED = {
    "fluidframework_tpu_torch.server.scribe",
    "fluidframework_tpu_torch.server.failover",
    "fluidframework_tpu_torch.server.fleet_consumer",
    "fluidframework_tpu_torch.server.fleet_main",
    "fluidframework_tpu_torch.server.gitstore",
    "fluidframework_tpu_torch.runtime.summary",
    "fluidframework_tpu_torch.native.ingest_native",
    "fluidframework_tpu_torch.observability.flight_recorder",
    "fluidframework_tpu_torch.observability.metrics_plane",
    "fluidframework_tpu_torch.utils.telemetry",
    "fluidframework_tpu_torch.protocol.messages",
    "fluidframework_tpu_torch.models.doc_batch_engine",
    "fluidframework_tpu_torch.models.tree_batch_engine",
    "fluidframework_tpu_torch.dds.kernel_backend",
    "fluidframework_tpu_torch.dds.channels",
    "fluidframework_tpu_torch.dds.shared_string",
    "fluidframework_tpu_torch.dds.markers",
    "fluidframework_tpu_torch.dds.sequence_intervals",
    "fluidframework_tpu_torch.protocol.channel",
    "fluidframework_tpu_torch.protocol.marker_plane",
    "fluidframework_tpu_torch.protocol.snapshot_formats",
    "fluidframework_tpu_torch.protocol.driver_contracts",
    "fluidframework_tpu_torch.server.sequencer",
    "fluidframework_tpu_torch.server.local_service",
    "fluidframework_tpu_torch.driver.service_registry",
    "fluidframework_tpu_torch.runtime.container_runtime",
    "fluidframework_tpu_torch.runtime.datastore",
    "fluidframework_tpu_torch.runtime.op_lifecycle",
    "fluidframework_tpu_torch.runtime.pending_state",
    "fluidframework_tpu_torch.runtime.gc",
    "fluidframework_tpu_torch.runtime.blob_manager",
    "fluidframework_tpu_torch.runtime.handles",
    "fluidframework_tpu_torch.runtime.errors",
    "fluidframework_tpu_torch.runtime.channel",
    "fluidframework_tpu_torch.runtime.snapshot_formats",
    "fluidframework_tpu_torch.framework.attributor",
    "fluidframework_tpu_torch.utils.id_compressor",
    "fluidframework_tpu_torch.dds.tree.schema",
    "fluidframework_tpu_torch.dds.tree.shared_tree",
    "fluidframework_tpu_torch.dds.tree.branch",
    "fluidframework_tpu_torch.dds.tree.simple_tree",
    "fluidframework_tpu_torch.dds.tree.reference_summary",
    "fluidframework_tpu_torch.dds.shared_map",
    "fluidframework_tpu_torch.dds.shared_matrix",
    "fluidframework_tpu_torch.framework.undo_redo",
    "fluidframework_tpu_torch.ops.tree_kernel",
    "fluidframework_tpu_torch.loader.container",
    "fluidframework_tpu_torch.loader.delta_manager",
    "fluidframework_tpu_torch.loader.connection_manager",
    "fluidframework_tpu_torch.loader.audience",
    "fluidframework_tpu_torch.loader.protocol",
    "fluidframework_tpu_torch.driver.definitions",
    "fluidframework_tpu_torch.driver.local_driver",
    "fluidframework_tpu_torch.driver.network_driver",
    "fluidframework_tpu_torch.server.netserver",
    "fluidframework_tpu_torch.server.launcher",
    "fluidframework_tpu_torch.server.auth",
    "fluidframework_tpu_torch.server.admission",
    "fluidframework_tpu_torch.fanout.plane",
    "fluidframework_tpu_torch.fanout.frames",
    "fluidframework_tpu_torch.fanout.writer",
    "fluidframework_tpu_torch.fanout.historian",
    "fluidframework_tpu_torch.testing.network_env",
    "fluidframework_tpu_torch.framework.presence",
    "fluidframework_tpu_torch.native.sequencer_native",
    "fluidframework_tpu_torch.native.gxx",
    "fluidframework_tpu_torch.server.lambdas",
    "fluidframework_tpu_torch.server.partition_manager",
    "fluidframework_tpu_torch.driver.fault_injection",
    "fluidframework_tpu_torch.driver.replay_driver",
    "fluidframework_tpu_torch.driver.virtual_storage",
    "fluidframework_tpu_torch.testing.fuzz",
    "fluidframework_tpu_torch.testing.chaos",
    "fluidframework_tpu_torch.native.megastep_native",
    "fluidframework_tpu_torch.parallel.native_plane",
    "fluidframework_tpu_torch.utils.config",
    "fluidframework_tpu_torch.loadgen.schedule",
    "fluidframework_tpu_torch.loadgen.worker",
    "fluidframework_tpu_torch.loadgen.coordinator",
    "fluidframework_tpu_torch.tools.trace_viewer",
    "fluidframework_tpu_torch.tools.summary_inspect",
    "fluidframework_tpu_torch.tools.replay_tool",
    "fluidframework_tpu_torch.dds.small",
    "fluidframework_tpu_torch.dds.extras",
    "fluidframework_tpu_torch.dds.ot",
    "fluidframework_tpu_torch.dds.ot_json1",
    "fluidframework_tpu_torch.dds.property_dds",
    "fluidframework_tpu_torch.dds.snapshot_v1",
    "fluidframework_tpu_torch.testing.snapshot_corpus",
    "fluidframework_tpu_torch.testing.reference_snapshots",
    "fluidframework_tpu_torch.testing.reference_traces",
    "fluidframework_tpu_torch.framework.request_handler",
    "fluidframework_tpu_torch.framework.aqueduct",
    "fluidframework_tpu_torch.framework.fluid_static",
    "fluidframework_tpu_torch.framework.service_client",
    "fluidframework_tpu_torch.framework.interceptions",
    "fluidframework_tpu_torch.framework.oldest_client",
    "fluidframework_tpu_torch.framework.agent_scheduler",
    "fluidframework_tpu_torch.framework.synthesize",
    "fluidframework_tpu_torch.framework.bindings",
    "fluidframework_tpu_torch.framework.tree_agent",
    "fluidframework_tpu_torch.analysis",
    *(f"fluidframework_tpu_torch.analysis.{m}" for m in (
        "core", "layer_check", "swallowed", "determinism", "markchurn", "jit_safety",
        "donation", "mesh_safety", "threads", "lock_order", "lock_consistency", "blocking",
        "cli")),
    "fluidframework_tpu_torch.driver.debugger_driver",
    "fluidframework_tpu_torch.tools.devtools",
}


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 70  # every module of the port was imported
    assert _REQUIRED <= names, sorted(_REQUIRED - names)


def test_blocker_blocks_the_jax_package():
    """The prefix check blocks ``fluidframework_tpu`` itself (so the test
    above proves something) without blocking ``fluidframework_tpu_torch``."""
    script = _BLOCKER.split("import fluidframework_tpu_torch")[0] + (
        "import fluidframework_tpu_torch\n"
        "try:\n    import fluidframework_tpu.protocol.stamps\nexcept ImportError:\n"
        "    print('blocked')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "blocked"


def test_entry_points_refuse_a_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    from fluidframework_tpu_torch.parallel import mesh

    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
    from fluidframework_tpu_torch.dds.tree.mark_pool import MarkPool
    from fluidframework_tpu_torch.ops import map_kernel, matrix_kernel

    for call in (lambda: mesh.doc_mesh(), lambda: mesh.docs_segs_mesh(),
                 lambda: DeviceRebaser(MarkPool()), lambda: map_kernel.init_state(),
                 lambda: matrix_kernel.init_state(), lambda: KernelMergeTree()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_serving_entry_points_refuse_a_silent_cpu(tmp_path):
    """The scribe, its pool, its kernel-backed replicas and ``fleet_main``
    default to the card as well, and say how to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    from fluidframework_tpu_torch.server import scribe
    from fluidframework_tpu_torch.server.fleet_main import main
    from fluidframework_tpu_torch.server.ordered_log import Topic
    from fluidframework_tpu_torch.server.partition_manager import ScribePool

    for call in (lambda: scribe.ScribeLambda(Topic("t"), str(tmp_path)),
                 lambda: ScribePool(Topic("t"), str(tmp_path)),
                 lambda: scribe._MapDocScribe(), lambda: scribe._MatrixDocScribe(),
                 lambda: main(["--port", "1", "--docs", "a"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    # Alone in a directory, without the port beside it.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_kernel_library_types_every_entry_point_and_refuses_without_nvcc(monkeypatch, tmp_path):
    """Every ``extern "C"`` entry point of ``csrc/*.cu`` has its argument
    types in ``cuda_build.ENTRY_POINTS`` (ctypes would otherwise pass each
    pointer as a 32-bit int), and a build without ``nvcc`` raises."""
    import re

    from fluidframework_tpu_torch.ops import cuda_build

    entries = set()
    for src in cuda_build.sources():
        entries |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert entries == set(cuda_build.ENTRY_POINTS)
    assert {"resolve_positions.cu", "rebase_window.cu"} <= {s.name for s in cuda_build.sources()}
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "library_path", lambda: tmp_path / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()


# ------------------------------------------------------------- completeness
# Read from both packages' sources with ``ast`` (the JAX package is never
# imported here): every module of the JAX package has its counterpart in
# the port, and every public top-level function, class, method and
# assigned name (not an imported one) of a reference module exists in the
# counterpart or stands below with its reason.  A reason that names ``module.py:name`` is a
# rename or a move, and that name must exist there.

REF_ROOT = ROOT / "fluidframework_tpu"
PORT_ROOT = ROOT / "fluidframework_tpu_torch"
COUNTERPART = {"ops/pallas_kernels.py": "ops/resolve_kernel.py"}

NOT_CARRIED = {
    "ops/pallas_kernels.py": {
        "BLOCK": ("the search's tile, renamed", "ops/resolve_kernel.py:TILE"),
        "resolve_positions_pallas": ("K1's entry, the CUDA kernels on a card",
                                     "ops/resolve_kernel.py:resolve_positions"),
        "resolve_positions_blocked": ("the backend-dispatching entry: the port's entry "
                                      "dispatches on the tensors' device",
                                      "ops/resolve_kernel.py:resolve_positions"),
        "resolve_positions_reference": ("K1's plain version",
                                        "ops/resolve_kernel.py:resolve_positions_plain"),
    },
    "ops/tree_kernel.py": {
        "rebase_window_jit": ("a jit wrapper; the port's function takes any window count W",
                              "ops/tree_kernel.py:rebase_window_kernel"),
        "rebase_window_batched": ("a vmap over windows; the port's function takes [W, ...]",
                                  "ops/tree_kernel.py:rebase_window_kernel"),
    },
    "ops/matrix_kernel.py": {
        "apply_op": ("one op's switch, folded into the batched apply's per-kind branch",
                     "ops/matrix_kernel.py:_branch"),
    },
    "ops/mergetree_kernel.py": {
        "apply_op_seg": ("one op on a segment lane, private in the port",
                         "ops/mergetree_kernel.py:_apply_op_seg"),
        "apply_ops_seg": ("one [B] batch on a segment lane: the lane megastep with K = 1",
                          "ops/mergetree_kernel.py:apply_megastep_seg"),
        "SEG_RESOLVE_PALLAS": ("the reference's route switch (default off); the port's "
                               "segment lane always resolves through K1's entry",
                               "ops/mergetree_kernel.py:resolve_positions"),
    },
    "observability/flight_recorder.py": {
        "RecompileWatchdog": ("counts XLA executable-cache growth; the port compiles "
                              "nothing at run time (see the module's docstring)", None),
        "RecompileWatchdog.poll": ("part of RecompileWatchdog", None),
        "RecompileWatchdog.register": ("part of RecompileWatchdog", None),
    },
    "parallel/mesh.py": {
        name: ("PartitionSpec machinery of the JAX mesh; the port's shards are row "
               "blocks of one state (or one a rank), with no sharding specs", None)
        for name in ("FLEET_STATE_RULES", "fleet_state_specs", "match_partition_rules",
                     "named_leaves", "op_spec", "replicate")
    },
    "parallel/native_plane.py": {
        name: ("PartitionSpec machinery re-exported from the JAX mesh", None)
        for name in ("P", "fleet_state_specs", "replicate")
    },
    "models/staging.py": {
        "RowQueue.append": ("one row; never called in the reference, and the port's "
                            "extend_rows takes a list of one",
                            "models/staging.py:RowQueue.extend_rows"),
        "StagingRing.launched": ("arms the reuse barrier with the uploaded jax arrays; "
                                 "the port's upload records a CUDA event itself",
                                 "models/staging.py:StagingRing.upload"),
        "upload_replicated": ("moved beside the mesh it replicates over",
                              "parallel/mesh.py:upload_replicated"),
    },
    "ops/map_kernel.py": {
        "ERR_KEY_OVERFLOW": ("defined and never read in the reference", None),
    },
}


def _public(tree: ast.Module) -> set[str]:
    """Public top-level functions, classes, methods and assigned names."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return {n for n in out if not any(p.startswith("_") for p in n.split("."))}


def _bindings(body: list) -> tuple[set[str], list[ast.ClassDef]]:
    """The names a block binds (through ``if``/``try``/``with``/loop
    blocks, not into function bodies), and the classes it defines."""
    names, classes = set(), []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes.append(node)
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
            continue
        for field in ("targets", "target"):
            for t in (getattr(node, field, None) or [] if field == "targets"
                      else [getattr(node, field, None)]):
                if t is not None:
                    names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        for block in ("body", "orelse", "finalbody"):
            inner, more = _bindings(getattr(node, block, None) or [])
            names |= inner
            classes += more
        for handler in getattr(node, "handlers", None) or []:
            inner, more = _bindings(handler.body)
            names |= inner
            classes += more
    return names, classes


def _defined(tree: ast.Module) -> set[str]:
    """Every name a module binds at top level (conditional definitions and
    imports included), and every attribute its classes bind."""
    out, classes = _bindings(tree.body)
    for cls in classes:
        out |= {f"{cls.name}.{n}" for n in _bindings(cls.body)[0]}
    return out


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


_SUBPACKAGES = sorted({p.relative_to(REF_ROOT).parts[0] if p.parent != REF_ROOT else "."
                       for p in REF_ROOT.rglob("*.py")})


@pytest.mark.parametrize("subpackage", _SUBPACKAGES)
def test_port_carries_every_module_and_public_name(subpackage):
    """Each reference module of ``subpackage`` has its counterpart, and each
    of its public names exists there or has a ``NOT_CARRIED`` reason; every
    entry of ``NOT_CARRIED`` is still needed."""
    top = REF_ROOT if subpackage == "." else REF_ROOT / subpackage
    modules = sorted(top.glob("*.py") if subpackage == "." else top.rglob("*.py"))
    assert modules
    missing, stale = [], []
    for path in modules:
        rel = path.relative_to(REF_ROOT).as_posix()
        port = PORT_ROOT / COUNTERPART.get(rel, rel)
        assert port.is_file(), f"no counterpart of {rel}"
        public, defined = _public(_parse(path)), _defined(_parse(port))
        reasons = NOT_CARRIED.get(rel, {})
        missing += [f"{rel}:{n}" for n in sorted(public - defined - set(reasons))]
        stale += [f"{rel}:{n}" for n in sorted(reasons) if n not in public or n in defined]
        for name, (reason, carried_as) in reasons.items():
            assert reason, name
            if carried_as is not None:
                where, attr = carried_as.split(":")
                assert attr in _defined(_parse(PORT_ROOT / where)), carried_as
    assert not missing, f"public names the port lacks: {missing}"
    assert not stale, f"NOT_CARRIED entries the port no longer needs: {stale}"


def test_not_carried_is_reachable_and_names_no_engine():
    """Every ``NOT_CARRIED`` module is a reference module the walk reaches,
    and no entry is one of the engines: both run every path of the
    reference."""
    for rel, names in NOT_CARRIED.items():
        assert (REF_ROOT / rel).is_file(), rel
        assert not any(n.split(".")[0] in ("TreeBatchEngine", "DocBatchEngine") for n in names)
