"""The port's boundaries: it imports without JAX or the JAX package, its
entry points refuse to fall back to the CPU, and the chip smoke script
refuses to run without a card."""

from __future__ import annotations

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
