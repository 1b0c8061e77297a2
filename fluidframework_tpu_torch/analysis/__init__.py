"""fftpu-torch-check: AST/import-graph static analysis over the port.

A copy of ``fluidframework_tpu/analysis`` (pure stdlib AST passes, no torch
and no JAX import): the passes are the reference's line for line, so a
fixture package gives the same findings under either; only the CLI's
default package and the committed ``layers.json``/``baseline.json`` (over
``fluidframework_tpu_torch/``) are the port's own.

Reference parity: the Fluid repo machine-enforces its architecture
(``layerInfo.json`` + the ``layer-check`` build command, SURVEY §1).  This
package is that idea widened to the hazard classes the reference's own
history documents: a staging-aliasing bug was a use-after-donate, the
recompile watchdog only catches trace despecialization at *runtime*,
byte-identity convergence (BASELINE.json's core invariant) dies silently to
any nondeterministic host-path construct, and the concurrency plane's
lock/donation laws lived only in prose.  Eleven passes,
pure AST (no JAX import), findings suppressible via a committed
``baseline.json``:

- ``layer_check``      — downward-only imports per ``layers.json``
- ``jit_safety``       — trace hazards reachable from jit/shard_map entries
- ``donation``         — use-after-donate of ``donate_argnums`` arguments
- ``determinism``      — nondeterministic constructs in byte-identity paths
- ``threads``          — unlocked cross-thread attribute mutation
- ``swallowed``        — silently dropped exceptions in serving layers
- ``markchurn``        — mark-object churn back in the pooled tree fold
- ``lock_order``       — static deadlock detection (lock-acquisition graph)
- ``lock_consistency`` — lockset guard checking (lock A here, B there)
- ``blocking``         — blocking syscalls under declared critical locks
- ``mesh_safety``      — collective axis/spec/donation hazards in
  shard_map programs

The lock passes share one call-graph/lock-inheritance engine
(``core.PackageView``/``LockFlowScan``/``walk_lock_flow``) — per-pass
visitors over one worklist, not four private walkers.

Run ``fftpu-torch-check fluidframework_tpu_torch/`` (registered in
pyproject), or see ``tests/test_torch_analysis.py::test_package_is_clean``
— the port's tier-1 gate that keeps every future PR clean.
"""

from .core import Baseline, Finding, PackageIndex, load_package  # noqa: F401

__all__ = ["Baseline", "Finding", "PackageIndex", "load_package"]
