"""loadgen: the multi-process traffic plant.

A port of ``fluidframework_tpu/loadgen/`` (no JAX in it): the fleets it
spawns serve on the card unless the caller asks for the CPU
(``run_loadgen(..., device="cpu")``); the workers are host-only clients
and never initialise CUDA.

A coordinator process spawns N worker OS processes, each owning real
client sessions over real TCP sockets against the composed service stack
(netserver fronts + sequencer + historian snapshot tier + checkpointed
device fleets behind FleetConsumer, the deploy/compose.yaml topology).
Workers run seeded mixed workloads (SharedString, SharedTree, SharedMap,
SharedMatrix, channel-level strings with interval collections and
undo-redo, scoped presence signals) through phase barriers
(ramp -> steady -> boot_storm -> drain) and ship lossless latency
histograms back; the coordinator merges them, scrapes the fleet and
historian metrics surfaces, and ends with a per-family byte-identity
convergence verdict against host oracle replays.

Entry points: ``coordinator.run_loadgen`` (in-process orchestration, used
by ``chip_smoke.py``'s ``loadgen`` phase and the CPU smoke test) and
``python -m fluidframework_tpu_torch.loadgen.worker`` (one worker process).
"""

from .schedule import (
    FAMILIES,
    PHASES,
    DocSpec,
    LoadSchedule,
    WorkerSchedule,
    make_load_schedule,
)

__all__ = [
    "FAMILIES",
    "PHASES",
    "DocSpec",
    "LoadSchedule",
    "WorkerSchedule",
    "make_load_schedule",
]
