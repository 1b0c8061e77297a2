"""Seeded load schedules: the deterministic half of the traffic plant.

A copy of ``fluidframework_tpu/loadgen/schedule.py``: the same seed and
docs give the same schedule JSON as the reference's, byte for byte.

Same determinism contract as ``testing.chaos.ChaosSchedule``: the same
seed produces the same schedule, and a schedule survives a JSON
round-trip bit-identically — so a run's exact workload can be committed
next to its artifact and replayed.  The coordinator builds ONE
``LoadSchedule`` and hands each worker process its ``WorkerSchedule``
(plus the shared doc/scope tables) through a config file; everything a
worker does — op counts, op mix, Zipf doc picks, churn points, presence
scopes — derives from its per-worker seed.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field

# Phase order is the barrier order the coordinator drives: connect and
# warm every family, sustain the mixed load (with reconnect churn and
# presence), hammer the historian snapshot tier, then settle + verdict.
PHASES = ("ramp", "steady", "boot_storm", "drain")

# Workload matrix: one replica family per doc.  ``string``/``tree`` docs
# are additionally consumed by device fleet processes; the channel-level
# families converge writer-to-writer and against host oracle replays.
FAMILIES = ("string", "tree", "map", "matrix", "chan_string")

# Presence scope universe: workers subscribe to a strict subset and
# publish across the whole universe, so the fanout plane's scoped-drop
# path is exercised on every run.
DEFAULT_SCOPES = ("audience", "cursor", "editor", "viewport")


@dataclass
class DocSpec:
    """One document in the plant: its replica family and home shard."""

    doc_id: str
    family: str  # one of FAMILIES
    shard: int   # index into the topology's shard list


@dataclass
class WorkerSchedule:
    """One worker process's seeded script."""

    worker_id: int
    seed: int
    ramp_ops: int         # ops after the per-doc warmup edits
    steady_ops: int       # mixed-load ops in the steady phase
    boots: int            # historian cold boots in the boot-storm phase
    reconnect_every: int  # steady: tear a random session every N ops (0 = never)
    signal_every: int     # steady: presence signal every N ops (0 = never)
    interests: list = field(default_factory=list)  # subscribed scope keys


@dataclass
class LoadSchedule:
    """The whole run's script: docs, scopes, and every worker's share."""

    seed: int
    zipf_a: float
    scopes: list = field(default_factory=list)
    docs: list = field(default_factory=list)     # DocSpec
    workers: list = field(default_factory=list)  # WorkerSchedule

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "zipf_a": self.zipf_a,
                "scopes": list(self.scopes),
                "docs": [asdict(d) for d in self.docs],
                "workers": [asdict(w) for w in self.workers],
            },
            indent=2,
        )

    @staticmethod
    def from_json(raw: str) -> "LoadSchedule":
        d = json.loads(raw)
        return LoadSchedule(
            seed=d["seed"],
            zipf_a=d["zipf_a"],
            scopes=list(d["scopes"]),
            docs=[DocSpec(**s) for s in d["docs"]],
            workers=[WorkerSchedule(**w) for w in d["workers"]],
        )


def zipf_weights(n: int, a: float) -> list:
    """Zipf popularity over ranks 0..n-1 (rank 0 hottest) — the same
    ranking idiom the chaos harness uses, so doc heat is comparable."""
    return [1.0 / (i + 1) ** a for i in range(n)]


def make_load_schedule(
    seed: int,
    n_workers: int,
    docs: list,
    ramp_ops: int = 8,
    steady_ops: int = 24,
    boots: int = 6,
    zipf_a: float = 1.2,
    scopes=DEFAULT_SCOPES,
    reconnect_every: int = 9,
    signal_every: int = 4,
) -> LoadSchedule:
    """Deterministic schedule from a seed.

    Per-worker op counts jitter ±25% so workers are heterogeneous (the
    barrier sees stragglers), and every worker subscribes to a strict
    subset of the scope universe — publishing across the full universe
    then GUARANTEES scoped-presence drops at the fanout plane.
    """
    rng = random.Random(seed)
    scope_list = list(scopes)
    workers: list = []
    for wid in range(n_workers):
        w_seed = rng.getrandbits(32)
        k = rng.randint(1, max(1, len(scope_list) - 1))
        interests = sorted(rng.sample(scope_list, k))
        workers.append(WorkerSchedule(
            worker_id=wid,
            seed=w_seed,
            ramp_ops=max(1, ramp_ops + rng.randint(-(ramp_ops // 4), ramp_ops // 4)),
            steady_ops=max(
                1, steady_ops + rng.randint(-(steady_ops // 4), steady_ops // 4)
            ),
            boots=boots,
            reconnect_every=reconnect_every,
            signal_every=signal_every,
            interests=interests,
        ))
    return LoadSchedule(
        seed=seed,
        zipf_a=zipf_a,
        scopes=sorted(scope_list),
        docs=list(docs),
        workers=workers,
    )
