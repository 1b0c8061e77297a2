"""The live service: an open loop at a fixed rate.

The fleet is booted in set-up (each doc's joins and prefix history).  In the window the harness does what the
serving consumer does: it takes every op due by now, ingests each doc's
due lines through ``ingest_lines``, steps, and repeats; it waits only
when nothing is due.  An op's latency runs from its due time to the end
of the step that applied it (ending in a device synchronise).  Ops due
inside the window are all applied, a late one after the window closes,
and every one counts."""

from __future__ import annotations

import time

import numpy as np

from .. import traffic as tr

LATE_LIMIT_S = 60.0  # past the window's close, an op still unapplied has failed


def prepare(family, spec: dict, cell: dict, seed: int, seconds: float, rate=None):
    rate = float(rate if rate is not None else cell["rate_ops_per_s"])
    return tr.Schedule(spec, family.n_docs, rate, seconds, tr.seeded_rng(seed, 1))


def warm(family, data, spec: dict, spans, sync):
    """The serving engine: built, warmed, every doc booted."""
    return family.boot(data.boot, spans, sync)


def run(family, data, spec: dict, seconds: float, spans, sync, eng,
        clock=time.perf_counter) -> dict:
    compact = bool(spec.get("compact"))
    n = int(np.searchsorted(data.due, seconds, side="left"))
    lat = np.full(n, np.nan)
    done = []
    t0 = clock()
    i = 0
    while i < n:
        now = clock() - t0
        if now > seconds + LATE_LIMIT_S:
            break
        j = min(int(np.searchsorted(data.due, now, side="right")), n)
        if j == i:
            time.sleep(max(0.0, float(data.due[i]) - now))
            continue
        with spans("ingest", j - i):
            for d, blob, _k in tr.group_by_doc(data.doc, data.line, i, j):
                family.ingest(eng, d, blob)
        with spans("step", j - i):
            family.step(eng, compact)
            sync()
        t = clock() - t0
        lat[i:j] = t - data.due[i:j]
        if t <= seconds:
            done.append((t, j - i))
        i = j
    applied = i
    return {
        "window_s": seconds, "done": done, "attempted": n, "failed": n - applied, "latencies": lat[:applied],
        "checked": [(eng, applied)], "lines": data.doc_lines, "doc_ops": data.doc_ops,
        "drained": False,
    }
