"""Catch-up: a fleet booted in set-up replays its docs' backlog.

Set-up builds the engine and boots every doc (its joins and prefix
history, applied).  The window then works the backlog unit by unit: each
doc's lines of the unit through one ``ingest_lines`` call, as the serving
consumer passes a doc's whole ready feed, then one step (``step()``
applies everything staged) and a compact.  The window closes at the end
of the step in flight once ``seconds`` have passed, or when the backlog
runs out, so the rate counts every op the window applied over all of its
time.

The window runs on one intra-op thread with the set-up's objects frozen
out of the collector: the host paces this cell, and on the card's host a
pool of idle intra-op threads and collections that walk the backlog's
lines (the harness's data, not the program's) only add to the host's swing.
Both are put back when the window closes."""

from __future__ import annotations

import gc
import time

from .. import traffic as tr


def prepare(family, spec: dict, cell: dict, seed: int, seconds: float, rate=None):
    return tr.Backlog(spec, family.n_docs, tr.seeded_rng(seed, 1))


def warm(family, data, spec: dict, spans, sync):
    return family.boot(data.boot, spans, sync)


def run(family, data, spec: dict, seconds: float, spans, sync, eng,
        clock=time.perf_counter) -> dict:
    import torch

    compact = bool(spec.get("compact"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.freeze()
    try:
        t0 = clock()
        done = []        # (seconds into the window, ops) of every step
        t = t0
        for k, unit in enumerate(data.units):
            with spans("ingest", data.unit_ops[k]):
                for d, blob, _n in unit:
                    family.ingest(eng, d, blob)
            with spans("step", data.unit_ops[k]):
                family.step(eng, compact)
                sync()
            t = clock()
            done.append((t - t0, data.unit_ops[k]))
            if t - t0 >= seconds:
                break
    finally:
        gc.unfreeze()
        torch.set_num_threads(threads)
    return {
        "window_s": t - t0, "done": done, "attempted": sum(n for _t, n in done), "failed": 0, "latencies": None,
        "checked": [(eng, len(done))], "lines": data.doc_lines, "doc_ops": data.doc_ops,
        "drained": len(done) == len(data.units),
    }
