"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Run it as ``python3 -m fleetbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from collections import defaultdict

import numpy as np

from . import spec
from .roofline import peaks
from .traffic import seeded_rng

FORBIDDEN = ("jax", "jaxlib", "flax", "fluidframework_tpu")
OUT_DIR = spec.HERE / ".out"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


TRACE_S = 20.0  # the traced part of a traced window: the trace's reading grows with it


class Spans:
    """Host time per harness span (``boot``, ``ingest``, ``step``) and the
    ops each covered.  With a ``profiler`` the window's first ``trace_s``
    seconds are traced, up to the end of the span in flight: a
    ``fleetbench.traced`` profiler range around them and one of each span's
    name inside it.  ``traced`` then holds the spans' totals of that part."""

    def __init__(self, profiler=None, trace_s: float = TRACE_S):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.ops = defaultdict(int)
        self.profiler = profiler
        self.trace_s = trace_s
        self.traced = None
        self._range = None
        self._t0 = 0.0

    def start(self) -> None:
        if self.profiler is None:
            return
        import torch

        self.profiler.__enter__()
        self._range = torch.profiler.record_function("fleetbench.traced")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._range is None:
            return
        self._range.__exit__(None, None, None)
        self._range = None
        self.profiler.__exit__(None, None, None)
        self.traced = Run(seconds=dict(self.seconds), calls=dict(self.calls), ops=dict(self.ops))

    @contextlib.contextmanager
    def __call__(self, name: str, ops: int = 0):
        if self._range is not None:
            import torch

            rf = torch.profiler.record_function("fleetbench." + name)
        else:
            rf = contextlib.nullcontext()
        t = time.perf_counter()
        with rf:
            yield
        end = time.perf_counter()
        self.seconds[name] += end - t
        self.calls[name] += 1
        self.ops[name] += ops
        if self._range is not None and end - self._t0 >= self.trace_s:
            self.stop()


class Run:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sample(out: dict, n_docs: int, cell: dict, seed: int, applied: int) -> list[int]:
    """The docs to compare: the busiest of the run and a seeded draw."""
    want = cell["sample"]
    ops = out["doc_ops"](n_docs, applied)
    heavy = [int(d) for d in np.argsort(-ops, kind="stable")[: want["heavy"]]]
    rest = np.setdiff1d(np.arange(n_docs), heavy)
    k = min(want["random"], len(rest))
    drawn = seeded_rng(seed, 2).choice(rest, size=k, replace=False)
    return sorted(set(heavy) | {int(d) for d in drawn})


def check(family, out: dict, cell: dict, seed: int, control: bool) -> dict:
    """Every number compared, with its limit.  The program's views of the
    sampled docs are read first and the engines freed; the reference then
    replays the lines each engine applied.  A doc that left the fleet batch
    (an overflow lane, quarantine, a host oracle) was not served by the
    timed programs, so none may.  With ``control`` the views come from the
    reference itself with each doc's last op left out (an op applied not
    once but never), which has to come out as not correct."""
    views = []
    off_path = 0
    for eng, applied in out["checked"]:
        off_path += family.off_path(eng)
        docs = _sample(out, family.n_docs, cell, seed, applied)
        views.append((applied, docs, [family.view(eng, d) for d in docs]))
    out["checked"] = None
    gc.collect()
    differing = compared = 0
    for applied, docs, got in views:
        for d, view in zip(docs, got):
            data = out["lines"](d, applied)
            if control:
                lines = data.rstrip(b"\n").split(b"\n")
                view = family.reference_view(b"\n".join(lines[:-1]) + b"\n")
            differing += view != family.reference_view(data)
            compared += 1
    checks = {
        "docs_differing": {"value": differing, "limit": 0, "rule": "<="},
        "docs_compared": {"value": compared, "limit": 1, "rule": ">="},
        "docs_off_path": {"value": off_path, "limit": 0, "rule": "<="},
    }
    if out["latencies"] is not None:
        checks["ops_unapplied"] = {"value": out["failed"], "limit": 0, "rule": "<="}
    return checks


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<=" else c["value"] >= c["limit"]
               for c in checks.values())


def run_cell(name: str, cell: dict, config: dict, traffic: dict, metrics: list[dict],
             seed: int, seconds: float, trace: bool, device: str, t_start: float,
             rate=None, control: bool = False, hooks=None) -> dict:
    """The run, as a result dict (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, ``checks``).
    ``hooks`` may replace parts of the path under test (the fault tests)."""
    import torch

    from . import trace as tracing

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    family = spec.family(config["family"])(config, device)
    if hooks:
        hooks(family)
    drv = spec.drive(traffic["drive"])
    spans = Spans()
    data = drv.prepare(family, traffic, cell, seed, seconds, rate=rate)
    warm = drv.warm(family, data, traffic, spans, sync)
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_start

    prof = tracing.profile_window() if trace and on_card else None
    spans = Spans(prof)
    t_open = time.perf_counter()
    spans.start()
    try:
        out = drv.run(family, data, traffic, seconds, spans, sync, warm)
    finally:
        spans.stop()
    window_wall = time.perf_counter() - t_open
    warm = None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}

    summary = None
    if spans.traced is not None:
        OUT_DIR.mkdir(exist_ok=True)
        path = str(OUT_DIR / "window_trace.json")
        prof.export_chrome_trace(path)
        prof = None
        summary = tracing.summarize(path)
        os.remove(path)
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
    run = Run(cell=name, config=config, traffic=traffic, geometry=family.geometry,
              n_docs=family.n_docs, setup_s=setup_s, out=out, trace=summary,
              spans=spans.traced if spans.traced is not None else spans,
              peaks=peaks(dev["kind"]))
    values = {}
    for m in metrics:
        v = spec.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = check(family, out, cell, seed, control)
    result = {
        "correct": passes(checks), "attempted": int(out["attempted"]),
        "failed": int(out["failed"]), "metrics": values, "device": dev,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    result["diag"] = {
        "spans_s": dict(spans.seconds), "span_calls": dict(spans.calls),
        "steps": len(out["done"]), "window_s": out["window_s"], "window_wall_s": window_wall,
        "drained": out["drained"],
    }
    lat = out["latencies"]
    if lat is not None and len(lat) >= 8:
        q = np.array_split(lat, 4)
        result["diag"]["p50_by_quarter_ms"] = [1e3 * float(np.median(x)) for x in q]
    return result
