"""The arithmetic behind the metric readers in ``metrics/``: each reader
file names one of these (a later metric adds a file, and a function here
only when no existing one fits)."""

from __future__ import annotations

from . import arith, roofline


def window_rate(run):
    """Ops of the window's steps over the window's whole length."""
    return arith.window_rate(run.out["done"], run.out["window_s"])


def latency_ms(q: float):
    def read(run):
        lat = run.out["latencies"]
        if lat is None or not len(lat):
            return None
        return 1e3 * arith.nearest_rank(lat, q)
    return read


def setup_s(run):
    return run.setup_s


def step_ms(run):
    """Host time of the harness's ``step`` spans (step and compact, ending
    in a synchronise), per step (in a traced run, of the traced part)."""
    n = run.spans.calls.get("step", 0)
    return 1e3 * run.spans.seconds["step"] / n if n else None


def ingest_us_per_op(run):
    """Host time of the harness's ``ingest`` spans (every ``ingest_lines``
    call of a step's lines), per op ingested."""
    ops = run.spans.ops.get("ingest", 0)
    return 1e6 * run.spans.seconds["ingest"] / ops if ops else None


def device_idle_pct(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def program_roofline(run):
    """The least time the bytes of every step and compact call of the
    traced part could take at the card's bandwidth, over the device time
    of what those calls launched."""
    t, peaks = run.trace, run.peaks
    if t is None or peaks is None or t["step_device_s"] <= 0:
        return None
    steps = run.spans.calls.get("step", 0)
    compacts = steps if run.traffic.get("compact") else 0
    total = roofline.steps_bytes(run.geometry, run.n_docs, steps, run.spans.ops.get("step", 0),
                                 compacts)
    return 100.0 * (total / peaks["hbm_bytes_per_s"]) / t["step_device_s"]
