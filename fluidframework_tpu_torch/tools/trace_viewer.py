"""fftpu-torch-trace: summarize a flight-recorder trace without Perfetto.

A port of ``fluidframework_tpu/tools/trace_viewer.py``.  Reads the Chrome
trace-event JSON the port's flight recorder exports
(``FlightRecorder.export_chrome_trace``, ``fleet_main --trace``), or the
gzipped traces ``chip_smoke.py --trace-dir`` writes, and prints:

- per-phase wall-time share (complete "X" spans grouped by name),
- the slowest individual spans (name, duration, labels),
- recompile instants (the recompile watchdog's de-specialization events),
- other instant events (migrations, rebalances) by name.

    fftpu-torch-trace trace.json
    fftpu-torch-trace traces/fleet_grow.json.gz --top 20
"""

from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import Counter


def load_trace(path: str) -> list[dict]:
    """The traceEvents list of a Chrome trace JSON file, plain or gzipped
    (dict or bare array forms are both legal Chrome trace inputs)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    doc = json.loads(raw)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: traceEvents is not a list")
    return events


def phase_table(events: list[dict]) -> list[tuple[str, float, int, float]]:
    """[(name, total_ms, count, share)] for "X" spans, biggest first.
    Nested spans each count their own full duration (attribution view)."""
    totals: dict[str, float] = {}
    counts: Counter = Counter()
    for ev in events:
        if ev.get("ph") == "X":
            name = ev.get("name", "?")
            totals[name] = totals.get(name, 0.0) + float(ev.get("dur", 0.0))
            counts[name] += 1
    grand = sum(totals.values()) or 1.0
    return [
        (name, t / 1e3, counts[name], t / grand)
        for name, t in sorted(totals.items(), key=lambda kv: -kv[1])
    ]


def slowest_spans(events: list[dict], top: int = 10) -> list[dict]:
    spans = [ev for ev in events if ev.get("ph") == "X"]
    return sorted(spans, key=lambda ev: -float(ev.get("dur", 0.0)))[:top]


def instants(events: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for ev in events:
        if ev.get("ph") == "i":
            out.setdefault(ev.get("name", "?"), []).append(ev)
    return out


def summarize(events: list[dict], top: int = 10) -> str:
    lines: list[str] = []
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    tids = {e.get("tid") for e in events}
    lines.append(
        f"{len(events)} events ({n_spans} spans) across {len(tids)} threads"
    )
    table = phase_table(events)
    if table:
        lines.append("")
        lines.append("phase shares (span time attribution):")
        for name, ms, count, share in table:
            lines.append(
                f"  {name:<24} {share * 100:6.2f}%  {ms:10.3f} ms"
                f"  x{count}"
            )
    slow = slowest_spans(events, top)
    if slow:
        lines.append("")
        lines.append(f"slowest {len(slow)} spans:")
        for ev in slow:
            args = ev.get("args") or {}
            label = " ".join(f"{k}={v}" for k, v in args.items())
            lines.append(
                f"  {float(ev.get('dur', 0)) / 1e3:10.3f} ms"
                f"  {ev.get('name', '?'):<16} {label}"
            )
    inst = instants(events)
    recompiles = inst.pop("recompile", [])
    lines.append("")
    lines.append(f"recompile events: {len(recompiles)}")
    for ev in recompiles:
        args = ev.get("args") or {}
        lines.append(
            f"  @{float(ev.get('ts', 0)) / 1e3:.3f} ms"
            f"  program={args.get('program', '?')}"
            f" cache_size={args.get('cache_size', '?')}"
        )
    for name, evs in sorted(inst.items()):
        lines.append(f"instant {name}: x{len(evs)}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="fftpu-torch-trace",
        description="summarize a flight-recorder Chrome trace",
    )
    p.add_argument("trace", help="Chrome trace-event JSON file")
    p.add_argument("--top", type=int, default=10,
                   help="slowest spans to list (default 10)")
    args = p.parse_args(argv)
    try:
        events = load_trace(args.trace)
    except (OSError, ValueError, KeyError) as e:
        print(f"fftpu-torch-trace: {e}", file=sys.stderr)
        return 1
    print(summarize(events, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
