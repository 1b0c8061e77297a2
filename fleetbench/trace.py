"""Reading a ``torch.profiler`` trace of the window.

The harness marks the traced part of the window with a ``record_function``
range ``fleetbench.traced`` and its own spans inside it with ranges named
``fleetbench.<span>``.  From the exported Chrome trace this module takes
the device's activity (kernels, copies, sets), the host's ranges, and the
launch that issued each kernel (its correlation id), and sums:

- ``window_s``: the traced part's length;
- ``busy_s``: seconds of it in which some device activity ran;
- ``step_device_s``: device seconds of the activity that ``step`` spans
  launched (the fleet programs);
- ``device_ops``: device seconds by operation name;
- ``idle_gaps``: the gaps between device activity, each named by the
  harness span the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .arith import busy_and_gaps

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
PREFIX = "fleetbench."
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


def summarize(path: str) -> dict | None:
    """The traced part's device summary, or None when the trace holds no
    ``traced`` range or no device activity."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ranges = defaultdict(list)   # harness span -> [(start us, end us)]
    launches = {}                # correlation id -> launch time (us)
    device = []                  # (start us, end us, name, correlation)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", "?"), (e.get("args") or {}).get("correlation")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = ts
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            ranges[e["name"][len(PREFIX):]].append((ts, ts + dur))
    if not ranges.get("traced") or not device:
        return None
    lo, hi = ranges["traced"][0]
    busy_us, gaps = busy_and_gaps([(s, t) for s, t, _n, _c in device], lo, hi)

    steps = sorted(ranges.get("step", []))
    starts = [s for s, _e in steps]

    def in_step(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= steps[i][1]

    step_us = 0.0
    by_name = defaultdict(float)
    for s, t, name, corr in device:
        if t <= lo or s >= hi:
            continue
        by_name[name[:NAME_CHARS]] += t - s
        launched = launches.get(corr, s)
        if in_step(launched):
            step_us += t - s

    labelled = sorted((s, e, name) for name, iv in ranges.items() if name != "traced"
                      for s, e in iv)

    def host_span(t: float) -> str:
        inner = "other"
        for s, e, name in labelled:
            if s > t:
                break
            if t <= e:
                inner = name
        return inner

    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "step_device_s": step_us / 1e6,
        "device_ops": sorted(([n, v / 1e6] for n, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[host_span((s + e) / 2), (e - s) / 1e6] for s, e in top_gaps],
    }


def profile_window():
    """A profiler for the traced part (host ranges and device activity)."""
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        record_shapes=False, with_stack=False,
    )
