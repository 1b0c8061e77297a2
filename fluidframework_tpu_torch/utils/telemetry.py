"""Health counters and latency histograms of the fleet engine.

``HealthCounters`` and ``Histogram`` of
``fluidframework_tpu/utils/telemetry.py``.  ``HealthCounters.emit`` sends
to a logger with the reference's ``generic(event_name, **props)`` method
when one is attached, and is a no-op otherwise (the engine attaches none).
Host-side only: nothing here touches the device.
"""

from __future__ import annotations

import math
from typing import Any


class HealthCounters:
    """Named monotonic counters + gauges for degraded-mode health surfaces
    (engine quarantine/checkpoint/watchdog state).  Counters accumulate
    (``bump``), gauges overwrite (``gauge``); ``snapshot`` returns a plain
    dict for status lines and bench artifacts, ``emit`` sends the same dict
    as one structured telemetry event so fleets report health through the
    ordinary logger pipeline."""

    def __init__(self, logger=None, **initial: int) -> None:
        self.logger = logger
        self._values: dict[str, Any] = dict(initial)

    def bump(self, name: str, by: int = 1) -> int:
        self._values[name] = self._values.get(name, 0) + by
        return self._values[name]

    def gauge(self, name: str, value: Any) -> None:
        self._values[name] = value

    def ratio(self, name: str, numerator: str, denominator: str) -> None:
        """Derived gauge: ``numerator``/``denominator`` counter ratio at
        snapshot time (0.0 while the denominator is empty)."""
        den = self._values.get(denominator, 0)
        self._values[name] = (
            round(self._values.get(numerator, 0) / den, 2) if den else 0.0
        )

    def get(self, name: str, default: Any = 0) -> Any:
        return self._values.get(name, default)

    def snapshot(self) -> dict[str, Any]:
        return dict(self._values)

    def emit(self, event_name: str = "engine_health", **props: Any) -> None:
        if self.logger is not None:
            self.logger.generic(event_name, **self._values, **props)


class Histogram:
    """Log-bucketed, mergeable latency histogram with percentile queries.

    Values bucket at geometric boundaries ``base * growth**i`` (sparse
    dict of counts, so an idle histogram is a few machine words); exact
    ``count``/``sum``/``min``/``max`` ride alongside, and ``percentile``
    answers from the bucket cumulative clamped to the observed [min, max]
    — the result is within one bucket (a factor of ``growth``) of the
    exact order statistic, single-sample case exact.  Recording costs
    one ``math.log`` + one dict update.
    """

    __slots__ = ("base", "growth", "_lg", "count", "sum", "min", "max",
                 "_buckets")

    def __init__(self, base: float = 1e-6, growth: float = 2 ** 0.25) -> None:
        if base <= 0 or growth <= 1:
            raise ValueError("base must be > 0 and growth > 1")
        self.base = base
        self.growth = growth
        self._lg = math.log(growth)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int, int] = {}

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # Bucket i covers (base*growth**(i-1), base*growth**i]; everything
        # at or below base lands in bucket 0.
        i = 0 if v <= self.base else math.ceil(
            math.log(v / self.base) / self._lg - 1e-12
        )
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float | None:
        """The q-quantile (q in [0, 1]); None while empty."""
        if self.count == 0:
            return None
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile {q} outside [0, 1]")
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum >= target:
                upper = self.base * self.growth ** i
                return min(max(upper, self.min), self.max)
        return self.max  # unreachable; defensive
