"""Observability plane of the port: flight recorder and metrics plane.

The counterpart of ``fluidframework_tpu/observability/``, host-side and off
the device path:

- ``flight_recorder``: a fixed-size ring of trace events with a Chrome
  trace-event exporter, and the module globals ``install``/``recorder``/
  ``span``/``instant`` the serving path calls (a no-op costing one global
  read while no recorder is installed); ``phase_totals``/``phase_shares``
  summarize a trace per span name;
- ``metrics_plane``: Prometheus-text ``/metrics`` and JSON ``/status``
  rendering, and a small HTTP server over any number of sources.

The reference's ``RecompileWatchdog`` is not carried: the port compiles
nothing at run time (see ``flight_recorder``).
"""

from .flight_recorder import (
    FlightRecorder,
    TraceEvent,
    install,
    instant,
    phase_shares,
    phase_totals,
    recorder,
    span,
    uninstall,
)
from .metrics_plane import (
    MetricsPlane,
    MetricsServer,
    parse_prometheus,
    render_prometheus,
)

__all__ = [
    "FlightRecorder",
    "MetricsPlane",
    "MetricsServer",
    "TraceEvent",
    "install",
    "instant",
    "parse_prometheus",
    "phase_shares",
    "phase_totals",
    "recorder",
    "render_prometheus",
    "span",
    "uninstall",
]
