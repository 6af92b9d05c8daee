"""Observability for the port's serving stack: per-request traces, the
process-wide metrics registry, the telemetry exporters and the terminal
dashboard (copies of ``repro.obs.trace``, ``metrics``, ``export`` and
``dashboard``)."""
from repro_torch.obs.dashboard import render, watch
from repro_torch.obs.export import TelemetrySnapshotter, read_snapshots
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     exponential_buckets,
                                     set_default_registry)
from repro_torch.obs.trace import Span, Trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "set_default_registry", "exponential_buckets",
    "Span", "Trace",
    "TelemetrySnapshotter", "read_snapshots",
    "render", "watch",
]
