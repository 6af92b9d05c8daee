"""Observability for the port's serving stack: per-request traces and the
process-wide metrics registry (copies of ``repro.obs.trace`` and
``repro.obs.metrics``). The exporters and dashboard of ``repro.obs`` are
not ported yet."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     exponential_buckets,
                                     set_default_registry)
from repro_torch.obs.trace import Span, Trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "set_default_registry", "exponential_buckets",
    "Span", "Trace",
]
