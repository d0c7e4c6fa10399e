"""Observability, host side: the typed metrics registry that serving's
``ServeMetrics`` is built on. The span tracer, flight recorder and comm
accounting come with the observability slice (ROADMAP.md, Queue A)."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      render_prometheus)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "render_prometheus"]
