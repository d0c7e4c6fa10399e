"""Observability (a port of the JAX package's ``obs/``; DESIGN.md §14).

One ``Observability`` bundle ties the three instruments together:

- ``tracer``/``recorder`` — explicit-parent span tracing into a bounded
  flight-recorder ring (obs/trace.py), threaded through the query
  lifecycle, plan builds/patches, deltas and stepper builds, and the
  port's own spans of a solve's stages and of host preprocessing
  (``PORT_SPANS``);
- ``registry`` — the typed metrics registry (obs/metrics.py) that
  cross-cutting counters report into; each scheduler's ``ServeMetrics``
  keeps its own registry and the gateway's scrape endpoint merges them;
- ``comm`` — measured-vs-model communication accounting (obs/comm.py).

Off by default: nothing constructs a bundle unless
``EngineConfig(observe=True)`` / ``Session.observe()`` /
``SlotScheduler(obs=...)`` asks, and every hot-path hook is one
``is None`` branch.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Optional

from .comm import CommAccountant, CommBreakdown, measure_plan, vs_model
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, render_prometheus)
from .trace import (PORT_SPANS, TRACE_SCHEMA_VERSION, FlightRecorder,
                    QuerySpans, Span, SpanRecord, Tracer)

__all__ = [
    "Observability", "Tracer", "Span", "SpanRecord", "QuerySpans",
    "FlightRecorder", "MetricsRegistry", "Counter", "Gauge",
    "Histogram", "render_prometheus", "DEFAULT_BUCKETS",
    "CommAccountant", "CommBreakdown", "measure_plan", "vs_model",
    "TRACE_SCHEMA_VERSION", "PORT_SPANS",
]


class Observability:
    """The bundle a Session/SlotScheduler/Gateway reports through."""

    def __init__(self, *, capacity: int = 8192,
                 dump_dir: Optional[str] = None, clock=None):
        kw = {} if clock is None else {"clock": clock}
        self.recorder = FlightRecorder(capacity)
        self.tracer = Tracer(self.recorder, **kw)
        self.registry = MetricsRegistry()
        self.comm = CommAccountant(registry=self.registry)
        self.dump_dir = dump_dir
        self._dump_seq = itertools.count(1)
        self._dump_lock = threading.Lock()
        # plan build/hit/patch events and host-preprocessing spans fan
        # in from core/plan.py (weak registration: dropping the bundle
        # detaches it)
        from ..core import plan as _plan
        self._plan_mod = _plan
        _plan.add_plan_observer(self)

    # ------------------------------------------------------------- events
    def plan_event(self, name: str, **attrs) -> None:
        """Callback target of ``core.plan.notify_plan_event``."""
        self.tracer.event(name, trace="plan", **attrs)
        self.registry.counter("plan_events_total",
                              "plan build/hit/patch events",
                              event=name).inc()

    def plan_span(self, name: str, parent=None, /, **attrs) -> Span:
        """Callback target of ``core.plan.plan_span``: an open span of
        host preprocessing, trace ``"plan"`` (an attribute may be called
        ``name``)."""
        sp = self.tracer.start(name, parent=parent, trace="plan")
        sp.annotate(**attrs)
        return sp

    # -------------------------------------------------------------- dumps
    def dump(self, path: str) -> str:
        """Flight-recorder JSONL on demand."""
        return self.recorder.dump(path)

    def crash_dump(self, reason: str) -> Optional[str]:
        """Automatic dump when a query is lost to quarantine or a stepper
        failure. Records a ``crash_dump`` event either way; writes
        ``flight-NNNN.jsonl`` only when ``dump_dir`` is configured."""
        self.registry.counter("crash_dumps_total",
                              "automatic flight-recorder dumps").inc()
        if self.dump_dir is None:
            self.tracer.event("crash_dump", trace="crash",
                              reason=reason, path=None)
            return None
        with self._dump_lock:
            seq = next(self._dump_seq)
        path = os.path.join(self.dump_dir, f"flight-{seq:04d}.jsonl")
        self.tracer.event("crash_dump", trace="crash", reason=reason,
                          path=path)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            return self.recorder.dump(path)
        except OSError:
            return None

    # ------------------------------------------------------------ exports
    def prometheus(self) -> str:
        return self.registry.prometheus_text()

    def stats(self) -> dict:
        return {"metrics": self.registry.to_json(),
                "comm": self.comm.summary(),
                "flight_recorder": {
                    "held": len(self.recorder),
                    "recorded": self.recorder.recorded,
                    "dropped": self.recorder.dropped,
                    "capacity": self.recorder.capacity}}

    def close(self) -> None:
        self._plan_mod.remove_plan_observer(self)
