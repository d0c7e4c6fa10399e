"""Latency / throughput recorder for the PageRank query scheduler
(a copy of the JAX package's ``serve/metrics.py``; host code).

One ``QueryTrace`` per query: submit -> admit (queue wait) -> done
(service). ``summary()`` reduces the traces to the serving headline
numbers: p50/p99 end-to-end latency and queries/s over the span between
the first submit and the last completion.

Resilience accounting: traces carry terminal ``error`` and ``degraded``
flags, and the recorder keeps named event counters (rejections, queue
expiries, degradations, quarantines, stepper failures) so every shed or
degraded query shows in the summary. Latency percentiles are taken over
the queries actually served (error-free completions).

Every named event lives in one place, the ``obs.metrics.MetricsRegistry``
each recorder owns (``serve_events_total{event=...}``); the ``counters``
property is a read-only view of it. ``completed()`` enforces the terminal
contract: a second completion for the same uid raises, and
``reconcile()`` cross-checks the event counters against the trace table.

An empty recorder reports ``None`` for every statistic that has no
defined value (percentiles, mean, qps), and ``qps`` is ``None`` when the
observed span is zero.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

from ..obs.metrics import MetricsRegistry

EVENT_FAMILY = "serve_events_total"
TERMINAL_FAMILY = "serve_terminals_total"


@dataclasses.dataclass
class QueryTrace:
    uid: int
    t_submit: float
    t_admit: float | None = None
    t_done: float | None = None
    iterations: int = 0
    converged: bool = False
    error: Optional[str] = None     # terminal failure (reject/fault)
    degraded: bool = False          # served approximate under pressure
    route: Optional[str] = None     # "push" / "cached" / None (stepper)

    @property
    def latency_s(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def queue_wait_s(self) -> float | None:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit


def _percentile(sorted_vals: list[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an already-sorted list; ``None``
    when there is no data to take a percentile of."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ServeMetrics:
    """Per-query trace collection with an aggregate summary.

    The clock is injectable so tests can drive deterministic times;
    schedulers share it for deadline arithmetic so a fake clock drives
    the whole admission path.

    Thread-safe: the recorder is shared between a scheduler's device
    loop and the submit threads (and, with its slice, the gateway).
    Trace writes happen under one internal lock; event counters are
    registry metrics with their own per-metric locks, so increments
    from free-running threads never lose updates.

    Each recorder owns its registry by default (reconciliation is a
    per-scheduler property); pass ``registry=`` to aggregate several
    recorders into one scrape surface — their samples stay separable
    because the gateway labels each with its graph name.
    """

    def __init__(self, clock=time.perf_counter,
                 registry: Optional[MetricsRegistry] = None):
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.traces: dict[int, QueryTrace] = {}
        self._lock = threading.Lock()

    def submitted(self, uid: int) -> None:
        with self._lock:
            self.traces[uid] = QueryTrace(uid, self.clock())

    def admitted(self, uid: int) -> None:
        """Record FIRST admission only: a quarantine re-admission (or
        a push fallback re-entering the stepper) re-runs the admit
        path, and letting it overwrite ``t_admit`` would under-report
        queue wait exactly for the queries that needed retries."""
        with self._lock:
            tr = self.traces[uid]
            if tr.t_admit is None:
                tr.t_admit = self.clock()

    def completed(self, uid: int, *, iterations: int, converged: bool,
                  error: Optional[str] = None, degraded: bool = False,
                  route: Optional[str] = None) -> None:
        with self._lock:
            tr = self.traces[uid]
            if tr.t_done is not None:
                raise RuntimeError(
                    f"duplicate terminal for uid {uid}: already "
                    f"completed (error={tr.error!r}), second "
                    f"completion (error={error!r}) — every query must "
                    "resolve exactly once")
            tr.t_done = self.clock()
            tr.iterations = iterations
            tr.converged = converged
            tr.error = error
            tr.degraded = degraded
            tr.route = route
        self.registry.counter(
            TERMINAL_FAMILY, "terminal resolutions (exactly one "
            "per query)").inc()

    def incr(self, name: str, n: int = 1) -> None:
        """Count one resilience event (rejection, expiry, degradation,
        quarantine, ...) — single home: the registry."""
        self.registry.counter(
            EVENT_FAMILY, "named scheduler/gateway events",
            event=name).inc(n)

    @property
    def counters(self) -> collections.Counter:
        """Read-only view of the event counters in the legacy
        ``collections.Counter`` shape (missing names read as 0, as
        before).  Mutations go through ``incr``."""
        c = collections.Counter()
        for labels, metric in self.registry.family_items(EVENT_FAMILY):
            c[labels["event"]] = int(metric.value)
        return c

    def _trace_snapshot(self) -> list[QueryTrace]:
        """Consistent read of the trace table — iterating the live dict
        while a submit thread inserts would raise mid-iteration."""
        with self._lock:
            return list(self.traces.values())

    @property
    def completed_count(self) -> int:
        return sum(tr.t_done is not None
                   for tr in self._trace_snapshot())

    def percentile(self, q: float, *, of: str = "latency"
                   ) -> Optional[float]:
        """Nearest-rank percentile (seconds) over served completions;
        ``of`` is ``"latency"`` (submit->done) or ``"queue"``
        (submit->admit).  ``None`` on an empty recorder — the honest
        answer, not 0.0."""
        done = [tr for tr in self._trace_snapshot()
                if tr.t_done is not None and tr.error is None]
        if of == "latency":
            vals = sorted(tr.latency_s for tr in done)
        elif of == "queue":
            vals = sorted(tr.queue_wait_s for tr in done
                          if tr.t_admit is not None)
        else:
            raise ValueError(f"unknown percentile kind {of!r}")
        return _percentile(vals, q)

    def reconcile(self) -> dict:
        """Cross-check event counters against the trace table.

        Every family that is derivable from BOTH surfaces must agree
        exactly: terminals vs completed traces, rejections/expiries vs
        terminal error strings, push/cache serves vs trace routes.  A
        mismatch means a counter was bumped without its terminal (or
        vice versa) — the double-home drift this layer exists to kill.
        Returns the checked values; raises ``AssertionError`` naming
        the first disagreement.
        """
        traces = self._trace_snapshot()
        done = [tr for tr in traces if tr.t_done is not None]
        c = self.counters
        checks = {
            "terminals": (
                int(self.registry.counter_value(TERMINAL_FAMILY)),
                len(done)),
            "rejected": (
                c["rejected"],
                sum(1 for tr in done if tr.error is not None
                    and tr.error.startswith("rejected"))),
            "expired": (
                c["expired"],
                sum(1 for tr in done
                    if tr.error == "deadline expired in queue")),
            "push_served": (
                c["push_served"],
                sum(1 for tr in done
                    if tr.route == "push" and tr.error is None)),
            "cache_hits_served": (
                c["cache_hits"],
                sum(1 for tr in done if tr.route == "cached")),
        }
        for name, (counted, derived) in checks.items():
            assert counted == derived, (
                f"counter/trace drift for {name!r}: counter says "
                f"{counted}, trace table derives {derived}")
        return {k: v[0] for k, v in checks.items()}

    def summary(self) -> dict:
        traces = self._trace_snapshot()
        counters = dict(self.counters)
        done = [tr for tr in traces if tr.t_done is not None]
        served = [tr for tr in done if tr.error is None]
        base = {
            "count": len(done),
            "served_count": len(served),
            "error_count": len(done) - len(served),
            "degraded_count": sum(tr.degraded for tr in done),
            "counters": counters,
        }
        if not served:
            base.update({"qps": None, "p50_ms": None, "p99_ms": None,
                         "mean_ms": None, "queue_p50_ms": None,
                         "mean_iterations": None,
                         "converged_frac": None})
            return base
        lats = sorted(tr.latency_s for tr in served)
        waits = sorted(tr.queue_wait_s for tr in served
                       if tr.t_admit is not None)
        span = (max(tr.t_done for tr in served)
                - min(tr.t_submit for tr in served))
        p50, p99 = _percentile(lats, 50), _percentile(lats, 99)
        qw = _percentile(waits, 50)
        base.update({
            "qps": len(served) / span if span > 0 else None,
            "p50_ms": p50 * 1e3,
            "p99_ms": p99 * 1e3,
            "mean_ms": sum(lats) / len(lats) * 1e3,
            "queue_p50_ms": qw * 1e3 if qw is not None else None,
            "mean_iterations": (sum(tr.iterations for tr in served)
                                / len(served)),
            "converged_frac": (sum(tr.converged for tr in served)
                               / len(served)),
        })
        return base
