"""Async serving gateway: the threaded front door (a port of the JAX
package's ``gateway/frontdoor.py``; DESIGN.md §13).

The synchronous ``SlotScheduler`` couples every submitter to the
device loop: admission, stepping and drain all run on the caller's
thread, so one slow stepper chunk stalls every client.  The gateway
decouples them with a strict thread-ownership split:

- ONE device thread per gateway owns every ``step()`` and every
  ``apply_delta`` across all attached schedulers (the scheduler's
  ``_step_lock`` enforces this); it drains a bounded pending queue
  into the schedulers each round and interleaves stepper chunks
  across graphs weighted-fair (qos.py).
- A small worker pool serves PUSH-ELIGIBLE queries inline — they
  never touch the device thread, so loose-tolerance top-k traffic
  scales with workers while the stepper grinds full-vector queries.
- ``submit()`` runs on the CALLER's thread: validation (same errors
  as the scheduler, raised synchronously), cache lookup, and routing;
  it returns a ``concurrent.futures.Future`` immediately.

The scheduler's admission semantics survive the async split: priority
(the device thread hands the WHOLE backlog to the scheduler each round,
so its priority queue orders admission globally), deadlines (made
ABSOLUTE at gateway intake — queue time in the gateway counts against
the budget), degrade-under-pressure, and explicit rejection (a full
gateway backlog rejects immediately with a terminal, counted result —
never a silent drop, never an unbounded queue).

Results flow back through a futures table keyed ``(graph, uid)``; a
push worker can lose the registration race with the device thread's
drain, so unmatched results park in an orphan buffer until their
future registers — exactly-once delivery either way.

On the card the device thread's stepper chunks run kernel B1's "warp"
path and the push workers' sweeps its "tile" path. All of them launch on
the one default stream, so a push's host reads wait behind a queued
chunk. A failure on the device thread fails every unresolved future
(``close`` then raises); a failed push job fails its own.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from ..serve.scheduler import QueryResult, SlotScheduler, next_uid
from .autotune import autotune_slots
from .cache import ResultCache, seed_digest
from .qos import WeightedFair


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Knobs for the async front door."""
    max_pending: int = 4096       # gateway backlog bound (per gateway)
    push_workers: int = 2         # inline push-serving threads
    cache_entries: int = 1024     # warm-result LRU capacity (0 = off)
    target_chunk_s: float = 0.025          # autotune latency target
    autotune_candidates: tuple = (2, 4, 8, 16, 32, 64)
    retune_on_rebind: bool = False    # re-probe B after apply_delta
    idle_wait_s: float = 0.002    # device-thread sleep when idle


def check_one_controller(engine) -> None:
    """A gateway over a sharded engine needs world size 1: its threads
    decide what each chunk holds from wall-clock arrivals, so several
    ranks would step different pools and wait in different collectives.
    Above world size 1 this raises ``NotImplementedError`` naming ROADMAP
    A14: a controller rank that broadcasts the gateway's operations to
    the others."""
    if engine.backend.supports_sharding and engine.mesh.world_size > 1:
        raise NotImplementedError(
            "a gateway over a sharded engine runs at world size 1 only "
            f"(this one has {engine.mesh.world_size} ranks): its threads "
            "cannot keep ranks in lockstep. A controller rank that "
            "broadcasts the gateway's ops is ROADMAP A14")


class Gateway:
    """Threaded front door over one or more compiled schedulers.

    ``schedulers`` is a single ``SlotScheduler`` or a ``{name: sch}``
    dict (``GraphRegistry.gateway()`` builds the latter).  Queries
    submitted directly to a wrapped scheduler bypass the futures
    table; don't mix the two intake paths on one scheduler.
    """

    def __init__(self, schedulers, *, shares: dict | None = None,
                 config: GatewayConfig | None = None,
                 name: str = "default", obs=None):
        if isinstance(schedulers, SlotScheduler):
            schedulers = {name: schedulers}
        if not schedulers:
            raise ValueError("gateway needs at least one scheduler")
        for sch in schedulers.values():
            check_one_controller(sch.engine)
        self.config = config or GatewayConfig()
        self._schedulers: dict[str, SlotScheduler] = dict(schedulers)
        # observability: explicit bundle, or inherit the first
        # attached scheduler's (Session wires the scheduler, the gateway
        # follows — one bundle end to end)
        self.obs = obs if obs is not None else next(
            (s.obs for s in self._schedulers.values()
             if s.obs is not None), None)
        # gateway-level gauges/counters live in their own registry so
        # metrics_endpoint() can merge them with every scheduler's
        from ..obs.metrics import MetricsRegistry
        self._gw_registry = MetricsRegistry()
        self._fair = WeightedFair(
            {n: 1.0 for n in self._schedulers} if shares is None
            else {n: shares.get(n, 1.0) for n in self._schedulers})
        self.cache = ResultCache(self.config.cache_entries)
        self.autotune_report = None       # set by Session.gateway()
        self.retune_reports: list = []
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._control: collections.deque = collections.deque()
        self._futures: dict[tuple, tuple] = {}    # (name,uid) -> (fut,key)
        self._orphans: dict[tuple, QueryResult] = {}
        self._inflight = 0
        self._cursors = {n: len(s.completed)
                         for n, s in self._schedulers.items()}
        self._loop_error: BaseException | None = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.config.push_workers),
            thread_name_prefix="gateway-push")
        self._device = threading.Thread(target=self._loop, daemon=True,
                                        name="gateway-device")
        self._device.start()

    # ------------------------------------------------------------ intake
    def _resolve(self, graph: str | None) -> tuple[str, SlotScheduler]:
        if graph is None:
            if len(self._schedulers) != 1:
                raise ValueError(
                    f"gateway serves {sorted(self._schedulers)}; pass "
                    f"graph=<name>")
            graph = next(iter(self._schedulers))
        try:
            return graph, self._schedulers[graph]
        except KeyError:
            raise KeyError(f"unknown graph {graph!r}; serving: "
                           f"{sorted(self._schedulers)}") from None

    def submit(self, seeds=None, *, graph: str | None = None,
               top_k: int | None = None, tol: float = 1e-6,
               max_iters: int = 100, deadline_s: float | None = None,
               priority: int = 0, route: str | None = None,
               use_cache: bool = True) -> Future:
        """Submit one query; returns a Future[QueryResult] immediately.

        Same request surface as ``SlotScheduler.submit`` — and the
        same validation errors, raised HERE on the caller's thread, so
        a malformed request never costs a queue slot or a dead future.
        The future always resolves to a terminal ``QueryResult``
        (possibly with ``.error`` set); it only raises if the push
        worker itself crashed."""
        if self._stop.is_set():
            raise RuntimeError("gateway is closed")
        name, sch = self._resolve(graph)
        route, use_push = sch.validate_request(
            seeds is not None, top_k=top_k, tol=tol,
            max_iters=max_iters, route=route)
        spans = None
        if self.obs is not None:
            # root opens HERE, on the caller's thread — the recorded
            # interval is the client-observed latency (intake through
            # future resolution); the uid binds later, in the
            # scheduler's intake lock
            from ..obs.trace import QuerySpans
            spans = QuerySpans(
                self.obs.tracer,
                self.obs.tracer.start("query", graph=name, route=route),
                gateway_owned=True)
            spans.event("intake", push=use_push)
        kw = dict(top_k=top_k, tol=tol, max_iters=max_iters,
                  priority=priority, route=route)
        key = None
        if use_cache and self.cache.capacity > 0:
            key = (name, sch.engine.plan.graph_fp, seed_digest(seeds),
                   float(tol), top_k, int(max_iters), route)
            hit = self.cache.get(key)
            if hit is not None:
                return self._serve_cached(sch, hit, spans)
            sch.metrics.incr("cache_misses")
        if deadline_s is None:
            deadline_s = sch.resilience.default_deadline_s
        deadline = (sch.clock() + deadline_s
                    if deadline_s is not None else None)
        fut: Future = Future()
        if use_push:
            with self._lock:
                self._inflight += 1
            self._pool.submit(self._push_job, name, sch, seeds, kw,
                              deadline, fut, key, spans)
            return fut
        with self._lock:
            if len(self._pending) >= self.config.max_pending:
                self._reject(sch, fut,
                             f"rejected: gateway backlog full "
                             f"({self.config.max_pending})",
                             spans)
                return fut
            if spans is not None:
                spans.start_child("backlog")
            self._pending.append((name, seeds, kw, deadline, fut, key,
                                  spans))
            self._inflight += 1
        self._wake.set()
        return fut

    def _serve_cached(self, sch, hit: QueryResult, spans=None) -> Future:
        """A warm-result hit: mint a real uid and a full metrics trace
        (submitted/admitted/completed — the audit sees exactly one
        terminal per uid) and answer with the CACHED solve's arrays —
        bit-identical, O(k)."""
        uid = next_uid()
        m = sch.metrics
        m.submitted(uid)
        m.admitted(uid)
        m.completed(uid, iterations=hit.iterations, converged=True,
                    route="cached")
        m.incr("cache_hits")
        if spans is not None:
            spans.bind(uid)
            spans.event("cache_hit")
            spans.finish(served="cached")
            spans.resolve()
        fut: Future = Future()
        fut.set_result(dataclasses.replace(
            hit, uid=uid, latency_s=m.traces[uid].latency_s,
            cached=True))
        return fut

    def _reject(self, sch, fut: Future, err: str, spans=None) -> None:
        """Terminal gateway-side rejection: a real uid, a full trace,
        the rejection counted — indistinguishable in the accounting
        from a scheduler-side shed."""
        uid = next_uid()
        m = sch.metrics
        m.submitted(uid)
        m.incr("rejected")
        m.completed(uid, iterations=0, converged=False, error=err)
        if spans is not None:
            spans.bind(uid)
            spans.finish(status="error", error=err)
            spans.resolve(error=True)
        fut.set_result(QueryResult(uid, 0, False, None,
                                   m.traces[uid].latency_s, error=err))

    def _push_job(self, name, sch, seeds, kw, deadline, fut, key,
                  spans=None):
        """Worker-pool body: serve a push-eligible query inline via
        the scheduler's thread-safe submit (per-thread push engines).
        A push fallback lands in the scheduler's stepper queue — wake
        the device thread so it gets admitted."""
        try:
            remaining = (deadline - sch.clock()
                         if deadline is not None else None)
            uid = sch.submit(seeds, deadline_s=remaining,
                             _spans=spans, **kw)
            self._register(name, sch, uid, fut, key, spans)
            self._wake.set()
        except BaseException as exc:   # noqa: BLE001 — surface, don't hang
            with self._lock:
                self._inflight -= 1
                self._idle.notify_all()
            fut.set_exception(exc)

    # --------------------------------------------------- result delivery
    def _register(self, name, sch, uid, fut, key, spans=None) -> None:
        with self._lock:
            orphan = self._orphans.pop((name, uid), None)
            if orphan is None:
                self._futures[(name, uid)] = (fut, key, spans)
                return
        self._deliver(orphan, fut, key, spans)

    def _deliver(self, result: QueryResult, fut: Future, key,
                 spans=None) -> None:
        if (key is not None and result.converged
                and result.error is None and not result.degraded):
            self.cache.put(key, result)
        if spans is not None:
            # ends the gateway-owned root: the recorded query interval
            # is intake -> future resolution, the client's view
            spans.resolve(error=result.error is not None)
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()
        fut.set_result(result)

    def _drain_completed(self) -> None:
        """Device thread: match newly completed scheduler results to
        their futures; results whose registration hasn't landed yet
        (push-worker race) park in the orphan buffer."""
        for name, sch in self._schedulers.items():
            done = sch.completed
            cur = self._cursors[name]
            if cur >= len(done):
                continue
            fresh = done[cur:]
            self._cursors[name] = cur + len(fresh)
            for res in fresh:
                with self._lock:
                    entry = self._futures.pop((name, res.uid), None)
                    if entry is None:
                        self._orphans[(name, res.uid)] = res
                        continue
                self._deliver(res, *entry)

    # ------------------------------------------------------- device loop
    def _drain_pending(self) -> None:
        """Hand the ENTIRE gateway backlog to the schedulers each
        round — their priority/deadline admission then orders it
        globally, exactly as under synchronous submission."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                name, seeds, kw, deadline, fut, key, spans = \
                    self._pending.popleft()
            sch = self._schedulers[name]
            try:
                remaining = (deadline - sch.clock()
                             if deadline is not None else None)
                if spans is not None:
                    spans.end_child("backlog")
                uid = sch.submit(seeds, deadline_s=remaining,
                                 _spans=spans, **kw)
                self._register(name, sch, uid, fut, key, spans)
            except BaseException as exc:  # noqa: BLE001
                with self._lock:
                    self._inflight -= 1
                    self._idle.notify_all()
                fut.set_exception(exc)

    def _run_control(self) -> None:
        while True:
            with self._lock:
                if not self._control:
                    return
                op, fut = self._control.popleft()
            try:
                fut.set_result(op())
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

    def _busy_graphs(self) -> list[str]:
        return [n for n, s in self._schedulers.items()
                if s.queued > 0 or s.active_slots > 0]

    def _loop(self) -> None:
        try:
            while True:
                self._run_control()
                self._drain_pending()
                self._drain_completed()
                busy = self._busy_graphs()
                if busy:
                    self._schedulers[self._fair.pick(busy)].step()
                    self._drain_completed()
                    continue
                if self._stop.is_set():
                    with self._lock:
                        quiet = (not self._pending
                                 and not self._control)
                    if quiet:
                        return
                    continue
                self._wake.wait(self.config.idle_wait_s)
                self._wake.clear()
        except BaseException as exc:   # noqa: BLE001 — fail loud
            self._loop_error = exc
            with self._lock:
                stranded = ([e[4] for e in self._pending]
                            + [e[0] for e in self._futures.values()])
                self._pending.clear()
                self._futures.clear()
                self._inflight = 0
                self._idle.notify_all()
            for fut in stranded:
                if not fut.done():
                    fut.set_exception(exc)

    # ----------------------------------------------------- control plane
    def apply_delta(self, delta, *, graph: str | None = None,
                    g_new=None) -> Future:
        """Rebind one scheduler onto a delta-updated graph WITHOUT
        stopping traffic: the swap runs as a control op on the device
        thread (between chunks — in-flight columns carry over exactly
        as in the synchronous path), then the warm-result cache drops
        every entry keyed on the outgoing plan fingerprint.  Returns a
        future resolving when the rebind committed (or carrying the
        rebind's exception — a failed delta leaves the old plan
        serving, cache intact)."""
        name, sch = self._resolve(graph)

        def op():
            old_fp = sch.engine.plan.graph_fp
            sch.apply_delta(delta, g_new=g_new)
            dropped = self.cache.invalidate_fp(old_fp)
            if self.config.retune_on_rebind:
                self.retune_reports.append(autotune_slots(
                    sch.engine, chunk=sch.chunk,
                    target_chunk_s=self.config.target_chunk_s,
                    candidates=self.config.autotune_candidates,
                    default=sch.slots))
            return dropped

        fut: Future = Future()
        with self._lock:
            self._control.append((op, fut))
        self._wake.set()
        return fut

    def snapshot(self, path: str, *, graph: str | None = None) -> Future:
        """Persist one scheduler's serving state (reliability/
        snapshot.py) as a control op on the device thread — the only
        thread allowed to hold the step lock, so the cut is consistent
        without quiescing traffic.  Never call ``snapshot_scheduler``
        directly on a gateway-driven scheduler from another thread: it
        takes the step lock, which the device loop treats as proof of
        a second stepping thread."""
        _, sch = self._resolve(graph)

        def op():
            from ..reliability.snapshot import snapshot_scheduler
            snapshot_scheduler(sch, path)

        fut: Future = Future()
        with self._lock:
            self._control.append((op, fut))
        self._wake.set()
        return fut

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: float | None = None) -> bool:
        """Block until every in-flight query's future has resolved.
        Returns False on timeout."""
        self._wake.set()
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0 or self._loop_error,
                timeout=timeout) and self._loop_error is None

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        """Stop the gateway.  ``drain=True`` (default) serves the
        backlog to completion first; ``drain=False`` abandons
        unresolved futures (their queries may still be in a
        scheduler's queue)."""
        if drain and not self._stop.is_set():
            self.drain(timeout=timeout)
        self._stop.set()
        self._wake.set()
        self._device.join(timeout=timeout)
        self._pool.shutdown(wait=True)
        if self._loop_error is not None:
            raise RuntimeError("gateway device loop failed") \
                from self._loop_error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            out = {
                "pending": len(self._pending),
                "inflight": self._inflight,
                "orphans": len(self._orphans),
            }
        out["cache"] = {"entries": len(self.cache),
                        "capacity": self.cache.capacity,
                        "hits": self.cache.hits,
                        "misses": self.cache.misses,
                        "evictions": self.cache.evictions,
                        "invalidated": self.cache.invalidated}
        out["graphs"] = {
            n: {"queued": s.queued, "active_slots": s.active_slots,
                "completed": len(s.completed),
                "rebind_count": s.rebind_count}
            for n, s in self._schedulers.items()}
        if self.autotune_report is not None:
            out["autotune"] = self.autotune_report.summary()
        return out

    def metrics_endpoint(self) -> str:
        """Prometheus text exposition of the whole gateway: every
        scheduler's event/terminal counters (labeled ``graph=<name>``),
        gateway backlog/cache/per-graph gauges, and — when an
        observability bundle is attached — its cross-cutting registry
        (plan events, comm accounting, crash dumps).  This is the
        scrape hook a real deployment would mount at ``/metrics``;
        gauges are synced at scrape time, so the text is a consistent
        point-in-time snapshot."""
        from ..obs.metrics import render_prometheus
        reg = self._gw_registry
        with self._lock:
            reg.gauge("gateway_pending",
                      "backlog depth").set(len(self._pending))
            reg.gauge("gateway_inflight",
                      "unresolved futures").set(self._inflight)
            reg.gauge("gateway_orphans",
                      "results awaiting registration"
                      ).set(len(self._orphans))
        c = self.cache
        reg.gauge("gateway_cache_entries", "warm results held").set(len(c))
        for nm, v in (("hits", c.hits), ("misses", c.misses),
                      ("evictions", c.evictions),
                      ("invalidated", c.invalidated)):
            reg.gauge("gateway_cache_events",
                      "warm-result cache accounting", event=nm).set(v)
        for n, s in self._schedulers.items():
            reg.gauge("scheduler_queued", "queued queries",
                      graph=n).set(s.queued)
            reg.gauge("scheduler_active_slots", "occupied slots",
                      graph=n).set(s.active_slots)
            reg.gauge("scheduler_trace_count",
                      "stepper traces (must stay 1)",
                      graph=n).set(s.trace_count)
            reg.gauge("scheduler_rebind_count", "plan rebinds",
                      graph=n).set(s.rebind_count)
        pairs = [(reg, {})]
        pairs += [(s.metrics.registry, {"graph": n})
                  for n, s in self._schedulers.items()]
        if self.obs is not None:
            pairs.append((self.obs.registry, {}))
        return render_prometheus(pairs)
