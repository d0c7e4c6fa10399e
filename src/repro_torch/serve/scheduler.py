"""Continuous-batching PageRank query scheduler.

``PageRankServer`` (serve/engine.py) iterates a batch in lockstep: every
query pays for the slowest column. Personalized-PageRank traffic is many
independent seed vectors with very different convergence times, so this
module turns the slot pool into a continuous batch, with one
multi-vector SpMV pass as the unit of work:

    queue -> slot -> (chunk steps, per-slot freeze) -> converged -> freed

- ``SlotScheduler`` owns a fixed pool of B seed-vector slots sharing one
  (n, B) masked chunk stepper (``core.pagerank.masked_chunk_stepper``;
  on a pcpm_pallas plan each of its iterations is one launch of kernel
  B1's "warp" path at d = B). Each slot carries its own residual and
  convergence mask on the device: converged columns are frozen while
  neighbours keep iterating.
- Between chunks the host drains finished slots and admits queued
  requests into freed columns; the stepper, the column admit and the
  column extract are built once at construction (``trace_count`` and
  ``admit_trace_count`` are 1 and stay 1). Slot index, per-request tol
  and iteration budget are data. A chunk reads its (B,) results back to
  the host once, besides the stepper's one ``active.any()`` read per
  iteration.
- Top-k queries ship (k,) ids and scores from the device
  (serve/topk.py) instead of the full n-vector.
- ``GraphRegistry`` holds schedulers for several graphs (warm-loaded via
  graphs/io.py) under an optional plan-memory budget.
- Forward-push routing (serve/push.py): with ``route="auto"`` the
  scheduler answers loose-tolerance top-k personalized queries inline
  at ``submit`` through the push backend and never occupies a slot for
  them; a push that stops above its bound falls back to the stepper,
  warm-started at the push estimate, its sweeps charged against the
  iteration budget.

Resilience (``reliability.ResilienceConfig``): deadline and priority
admission over a bounded queue (overload sheds load explicitly: rejected
queries complete at once with ``QueryResult.error`` set), tolerance
degradation under measured SLO pressure, per-slot NaN/Inf quarantine
(the stepper's freeze rule is finiteness-aware, so a poisoned column
freezes on the device and is re-admitted from a clean seed or failed
explicitly) and stepper-failure recovery. All of it is host-side policy
over the one stepper.

Streaming (``apply_delta``): an edge delta patches the plan and rebinds
the stepper atomically, under both locks, while in-flight columns carry
over as warm starts.

A port of the JAX package's ``serve/scheduler.py``. What depends on
later slices raises ``NotImplementedError`` naming the slice:
``fault_injector`` (reliability, A6),
``idmap`` (ingest, A7), ``gateway()`` and the registry's weighted drain
(gateway, A8), ``obs`` (observability, A9) and ``sharded=True``
(sharded path, A10).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..api import _later, reject_later_knobs
from ..core.backends import resolve_engine
from ..core.pagerank import (StepperFailure, _inv_degree,
                             masked_chunk_stepper)
from ..core.plan import (install_plan, internal_graph, plan_nbytes,
                         reorder_inverse)
from ..core.spmv import SpMVEngine
from ..graphs import io as graph_io
from ..graphs.formats import Graph, validate_graph
from ..reliability.admission import ResilienceConfig
from .engine import _normalize_teleport
from .metrics import ServeMetrics
from .topk import make_slot_topk

# process-global: uids stay unique even when several schedulers (e.g. a
# GraphRegistry's) share one ServeMetrics, whose traces key on uid
_uid_counter = itertools.count()
_uid_lock = threading.Lock()


def next_uid() -> int:
    """Allocate one process-unique query uid."""
    with _uid_lock:
        return next(_uid_counter)


def ensure_uid_floor(floor: int) -> None:
    """Advance the process-global uid counter to at least ``floor``, so
    fresh submissions never collide with restored queries' uids."""
    global _uid_counter
    with _uid_lock:
        nxt = next(_uid_counter)
        _uid_counter = itertools.count(max(nxt, floor))


def _read_chunk(active: torch.Tensor, took: torch.Tensor,
                res: torch.Tensor):
    """A chunk's (B,) results on the host in one copy: ``active`` (bool),
    ``took`` (int64) and ``res`` (float32). Iteration counts are exact
    in float32 (a chunk runs far fewer than 2**24)."""
    host = torch.stack([active.to(torch.float32), took.to(torch.float32),
                        res]).cpu().numpy()
    return host[0] > 0, host[1].astype(np.int64), host[2]


@dataclasses.dataclass
class Query:
    """One PageRank request. ``seed`` is the normalized teleport
    distribution in the plan's internal id space — None means uniform.
    ``deadline`` is an absolute time on the scheduler's clock (queue
    wait + service); ``priority`` orders admission (higher first, FIFO
    within a priority)."""
    uid: int
    seed: Optional[np.ndarray] = None
    top_k: Optional[int] = None
    tol: float = 1e-6
    max_iters: int = 100
    deadline: Optional[float] = None
    priority: int = 0
    degraded: bool = False        # tolerance loosened / served approx
    retries: int = 0              # clean-seed re-admissions so far
    # iterations already consumed by earlier admissions (quarantine
    # retries) or by a push attempt — ``max_iters`` bounds the total
    # work across all of them, and QueryResult.iterations reports it
    iters_done: int = 0
    # one-shot warm start: a push fallback's estimate, written over the
    # admitted column then cleared (a later quarantine retry re-admits
    # the clean seed, not the possibly-poisoned estimate)
    warm_start: Optional[np.ndarray] = None


@dataclasses.dataclass
class QueryResult:
    uid: int
    iterations: int
    converged: bool
    # last measured stopping residual; None when the query finished
    # before any residual readback (rejection, expiry, max_iters=0,
    # failure) — never a sentinel masquerading as data
    residual: Optional[float]
    latency_s: float
    ranks: Optional[np.ndarray] = None        # (n,) unless top_k set
    top_ids: Optional[np.ndarray] = None      # (k,) int32
    top_scores: Optional[np.ndarray] = None   # (k,) float32
    error: Optional[str] = None               # explicit terminal failure
    degraded: bool = False                    # approximate-answer mode


class SlotScheduler:
    """Request queue + B-slot continuous batch over one chunk stepper.

    Construction builds everything (engine, stepper, inverse degrees,
    the uniform seed, the slot pool); serving afterwards is data
    movement. ``trace_count`` (stepper builds) and ``admit_trace_count``
    (column-admit builds) are 1 and stay 1. ``device`` defaults to
    ``"cuda"`` (ignored when ``engine`` is given).
    """

    def __init__(self, g: Graph, *, slots: int = 4,
                 method: str = "pcpm", part_size: int = 65536,
                 damping: float = 0.85, chunk: int = 8,
                 dangling: str = "none",
                 engine: SpMVEngine | None = None,
                 metrics: ServeMetrics | None = None,
                 resilience: ResilienceConfig | None = None,
                 route: str = "auto", push_tol: float = 1e-4,
                 push_mode: str = "auto", push_max_sweeps: int = 64,
                 device=None, **later):
        reject_later_knobs("SlotScheduler", **later)
        if slots < 1:
            raise ValueError(f"need at least one slot; got {slots}")
        if route not in ("auto", "push", "stepper"):
            raise ValueError(f"route must be 'auto', 'push' or "
                             f"'stepper'; got {route!r}")
        validate_graph(g)
        self.g = g
        self.n = g.num_nodes
        self.slots = slots
        self.damping = damping
        self.chunk = chunk
        self.dangling = dangling
        self.engine = resolve_engine(g, method=method,
                                     part_size=part_size, engine=engine,
                                     device=device)
        self.device = self.engine.device
        # locality-reordered plans: the slot pool, the stepper and the
        # push engine all run in the plan's internal (relabeled) id
        # space — seeds map in at submit, ranks/top ids map back at
        # finish, so per-iteration work never pays a permute
        self._perm = self.engine.plan.reorder_perm       # old -> new
        self._inv = (reorder_inverse(self.engine.plan)
                     if self._perm is not None else None)
        self._g_int = internal_graph(g, self.engine.plan)
        self.metrics = metrics or ServeMetrics()
        self.clock = self.metrics.clock
        self.resilience = resilience or ResilienceConfig()
        self.trace_count = 0          # stepper builds — must stay 1
        self.admit_trace_count = 0    # column-admit builds — must stay 1
        self.rebind_count = 0         # plan swaps (the streaming slice)
        # forward-push query routing (serve/push.py): route="auto"
        # sends loose-tolerance top-k personalized queries to push,
        # everything else to the stepper; push_tol is the loose/tight
        # boundary. The push engine is built lazily on first use.
        self.route = route
        self.push_tol = float(push_tol)
        self.push_mode = push_mode
        # push never burns the whole iteration budget: capping its
        # sweeps leaves the fallback stepper real budget to finish a
        # query the push couldn't close
        self.push_max_sweeps = int(push_max_sweeps)
        # threading contract: ``submit`` is safe from any thread — the
        # intake lock guards the queue, the completed list and the
        # metrics/terminal commit; push compute runs outside it on
        # per-thread engines (a PushQueryEngine's scratch is single-
        # query state). ``step()`` stays single-caller (``_step_lock``):
        # one device thread owns the slot pool. Lock order: step, then
        # intake.
        self._lock = threading.RLock()
        self._step_lock = threading.Lock()
        self._push_tls = threading.local()
        self._push_gen = 0

        self._step_c, self._inv_deg = self._build_stepper(self.engine,
                                                          self.g)
        # the column admit is two column writes of the (n, B) pool
        # (``_admit``), built here once
        self.admit_trace_count += 1
        self._topk_fn = make_slot_topk(self.n)

        # cached uniform teleport seed — admit never writes the seed
        # argument, so one device buffer serves every seeds=None query
        uni = np.full(self.n, 1.0 / self.n, dtype=np.float32)
        self._uniform_seed = torch.from_numpy(uni).to(self.device)

        # host-side slot + queue state
        B = slots
        self._active = np.zeros(B, dtype=bool)
        self._iters = np.zeros(B, dtype=np.int64)
        self._tol = np.zeros(B, dtype=np.float32)
        self._max_iters = np.zeros(B, dtype=np.int64)
        self._slot_res = np.full(B, -1.0, dtype=np.float64)
        self._queue: list[Query] = []
        self.completed: list[QueryResult] = []
        self._init_pool_state()

        # SLO pressure model: EWMA seconds-per-iteration of the warm
        # stepper and EWMA iterations-per-served-query — what admission
        # uses to predict whether a query can make its deadline
        self._iter_s: Optional[float] = None
        self._query_iters: Optional[float] = None
        self._step_idx = 0
        self._step_retries = 0

    def _init_pool_state(self) -> None:
        """(Re)allocate the device slot pool and clear the host slot
        bookkeeping — construction, and recovery after a stepper
        failure that may have left the pool half-written."""
        B = self.slots
        # pr is updated in place by the stepper and the column writes
        self._pr = torch.zeros((self.n, B), dtype=torch.float32,
                               device=self.device)
        self._base = torch.zeros((self.n, B), dtype=torch.float32,
                                 device=self.device)
        self._slot_query: list[Optional[Query]] = [None] * B
        self._active[:] = False
        self._iters[:] = 0
        self._tol[:] = 0.0
        self._max_iters[:] = 0
        self._slot_res[:] = -1.0

    # ----------------------------------------------------- plan binding
    def _build_stepper(self, engine: SpMVEngine, g: Graph):
        """The chunk stepper over ``engine``'s plan and the matching
        inverse-degree vector (in the plan's internal id space), built
        WITHOUT touching scheduler state, so ``apply_delta`` can fully
        validate and build a rebind before committing anything. Called
        once at construction and once per ``apply_delta``; the admit,
        extract and top-k paths depend only on shapes and are not
        rebuilt."""
        gi = internal_graph(g, engine.plan)
        step = masked_chunk_stepper(engine, damping=self.damping,
                                    chunk=self.chunk,
                                    dangling=self.dangling)
        self.trace_count += 1
        return step, _inv_degree(gi, engine.device)

    def apply_delta(self, delta, *, g_new: Graph | None = None) -> None:
        """Swap the scheduler onto the delta-updated graph WITHOUT
        dropping in-flight queries: the plan is patched incrementally
        (stream/patch.py), only the stepper is rebuilt against the new
        streams (counted in ``trace_count`` and ``rebind_count``), and
        the (n, B) slot state carries over as-is. Active columns continue
        iterating under the new operator — their current state is a warm
        start, so they converge to the NEW graph's answer under their
        own tolerance. Queued queries are admitted against the new plan.

        The rebind is ATOMIC: delta validation, plan patch, integrity
        check (``resilience.verify_plans``) and the new engine and
        stepper all happen before any scheduler state changes, so a
        failing delta (bad edges, corrupted plan, patcher bug) leaves
        the old plan serving — the failure is counted
        (``delta_failures``) and re-raised. The plan left behind keeps
        its host arrays in the plan cache; its device uploads are
        released (``core.plan.release_device``)."""
        from ..core.plan import release_device
        from ..stream.delta import apply_delta as apply_edges
        from ..stream.patch import patch_plan
        if self._perm is not None:
            raise ValueError(
                "apply_delta on a reorder-enabled scheduler is not "
                "supported: the locality permutation is a function of "
                "the graph, so the delta would change the slot pool's "
                "internal id space under the in-flight columns — "
                "drain and construct a fresh scheduler for the updated "
                "graph instead")
        # the JAX package's fault-injector hooks (check_delta,
        # wants_corrupt) come with the reliability slice (A6)
        try:
            delta.validate(self.g)
            if g_new is None:
                g_new = apply_edges(self.g, delta)
            old_plan = self.engine.plan
            new_plan = patch_plan(old_plan, delta, g_new)
            if self.resilience.verify_plans:
                from ..reliability.guardrails import check_plan_integrity
                check_plan_integrity(new_plan)
            new_engine = SpMVEngine(g_new, plan=new_plan,
                                    device=self.device)
            step, inv_deg = self._build_stepper(new_engine, g_new)
        except Exception:
            self.metrics.incr("delta_failures")
            raise
        # commit under both locks: the step thread must not dispatch
        # against a half-swapped (plan, stepper, inv_deg) triple, and
        # submit threads must not route against a stale engine. Lock
        # order (step, then intake) matches step().
        with self._step_lock, self._lock:
            self.g = g_new
            self.engine = new_engine
            self._step_c, self._inv_deg = step, inv_deg
            # push engines index the graph's CSR: refresh the internal
            # graph and bump the generation so every thread-local
            # engine rebuilds against the post-delta edges
            self._g_int = internal_graph(g_new, new_plan)
            self._push_gen += 1
            self.rebind_count += 1
        if new_plan is not old_plan:
            release_device(old_plan)

    # ------------------------------------------------------------ intake
    def submit(self, seeds: np.ndarray | None = None, *,
               top_k: int | None = None, tol: float = 1e-6,
               max_iters: int = 100, deadline_s: float | None = None,
               priority: int = 0, route: str | None = None) -> int:
        """Enqueue one query; returns its uid. ``seeds`` is an (n,)
        teleport distribution (need not be normalized — it is; float64
        is taken as float32, as the JAX package takes it), or None for
        uniform teleport. ``tol=0`` runs exactly ``max_iters``
        iterations. ``deadline_s`` is a wall-clock budget from now
        (queue wait + service; defaults to
        ``resilience.default_deadline_s``); ``priority`` orders
        admission, higher first.

        ``route`` overrides the scheduler's default: ``"auto"`` serves
        loose-tolerance (``tol >= push_tol``) top-k personalized queries
        inline through the forward-push backend and queues everything
        else for the stepper; ``"push"`` forces push (raising if the
        configuration can't support it); ``"stepper"`` never pushes. A
        push that exhausts its budget above the stopping bound falls
        back: the query is queued for the stepper warm-started at the
        push estimate, its consumed sweeps counted against
        ``max_iters`` (``counters["push_fallbacks"]``).

        When the admission queue is bounded (``resilience.max_queue``)
        and full, the query is rejected explicitly: it completes at once
        with ``QueryResult.error`` set and the rejection counted — the
        uid is still returned.

        Thread-safe: intake state commits under the scheduler's lock;
        push compute runs outside it on a per-thread engine."""
        route, use_push = self.validate_request(
            seeds is not None, top_k=top_k, tol=tol,
            max_iters=max_iters, route=route)
        seed = None
        if seeds is not None:
            seed = _normalize_teleport(
                np.asarray(seeds, dtype=np.float32).reshape(self.n))
            if self._perm is not None:
                seed = seed[self._inv]        # into internal space
        if deadline_s is None:
            deadline_s = self.resilience.default_deadline_s
        with self._lock:
            deadline = (self.clock() + deadline_s
                        if deadline_s is not None else None)
            uid = next_uid()
            q = Query(uid, seed, top_k, float(tol), int(max_iters),
                      deadline, int(priority))
            self.metrics.submitted(uid)
        if use_push and self._serve_push(q):
            return uid                # answered inline, never queued
        with self._lock:
            cap = self.resilience.max_queue
            if cap is not None and len(self._queue) >= cap:
                self.metrics.incr("rejected")
                self._terminal(q, error=f"rejected: admission queue "
                                        f"full ({cap})")
                return uid
            self._queue.append(q)
        return uid

    def validate_request(self, have_seed: bool, *, top_k, tol,
                         max_iters, route=None) -> tuple[str, bool]:
        """Validate a request exactly as ``submit`` will — raising the
        same errors — and resolve its routing without allocating a uid
        or touching scheduler state. Returns ``(route, use_push)``."""
        if max_iters < 0:
            raise ValueError(f"max_iters must be >= 0; got {max_iters}")
        if top_k is not None and not 1 <= top_k <= self.n:
            raise ValueError(f"top_k must be in [1, {self.n}]; "
                             f"got {top_k}")
        route = self.route if route is None else route
        if route not in ("auto", "push", "stepper"):
            raise ValueError(f"route must be 'auto', 'push' or "
                             f"'stepper'; got {route!r}")
        if route == "push":
            self._check_push_request(have_seed, tol, max_iters)
        use_push = (route == "push"
                    or (route == "auto"
                        and self._push_eligible(have_seed, top_k, tol,
                                                max_iters)))
        return route, use_push

    # --------------------------------------------------- push routing
    def _push_supported(self) -> bool:
        return (self.engine.backend.supports_push_query
                and self.dangling == "none")

    def _push_eligible(self, have_seed, top_k, tol, max_iters) -> bool:
        """route="auto" rule: push serves single-seed top-k queries at
        loose tolerance — where expanding one seed's frontier beats a
        full (n, B) iteration; full-vector and tight-tolerance queries
        keep the stepper."""
        return (self._push_supported()
                and have_seed and top_k is not None
                and 0.0 < self.push_tol <= tol
                and max_iters > 0)

    def _check_push_request(self, have_seed, tol, max_iters) -> None:
        """route="push" validation — raises before a uid is allocated."""
        if not self.engine.backend.supports_push_query:
            raise ValueError(
                f"backend {self.engine.method!r} does not support push "
                "queries (supports_push_query=False)")
        if self.dangling != "none":
            raise ValueError("route='push' requires dangling='none'; "
                             f"got {self.dangling!r}")
        if not have_seed:
            raise ValueError("route='push' needs a seed: push expands "
                             "a personalized frontier (uniform "
                             "teleport is a full-vector solve)")
        if tol <= 0 or max_iters <= 0:
            raise ValueError("route='push' needs tol > 0 and "
                             "max_iters > 0 (fixed-budget mode is the "
                             "stepper's)")

    def _push_engine(self):
        """Per-thread push engine: a PushQueryEngine's scratch is
        single-query state, so concurrent submitters each get their
        own."""
        tls = self._push_tls
        with self._lock:              # consistent (gen, graph, engine)
            gen, g_int, spmv = self._push_gen, self._g_int, self.engine
        if getattr(tls, "gen", None) != gen:
            from .push import PushQueryEngine
            # built on the internal graph so push estimates are
            # column-compatible with the stepper's slot space (the
            # warm-start fallback writes them straight into a column)
            tls.engine = PushQueryEngine(
                g_int, spmv, damping=self.damping,
                dangling=self.dangling, mode=self.push_mode)
            tls.gen = gen
        return tls.engine

    # ---------------------------------------------- id-space boundary
    def _vec_to_original(self, vec: np.ndarray) -> np.ndarray:
        """Internal-space (n,) vector -> original node labeling."""
        return vec[self._perm] if self._perm is not None else vec

    def _ids_to_original(self, ids: np.ndarray) -> np.ndarray:
        """Internal-space node ids -> original node ids."""
        return self._inv[ids] if self._perm is not None else ids

    def _serve_push(self, q: Query) -> bool:
        """Answer ``q`` inline through the push backend. Returns True
        when a terminal result was produced; False falls through to the
        stepper queue — with the push estimate as a warm start and the
        consumed sweeps charged against the budget when the push ran
        but stopped above its bound (honest fallback, counted)."""
        self.metrics.admitted(q.uid)   # service starts now, no queue
        try:
            res = self._push_engine().query(
                q.seed, tol=q.tol,
                max_sweeps=min(q.max_iters, self.push_max_sweeps),
                top_k=q.top_k)
        except Exception:             # noqa: BLE001 — fall back, count
            self.metrics.incr("push_failures")
            return False
        if not res.converged:
            self.metrics.incr("push_fallbacks")
            q.iters_done = res.sweeps
            q.warm_start = res.estimate
            return False
        self.metrics.incr("push_served")
        self.metrics.completed(q.uid, iterations=res.sweeps,
                               converged=True, degraded=q.degraded,
                               route="push")
        if q.top_k is not None:
            result = QueryResult(
                q.uid, res.sweeps, True, res.residual,
                self.metrics.traces[q.uid].latency_s,
                top_ids=self._ids_to_original(np.asarray(res.top_ids)),
                top_scores=res.top_scores, degraded=q.degraded)
        else:
            result = QueryResult(
                q.uid, res.sweeps, True, res.residual,
                self.metrics.traces[q.uid].latency_s,
                ranks=self._vec_to_original(res.estimate),
                degraded=q.degraded)
        with self._lock:
            self.completed.append(result)
        return True

    @property
    def active_slots(self) -> int:
        return sum(q is not None for q in self._slot_query)

    @property
    def queued(self) -> int:
        return len(self._queue)

    # --------------------------------------------------------- admission
    def _put_small(self, arr) -> torch.Tensor:
        """A small (B,) control array on the pool's device."""
        return torch.as_tensor(arr, device=self.device)

    def _terminal(self, q: Query, *, error: str) -> None:
        """Complete a query that never reached a slot (rejection, queue
        expiry) — explicit terminal state, never a silent drop."""
        self.metrics.completed(q.uid, iterations=0, converged=False,
                               error=error, degraded=q.degraded)
        self.completed.append(QueryResult(
            q.uid, 0, False, None,
            self.metrics.traces[q.uid].latency_s, error=error,
            degraded=q.degraded))

    def _pop_runnable(self) -> Optional[Query]:
        """Next query to admit: expire queued queries already past
        their deadline (explicit terminal state, counted), then pick
        the highest priority, FIFO within a priority."""
        if not self._queue:
            return None
        if any(q.deadline is not None for q in self._queue):
            now = self.clock()
            live = []
            for q in self._queue:
                if q.deadline is not None and now > q.deadline:
                    self.metrics.incr("expired")
                    self._terminal(q, error="deadline expired in queue")
                else:
                    live.append(q)
            self._queue = live
            if not self._queue:
                return None
        best = max(range(len(self._queue)),
                   key=lambda i: (self._queue[i].priority, -i))
        return self._queue.pop(best)

    def _maybe_degrade(self, q: Query) -> None:
        """Approximate-answer mode: when the EWMA service model predicts
        the query cannot converge at its requested tolerance inside its
        deadline, loosen the tolerance at admission — a degraded answer
        beats a shed query."""
        cfg = self.resilience
        if (q.deadline is None or q.tol >= cfg.degrade_tol
                or self._iter_s is None or self._query_iters is None):
            return
        remaining = q.deadline - self.clock()
        if self._query_iters * self._iter_s > remaining:
            q.tol = cfg.degrade_tol
            q.degraded = True
            self.metrics.incr("degraded")

    def _admit(self, slot: int, q: Query) -> None:
        seed = (self._uniform_seed if q.seed is None
                else torch.from_numpy(q.seed).to(self.device))
        # the column admit: the seed as the column's start and its
        # (1 - damping)-scaled teleport as the column's base
        self._pr[:, slot] = seed
        self._base[:, slot] = (1.0 - self.damping) * seed
        if q.warm_start is not None:
            # push-fallback estimate overwrites the column (base stays
            # the seed's, so the iteration targets the same fixed
            # point); one-shot — a quarantine retry re-admits clean
            self._pr[:, slot] = torch.from_numpy(q.warm_start).to(
                self.device)
            q.warm_start = None
        self._slot_query[slot] = q
        self._active[slot] = q.max_iters > q.iters_done
        self._iters[slot] = q.iters_done
        self._tol[slot] = q.tol
        self._max_iters[slot] = q.max_iters
        self._slot_res[slot] = -1.0
        self.metrics.admitted(q.uid)
        if q.max_iters <= q.iters_done:
            # degenerate: no budget left — serve the column as-is
            self._finish(slot, q, residual=None)

    def _admit_from_queue(self) -> int:
        admitted = 0
        for slot in range(self.slots):
            if not self._queue:
                break
            if self._slot_query[slot] is None:
                q = self._pop_runnable()
                if q is None:
                    break
                self._maybe_degrade(q)
                self._admit(slot, q)
                admitted += 1
        return admitted

    # ------------------------------------------------------------- serve
    def step(self) -> int:
        """Admit from the queue, advance every active slot by up to
        ``chunk`` masked iterations (one stepper call), drain slots that
        froze. Returns the number of queries completed (including any
        finished at admission, e.g. ``max_iters=0``).

        Single-caller: slot and device state belong to one stepping
        thread; a second concurrent ``step`` raises at once. Intake
        state shared with ``submit`` is touched under the scheduler
        lock; the stepper itself runs outside it."""
        if not self._step_lock.acquire(blocking=False):
            raise RuntimeError(
                "SlotScheduler.step() called concurrently — the slot "
                "pool has exactly one stepping thread")
        try:
            return self._step_impl()
        finally:
            self._step_lock.release()

    def _step_impl(self) -> int:
        with self._lock:
            before = len(self.completed)
            self._step_idx += 1
            self._admit_from_queue()
            if not self._active.any():
                return len(self.completed) - before
            budget = np.minimum(self._max_iters - self._iters,
                                np.iinfo(np.int32).max).astype(np.int32)
        t0 = time.perf_counter()
        try:
            self._pr, active, took, res = self._step_c(
                self._pr, self._base, self._put_small(self._active),
                self._put_small(self._tol),
                self._put_small(np.maximum(budget, 0)), self._inv_deg)
            # the chunk's one read back (plus the stepper's per-
            # iteration active.any() reads)
            active, took, res = _read_chunk(active, took, res)
        except Exception as exc:      # noqa: BLE001 — resilience layer
            with self._lock:
                self._recover_step_failure(exc)
                return len(self.completed) - before
        self._step_retries = 0
        ran = self._active.copy()
        with self._lock:
            self._iters += took
            self._update_pressure(time.perf_counter() - t0,
                                  int(took.max()))
            requeue: list[int] = []
            for slot in range(self.slots):
                q = self._slot_query[slot]
                if q is None or not ran[slot]:
                    continue          # empty / idle before the call
                if not np.isfinite(res[slot]):
                    # poisoned column: the finiteness-aware freeze rule
                    # stopped it on the device; neighbours kept going
                    self.metrics.incr("quarantined")
                    if q.retries < self.resilience.max_retries:
                        q.retries += 1
                        requeue.append(slot)
                    else:
                        self._fail_slot(
                            slot, q,
                            error=f"quarantined: non-finite residual "
                                  f"after {int(self._iters[slot])} "
                                  f"iterations")
                    continue
                if res[slot] >= 0.0:
                    self._slot_res[slot] = float(res[slot])
                if active[slot]:
                    continue
                self._finish(slot, q, residual=(
                    float(self._slot_res[slot])
                    if self._slot_res[slot] >= 0.0 else None))
            self._active = active & np.array(
                [q is not None for q in self._slot_query])
            for slot in requeue:
                # clean-seed re-admission overwrites the poisoned
                # column; the iterations the poisoned run burned stay
                # charged against the query's budget (and reported)
                q = self._slot_query[slot]
                q.iters_done = int(self._iters[slot])
                if q.iters_done >= q.max_iters:
                    self._fail_slot(
                        slot, q,
                        error=f"quarantined: iteration budget "
                              f"exhausted after {q.retries} retries")
                    continue
                self.metrics.incr("requeued")
                self._admit(slot, q)
            self._sweep_deadlines()
            return len(self.completed) - before

    def _update_pressure(self, dt: float, max_took: int) -> None:
        if max_took <= 0:
            return
        per = dt / max_took
        self._iter_s = (per if self._iter_s is None
                        else 0.7 * self._iter_s + 0.3 * per)

    def _recover_step_failure(self, exc: Exception) -> None:
        """A stepper call raised. A transient failure (within
        ``max_step_retries``) that left the pool unwritten is retried on
        the next ``step()``. Otherwise the in-flight pool is declared
        lost: the stepper updates ``pr`` in place, so a call that failed
        after its first iteration leaves columns advanced by iterations
        the host never counted. Every active query then fails explicitly
        and the pool is reallocated, so queued queries keep being
        served."""
        self.metrics.incr("stepper_failures")
        self._step_retries += 1
        lost = not (isinstance(exc, StepperFailure)
                    and not exc.pool_written)
        if (self._step_retries <= self.resilience.max_step_retries
                and not lost):
            return                    # retry the same call next step
        for slot in range(self.slots):
            q = self._slot_query[slot]
            if q is not None:
                self._fail_slot(slot, q,
                                error=f"stepper failure: {exc}")
        self._init_pool_state()
        self._step_retries = 0

    def _sweep_deadlines(self) -> None:
        """Finish in-flight queries past their deadline with their
        current iterate — an explicit approximate answer (flagged
        ``degraded``), not a cancellation."""
        if not any(q is not None and q.deadline is not None
                   for q in self._slot_query):
            return
        now = self.clock()
        for slot in range(self.slots):
            q = self._slot_query[slot]
            if q is None or q.deadline is None or now <= q.deadline:
                continue
            self.metrics.incr("deadline_hits")
            q.degraded = True
            # before the slot's first residual readback there is no
            # measured residual — surface None, never the -1.0 sentinel
            self._finish(slot, q, residual=(
                float(self._slot_res[slot])
                if self._slot_res[slot] >= 0.0 else None))

    def _fail_slot(self, slot: int, q: Query, *, error: str) -> None:
        """Explicit terminal failure of an in-flight query: no ranks are
        extracted (the column may be poisoned), the slot is freed."""
        it = int(self._iters[slot])
        self.metrics.completed(q.uid, iterations=it, converged=False,
                               error=error, degraded=q.degraded)
        self.completed.append(QueryResult(
            q.uid, it, False, None,
            self.metrics.traces[q.uid].latency_s, error=error,
            degraded=q.degraded))
        self._slot_query[slot] = None
        self._active[slot] = False

    def _finish(self, slot: int, q: Query, *,
                residual: Optional[float]) -> None:
        it = int(self._iters[slot])
        # a missing residual (None) can never read as converged
        converged = residual is not None and 0.0 <= residual < q.tol
        self.metrics.completed(q.uid, iterations=it, converged=converged,
                               degraded=q.degraded)
        if converged:
            self._query_iters = (float(it) if self._query_iters is None
                                 else 0.7 * self._query_iters + 0.3 * it)
        if q.top_k is not None:
            ids, scores = self._topk_fn(self._pr, slot, q.top_k)
            result = QueryResult(
                q.uid, it, converged, residual,
                self.metrics.traces[q.uid].latency_s,
                top_ids=self._ids_to_original(ids.cpu().numpy()),
                top_scores=scores.cpu().numpy(), degraded=q.degraded)
        else:
            # a copy even on the CPU: the pool's column is reused
            ranks = self._pr[:, slot].to("cpu", copy=True).numpy()
            result = QueryResult(
                q.uid, it, converged, residual,
                self.metrics.traces[q.uid].latency_s,
                ranks=self._vec_to_original(ranks),
                degraded=q.degraded)
        self.completed.append(result)
        self._slot_query[slot] = None
        self._active[slot] = False

    def run_until_drained(self, *, max_chunks: int = 100_000
                          ) -> list[QueryResult]:
        """Serve until the queue and every slot are empty. Returns the
        results completed during this call, in completion order."""
        start = len(self.completed)
        for _ in range(max_chunks):
            if not self._queue and self.active_slots == 0:
                break
            self.step()
        else:
            raise RuntimeError(
                f"not drained after {max_chunks} chunks "
                f"({self.queued} queued, {self.active_slots} active)")
        return self.completed[start:]


class GraphRegistry:
    """Named collection of ``SlotScheduler``s — one server process
    serving several graphs, each behind its own stepper.

    Keyword defaults passed at construction apply to every graph;
    per-graph overrides win. ``load`` warm-loads a persisted graph
    (graphs/io.py npz) and builds its scheduler at once; with
    ``plan_path`` it seeds the process plan cache from a persisted plan,
    so even the first build is an ``.npz`` read instead of an edge sort.
    Several schedulers over one graph share one ``GraphPlan``.

    An optional ``memory_budget_bytes`` bounds the summed plan footprint
    (``core.plan.plan_nbytes``): adding a graph past the budget evicts
    least-recently-used idle graphs — never one with queued or in-flight
    queries — releasing their plan-cache chains (``evict_plans``). The
    weighted-fair drain across graphs (``run_until_drained``) and
    ``gateway()`` come with the gateway slice.
    """

    def __init__(self, *, memory_budget_bytes: int | None = None,
                 **defaults):
        self._defaults = defaults
        self.memory_budget_bytes = memory_budget_bytes
        self._schedulers: dict[str, SlotScheduler] = {}
        self._shares: dict[str, float] = {}
        self._plan_bytes: dict[str, int] = {}
        self._last_used: dict[str, int] = {}
        self._use_clock = itertools.count()   # monotone LRU timestamps
        self.evictions = 0

    def add(self, name: str, g: Graph, *, share: float = 1.0,
            **overrides) -> SlotScheduler:
        if name in self._schedulers:
            raise ValueError(f"graph {name!r} already registered")
        if not share > 0:
            raise ValueError(f"share must be > 0; got {share}")
        kw = {**self._defaults, **overrides}
        sch = SlotScheduler(g, **kw)
        self._schedulers[name] = sch
        self._shares[name] = float(share)
        self._plan_bytes[name] = plan_nbytes(sch.engine.plan)
        self._touch(name)
        self._enforce_budget(protect=name)
        return sch

    def load(self, name: str, path: str, *,
             plan_path: str | None = None, **overrides) -> SlotScheduler:
        g = graph_io.load(path)
        if plan_path is not None:
            # validate + seed the process cache, then hand the scheduler
            # an engine wrapping the loaded plan directly — the plan's
            # full config is honored, never rebuilt from defaults
            plan = install_plan(g, graph_io.load_plan(plan_path))
            device = overrides.get("device", self._defaults.get("device"))
            overrides.setdefault("engine", SpMVEngine(g, plan=plan,
                                                      device=device))
        return self.add(name, g, **overrides)

    def get(self, name: str) -> SlotScheduler:
        try:
            return self._schedulers[name]
        except KeyError:
            raise KeyError(
                f"unknown graph {name!r}; registered: "
                f"{sorted(self._schedulers)}") from None

    def submit(self, name: str, seeds: np.ndarray | None = None,
               **kw) -> int:
        sch = self.get(name)
        self._touch(name)
        return sch.submit(seeds, **kw)

    # -------------------------------------------------- memory budget
    @property
    def total_plan_bytes(self) -> int:
        return sum(self._plan_bytes.values())

    def _touch(self, name: str) -> None:
        self._last_used[name] = next(self._use_clock)

    def _busy(self, name: str) -> bool:
        sch = self._schedulers[name]
        return sch.queued > 0 or sch.active_slots > 0

    def evict(self, name: str) -> None:
        """Retire one graph: drop its scheduler and release its plan-
        cache chain. Refuses while the graph has queued or in-flight
        queries."""
        sch = self.get(name)
        if self._busy(name):
            raise ValueError(
                f"cannot evict {name!r}: {sch.queued} queued, "
                f"{sch.active_slots} in flight — drain it first")
        from ..core.plan import evict_plans
        g = sch.g
        for d in (self._schedulers, self._shares, self._plan_bytes,
                  self._last_used):
            d.pop(name, None)
        evict_plans(g, chain=True)
        self.evictions += 1

    def _enforce_budget(self, *, protect: str | None = None) -> None:
        """Evict least-recently-used idle graphs until the summed plan
        footprint fits the budget. When every candidate is busy,
        enforcement defers (stays over budget) rather than dropping live
        queries."""
        if self.memory_budget_bytes is None:
            return
        while self.total_plan_bytes > self.memory_budget_bytes:
            victims = [n for n in self._schedulers
                       if n != protect and not self._busy(n)]
            if not victims:
                return                # all busy — defer, stay over
            self.evict(min(victims, key=lambda n: self._last_used[n]))

    # ------------------------------------------------ later slices
    def run_until_drained(self, *, max_chunks: int = 100_000):
        """The weighted-fair drain across graphs comes with the gateway
        slice; drain one graph with ``get(name).run_until_drained()``."""
        _later("GraphRegistry.run_until_drained (WeightedFair)",
               "gateway (A8)")

    def gateway(self, config=None):
        _later("GraphRegistry.gateway", "gateway (A8)")

    def names(self) -> list[str]:
        return sorted(self._schedulers)

    def __contains__(self, name: str) -> bool:
        return name in self._schedulers

    def __len__(self) -> int:
        return len(self._schedulers)
