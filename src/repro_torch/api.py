"""The front door: ``repro_torch.open(g, EngineConfig(...))``.

One ``EngineConfig`` holds the method / part_size / damping / tol /
iters / dangling knobs. A ``Session`` resolves the graph's
``GraphPlan`` ONCE through the process-level plan cache and runs every
workload from it, on one device:

    sess = repro_torch.open(g, repro_torch.EngineConfig(method="pcpm"))
    res  = sess.pagerank()                  # fused power iteration
    y    = sess.spmv(x)                     # one A^T x pass
    ids, scores = sess.top_ranked(10)
    sch  = sess.serve()                     # continuous-batching pool
    srv  = sess.server(batch=8)             # lockstep batch server
    sess.apply_delta(GraphDelta.insert(e))  # patch the plan (stream/)
    res  = sess.pagerank(warm=True)         # residual push from the old ranks
    sess.plan.save("web.plan.npz")          # persist the preprocessing

``device`` defaults to ``"cuda"`` and raises on a machine without CUDA;
``device="cpu"`` runs on the CPU when asked for.

Checkpoints, the gateway, observability and the sharded path are later
slices of the port: those methods and knobs raise
``NotImplementedError`` naming the slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.pagerank import PageRankResult, pagerank
from .core.plan import DEFAULT_GATHER_BLOCK, GraphPlan, PlanConfig, build_plan
from .core.spmv import SpMVEngine
from .graphs.formats import Graph


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every knob of the plan AND run layers in one hashable value.

    Plan-layer fields (select the ``GraphPlan``): ``method``,
    ``part_size``, ``gather_block``, ``reorder``. Run-layer fields are
    the iteration defaults a ``Session`` applies; ``pagerank`` accepts
    per-call overrides.
    """
    # plan layer
    method: str = "pcpm"
    part_size: int = 65536
    gather_block: int = DEFAULT_GATHER_BLOCK
    # locality-enhancing node relabeling (paper §VI-D1): "none",
    # "degree", "bfs" or "hybrid" — the plan's layouts are built on the
    # relabeled graph; every Session result is mapped back to the
    # original ids
    reorder: str = "none"
    # sharding backends (the sharded-path slice): None or 1 here
    num_shards: Optional[int] = None
    two_phase: bool = False               # rejected by Session (fused)
    # run layer: iteration
    damping: float = 0.85
    num_iterations: int = 20
    tol: float = 0.0
    check_every: int = 1
    dangling: str = "none"
    # run layer: serving
    slots: int = 4
    chunk: int = 8
    # observability (the observability slice): False here
    observe: bool = False

    def plan_config(self) -> PlanConfig:
        return PlanConfig(method=self.method, part_size=self.part_size,
                          gather_block=self.gather_block,
                          reorder=self.reorder)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def _later(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet: it comes with the "
        f"{slice_name} slice of the port (ROADMAP.md, Queue A)")


# the knobs of later slices that the serving front-ends and EngineConfig
# accept: each raises naming its slice unless it is at its default
_LATER_KNOBS = {"fault_injector": "reliability (A6)",
                "idmap": "ingest (A7)", "obs": "observability (A9)",
                "observe": "observability (A9)",
                "sharded": "sharded-path (A10)",
                "num_shards": "sharded-path (A10)"}


def reject_later_knobs(owner: str, **knobs) -> None:
    """Raise ``NotImplementedError`` naming the slice for any later-slice
    knob set away from its default (None, False, or one shard), and
    ``TypeError`` for a name that is no such knob."""
    for name, value in knobs.items():
        if name not in _LATER_KNOBS:
            raise TypeError(f"{owner}() got an unexpected keyword "
                            f"argument {name!r}")
        if value is None or value is False or (
                name == "num_shards" and value == 1):
            continue
        _later(f"{owner}({name}={value!r})", _LATER_KNOBS[name])


class Session:
    """One graph, one plan, one device, every workload.

    Construction resolves (or builds, exactly once per process) the
    ``GraphPlan`` for ``(g, config)``; ``pagerank`` and ``spmv`` both
    run from that single plan.
    """

    def __init__(self, g: Graph, config: EngineConfig | None = None,
                 *, device=None, **overrides):
        from .device import resolve_device
        cfg = config or EngineConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        if cfg.two_phase:
            raise ValueError(
                "two_phase=True cannot be combined with the Session's "
                "fused consumers (pagerank/serve run one device loop, "
                "where the host-side phase barrier does not exist); "
                "build a two-phase SpMVEngine directly for phase timing.")
        reject_later_knobs("EngineConfig", num_shards=cfg.num_shards,
                           observe=cfg.observe)
        self.device = resolve_device(device)
        self.graph = g
        self.config = cfg
        # build_plan validates the graph at entry (crisp ValueError on
        # out-of-range ids / bad dtypes)
        self.plan: GraphPlan = build_plan(g, cfg.plan_config())
        self.engine = SpMVEngine(g, plan=self.plan, device=self.device)
        # warm-start state (DESIGN.md §9): the graph and ranks of the
        # last solve, its (damping, dangling), the L1 step-residual it
        # achieved, and the concatenated deltas applied since
        self._solved_graph = None
        self._solved_ranks = None
        self._solved_key = None
        self._solved_res = np.inf
        self._delta_acc = None

    def stats(self) -> dict:
        """Process-level plan-cache counters and the session's shape."""
        from .core.plan import plan_cache_stats
        return {"plan_cache": dataclasses.asdict(plan_cache_stats()),
                "method": self.config.method, "device": str(self.device),
                "n": self.plan.num_nodes, "m": self.plan.num_edges}

    # ---------------------------------------------------------- deltas
    def apply_delta(self, delta) -> "Session":
        """Advance the session's graph by one edge-delta batch: the plan
        is patched incrementally (dirty partitions only, a full rebuild
        past the dirtiness threshold — stream/patch.py) and the engine
        rebound to it. Accumulates warm-start state so a following
        ``pagerank(warm=True)`` costs a residual push, not a full power
        iteration. The plan left behind stays in the plan cache for its
        host arrays, but its device uploads are released
        (``core.plan.release_device``); serving handles created before
        the delta keep running on the old plan with the uploads they
        already hold — call their ``apply_delta`` or construct new ones
        for the updated graph."""
        from .core.plan import release_device
        from .stream.delta import apply_delta as apply_edges
        from .stream.patch import patch_plan
        g_new = apply_edges(self.graph, delta)
        old_plan = self.plan
        self.plan = patch_plan(old_plan, delta, g_new)
        self.graph = g_new
        self.engine = SpMVEngine(g_new, plan=self.plan, device=self.device)
        if self.plan is not old_plan:
            release_device(old_plan)
        if self._solved_graph is not None:
            self._delta_acc = (delta if self._delta_acc is None
                               else self._delta_acc + delta)
        return self

    # ------------------------------------------------------------- run
    def spmv(self, x) -> torch.Tensor:
        """One y = A^T x pass ((n,) or (n, d)) on the plan's backend."""
        return self.engine(x)

    def pagerank(self, *, warm: bool = False,
                 **overrides) -> PageRankResult:
        """Run the fused power iteration with the session defaults;
        keyword overrides (num_iterations/tol/damping/check_every/
        dangling/driver) apply per call.

        ``warm=True`` after ``apply_delta`` patches the PREVIOUS result
        through the residual push (seeded only at the changed edges'
        endpoints) instead of iterating from scratch. The sparse seed is
        only exact when the stored ranks are a converged fixed point of
        the old graph, so the warm path runs iff the previous solve
        achieved an L1 step-residual <= this call's ``tol`` (and
        damping/dangling match); otherwise it is an honest cold run.
        ``tol`` and ``num_iterations`` mean what they mean cold: the
        same stopping rule, ``num_iterations`` bounds the push sweeps.
        Either way the result is stored as the next warm-start point."""
        cfg = self.config
        kw = dict(num_iterations=cfg.num_iterations, damping=cfg.damping,
                  tol=cfg.tol, check_every=cfg.check_every,
                  dangling=cfg.dangling)
        kw.update(overrides)
        key = (kw["damping"], kw["dangling"])
        tol, budget = kw["tol"], kw["num_iterations"]
        # reordered plans warm-start too: update_ranks maps the stored
        # original-space ranks into the plan's internal space and the
        # result back
        warm_hit = (warm and self._solved_ranks is not None
                    and self._solved_key == key
                    and 0.0 < tol and self._solved_res <= tol)
        if warm_hit:
            from .stream.delta import GraphDelta
            from .stream.incremental import update_ranks
            res = update_ranks(
                self.plan, self._delta_acc or GraphDelta.of(),
                self._solved_ranks, g_old=self._solved_graph,
                g_new=self.graph, damping=kw["damping"],
                dangling=kw["dangling"], tol=tol, max_push=budget,
                device=self.device)
        else:
            res = pagerank(self.graph, engine=self.engine, **kw)
        self._solved_graph = self.graph
        self._solved_ranks = res.ranks
        self._solved_key = key
        self._solved_res = float((res.residuals or [np.inf])[-1])
        self._delta_acc = None
        return res

    def top_ranked(self, k: int = 10):
        """``(ids, scores)`` of the ``k`` highest-ranked nodes from the
        last ``pagerank()`` solve, score descending, then lowest id."""
        if self._solved_ranks is None:
            raise ValueError("no solve yet: run pagerank() first")
        ranks = self._solved_ranks.cpu().numpy()
        k = min(int(k), ranks.shape[0])
        part = np.argpartition(-ranks, k - 1)[:k]
        ids = part[np.lexsort((part, -ranks[part]))]   # score desc, id asc
        return ids.astype(np.int64), ranks[ids]

    # ---------------------------------------------- later slices
    def save_checkpoint(self, path):
        _later("Session.save_checkpoint", "reliability")

    def load_checkpoint(self, path, **kw):
        _later("Session.load_checkpoint", "reliability")

    def serve(self, *, route: str = "auto", **overrides):
        """A continuous-batching ``SlotScheduler`` sharing this
        session's plan, device and device streams. ``route`` picks the
        personalized-query path: ``"auto"`` sends loose-tolerance top-k
        queries through the forward-push backend and the rest to the
        masked chunk stepper, ``"push"``/``"stepper"`` force one side."""
        from .serve.scheduler import SlotScheduler
        cfg = self.config
        kw = dict(slots=cfg.slots, damping=cfg.damping, chunk=cfg.chunk,
                  dangling=cfg.dangling, route=route)
        kw.update(overrides)
        return SlotScheduler(self.graph, engine=self.engine, **kw)

    def server(self, *, batch: int = 1, **overrides):
        """A lockstep ``PageRankServer`` sharing this session's plan
        (batched personalized queries, built once)."""
        from .serve.engine import PageRankServer
        cfg = self.config
        kw = dict(damping=cfg.damping, num_iterations=cfg.num_iterations,
                  tol=cfg.tol, check_every=cfg.check_every,
                  dangling=cfg.dangling)
        kw.update(overrides)
        return PageRankServer(self.graph, engine=self.engine,
                              batch=batch, **kw)

    def gateway(self, **kw):
        _later("Session.gateway", "gateway")

    def observe(self, **kw):
        _later("Session.observe", "observability")


def open(g: Graph, config: EngineConfig | None = None, *, device=None,
         **overrides) -> Session:
    """Open a :class:`Session` on ``g`` — the public front door.
    ``overrides`` are ``EngineConfig`` fields applied on top of
    ``config`` (or the defaults): ``repro_torch.open(g, method="pdpr")``.
    ``device`` defaults to ``"cuda"``."""
    return Session(g, config, device=device, **overrides)
