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
    sess.plan.save("web.plan.npz")          # persist the preprocessing

``device`` defaults to ``"cuda"`` and raises on a machine without CUDA;
``device="cpu"`` runs on the CPU when asked for.

Deltas, warm starts, checkpoints, the gateway, observability and the
sharded path are later slices of the port: those methods and knobs raise
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
        self._solved_ranks = None

    def stats(self) -> dict:
        """Process-level plan-cache counters and the session's shape."""
        from .core.plan import plan_cache_stats
        return {"plan_cache": dataclasses.asdict(plan_cache_stats()),
                "method": self.config.method, "device": str(self.device),
                "n": self.plan.num_nodes, "m": self.plan.num_edges}

    # ------------------------------------------------------------- run
    def spmv(self, x) -> torch.Tensor:
        """One y = A^T x pass ((n,) or (n, d)) on the plan's backend."""
        return self.engine(x)

    def pagerank(self, *, warm: bool = False,
                 **overrides) -> PageRankResult:
        """Run the fused power iteration with the session defaults;
        keyword overrides (num_iterations/tol/damping/check_every/
        dangling/driver) apply per call."""
        if warm:
            _later("pagerank(warm=True)", "streaming")
        cfg = self.config
        kw = dict(num_iterations=cfg.num_iterations, damping=cfg.damping,
                  tol=cfg.tol, check_every=cfg.check_every,
                  dangling=cfg.dangling)
        kw.update(overrides)
        res = pagerank(self.graph, engine=self.engine, **kw)
        self._solved_ranks = res.ranks
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
    def apply_delta(self, delta):
        _later("Session.apply_delta", "streaming")

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
