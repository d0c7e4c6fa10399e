"""The front door: ``repro_torch.open(g, EngineConfig(...))``.

One ``EngineConfig`` holds the method / part_size / damping / tol /
iters / dangling knobs. A ``Session`` resolves the graph's
``GraphPlan`` ONCE through the process-level plan cache and runs every
workload from it, on one device:

    sess = repro_torch.open(g, repro_torch.EngineConfig(method="pcpm"))
    res  = sess.pagerank()                  # fused power iteration
    y    = sess.spmv(x)                     # one A^T x pass
    ids, scores = sess.top_ranked(10)

``device`` defaults to ``"cuda"`` and raises on a machine without CUDA;
``device="cpu"`` runs on the CPU when asked for.

Deltas, warm starts, checkpoints, serving, the gateway and observability
are later slices of the port: those methods raise
``NotImplementedError`` naming the slice.
"""
from __future__ import annotations

import dataclasses

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
    # run layer: iteration
    damping: float = 0.85
    num_iterations: int = 20
    tol: float = 0.0
    check_every: int = 1
    dangling: str = "none"

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
        return self.engine(torch.as_tensor(x, device=self.device))

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

    def serve(self, **kw):
        _later("Session.serve", "serving")

    def server(self, **kw):
        _later("Session.server", "serving")

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
