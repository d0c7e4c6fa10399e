"""The front door: ``repro_torch.open(g, EngineConfig(...))``.

One ``EngineConfig`` holds the method / part_size / num_shards /
damping / tol / iters / dangling / slots knobs. A ``Session`` resolves
the graph's ``GraphPlan`` ONCE through the process-level plan cache and
runs every workload from it, on one device:

    sess = repro_torch.open(g, repro_torch.EngineConfig(method="pcpm"))
    res  = sess.pagerank()                  # fused power iteration
    y    = sess.spmv(x)                     # one A^T x pass
    ids, scores = sess.top_ranked(10)
    sch  = sess.serve()                     # continuous-batching pool
    srv  = sess.server(batch=8)             # lockstep batch server
    gw   = sess.gateway()                   # async front door (futures)
    obs  = sess.observe()                   # spans, metrics, comm
    sess.apply_delta(GraphDelta.insert(e))  # patch the plan (stream/)
    res  = sess.pagerank(warm=True)         # residual push from the old ranks
    sess.plan.save("web.plan.npz")          # persist the preprocessing
    sess.save_checkpoint("ranks.npz")       # a restart warm-starts from it

``device`` defaults to ``"cuda"`` and raises on a machine without CUDA;
``device="cpu"`` runs on the CPU when asked for. ``idmap=`` (an
``ingest.NodeIdMapping``) makes ``top_ranked`` and serving results speak
the external ids of an ingested edge list.

``EngineConfig(method="pcpm_sharded")`` vertex-shards the graph over the
ranks of the caller's ``torch.distributed`` default group (one process
per card; ``num_shards=None`` means all of them) and follows the SPMD
contract of ``core/distributed.py``: every rank makes the same calls in
the same order and gets the same results. Without a process group it
runs as one shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.pagerank import PageRankResult, b1_path, pagerank
from .core.plan import DEFAULT_GATHER_BLOCK, GraphPlan, PlanConfig, build_plan
from .core.spmv import SpMVEngine
from .graphs.formats import Graph


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every knob of the plan AND run layers in one hashable value.

    Plan-layer fields (select the ``GraphPlan``): ``method``,
    ``part_size``, ``num_shards``, ``gather_block``, ``reorder``.
    Run-layer fields are the iteration and serving defaults a
    ``Session`` applies; each method accepts per-call overrides.
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
    # sharding backends: None = every rank of the default group
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
    # observability: attach an ``obs.Observability`` bundle at open
    observe: bool = False

    def plan_config(self) -> PlanConfig:
        return PlanConfig(method=self.method, part_size=self.part_size,
                          num_shards=self.num_shards,
                          gather_block=self.gather_block,
                          reorder=self.reorder)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


class Session:
    """One graph, one plan, one device, every workload.

    Construction resolves (or builds, exactly once per process) the
    ``GraphPlan`` for ``(g, config)``; ``pagerank`` and ``spmv`` both
    run from that single plan.
    """

    def __init__(self, g: Graph, config: EngineConfig | None = None,
                 *, idmap=None, device=None, **overrides):
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
        self.device = resolve_device(device)
        self.graph = g
        self.config = cfg
        # external-id mapping of an ingested graph (ingest/idmap.py),
        # passed on to serving results and ``top_ranked``; None for
        # graphs whose ids are already dense
        self.idmap = idmap
        # observability bundle — None until ``observe()`` is called or
        # ``cfg.observe`` asks for it (before the plan builds, so the
        # session's own preprocessing is on the record)
        self._obs = None
        if cfg.observe:
            self.observe()
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

    # --------------------------------------------------- observability
    def observe(self, *, capacity: int = 8192, dump_dir=None):
        """Attach (or return) this session's ``Observability`` bundle.
        Idempotent: the first call creates it — span tracer over a
        bounded flight recorder, metrics registry, measured-comm
        accountant — and later calls return the same one (their
        arguments are then ignored). Handles created after it exists
        (``serve()``/``gateway()``) report through it, and so do this
        session's ``pagerank`` and ``apply_delta``."""
        if self._obs is None:
            from .obs import Observability
            self._obs = Observability(capacity=capacity,
                                      dump_dir=dump_dir)
        return self._obs

    @property
    def obs(self):
        """The session's ``Observability`` bundle, or None."""
        return self._obs

    def stats(self) -> dict:
        """Process-level plan-cache counters and the session's shape,
        and — when observing — the metrics registry, comm summary and
        flight-recorder occupancy."""
        from .core.plan import plan_cache_stats
        out = {"plan_cache": dataclasses.asdict(plan_cache_stats()),
               "method": self.config.method, "device": str(self.device),
               "n": self.plan.num_nodes, "m": self.plan.num_edges}
        if self._obs is not None:
            out["obs"] = self._obs.stats()
        return out

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
        sp = (self._obs.tracer.start("session_delta", trace="plan",
                                     adds=len(delta.add_src),
                                     removes=len(delta.rem_src))
              if self._obs is not None else None)
        old_plan = self.plan
        try:
            g_new = apply_edges(self.graph, delta)
            self.plan = patch_plan(old_plan, delta, g_new)
        except Exception as e:
            if sp is not None:
                sp.end(status="error", error=repr(e))
            raise
        self.graph = g_new
        self.engine = SpMVEngine(g_new, plan=self.plan, device=self.device)
        if self.plan is not old_plan:
            release_device(old_plan)
        if sp is not None:
            sp.end(n=g_new.num_nodes, m=int(g_new.src.shape[0]))
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
        Either way the result is stored as the next warm-start point.

        With observability on, one ``solve`` span covers the call, the
        fused solve's stage spans nest in it (``core.pagerank``)."""
        sp = (self._obs.tracer.start(
                  "solve", trace="plan", method=self.config.method,
                  n=self.plan.num_nodes, b1_path=b1_path(self.engine),
                  reorder=self.plan.config.reorder)
              if self._obs is not None else None)
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
        if sp is not None:
            sp.annotate(warm=bool(warm_hit))
        try:
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
                res = pagerank(self.graph, engine=self.engine, span=sp,
                               **kw)
        except Exception as e:
            if sp is not None:
                sp.end(status="error", error=repr(e))
            raise
        self._solved_graph = self.graph
        self._solved_ranks = res.ranks
        self._solved_key = key
        self._solved_res = float((res.residuals or [np.inf])[-1])
        self._delta_acc = None
        if sp is not None:
            if not warm_hit:
                # measured comm: one full pass per executed iteration
                # (warm pushes are sparse and don't stream the whole
                # edge structure)
                self._obs.comm.record_solve(self.plan, res.iterations)
            sp.end(iterations=res.iterations, residual=self._solved_res)
        return res

    def top_ranked(self, k: int = 10):
        """``(ids, scores)`` of the ``k`` highest-ranked nodes from the
        last ``pagerank()`` solve, score descending, then lowest id; the
        ids are external labels when the session carries a
        ``NodeIdMapping``, the graph's dense ids otherwise."""
        if self._solved_ranks is None:
            raise ValueError("no solve yet: run pagerank() first")
        ranks = self._solved_ranks.cpu().numpy()
        k = min(int(k), ranks.shape[0])
        part = np.argpartition(-ranks, k - 1)[:k]
        ids = part[np.lexsort((part, -ranks[part]))]   # score desc, id asc
        if self.idmap is not None:
            return self.idmap.to_external(ids), ranks[ids]
        return ids.astype(np.int64), ranks[ids]

    # ----------------------------------------------------- checkpoints
    def save_checkpoint(self, path: str) -> None:
        """Persist the last solve as a fingerprint-stamped rank
        checkpoint (reliability/snapshot.py; ranks as float32 on the
        host), which a restarted process hands to ``load_checkpoint`` to
        warm-start instead of recomputing. Requires a prior
        ``pagerank()`` on this session."""
        if self._solved_ranks is None:
            raise ValueError("nothing to checkpoint: run pagerank() "
                             "first")
        from .reliability.snapshot import save_rank_checkpoint
        save_rank_checkpoint(
            path, self._solved_graph,
            self._solved_ranks.to("cpu", torch.float32).numpy(),
            residual=self._solved_res, damping=self._solved_key[0],
            dangling=self._solved_key[1])

    def load_checkpoint(self, path: str, *, g_old: Graph | None = None,
                        delta=None) -> "Session":
        """Warm-start this session from a rank checkpoint (its ranks
        are uploaded to the session's device).

        - The checkpoint's fingerprint is this session's graph's: the
          ranks become the warm state directly, and the next
          ``pagerank(warm=True)`` is (nearly) free.
        - The checkpoint was taken on ``g_old`` and ``delta`` was applied
          since: pass both. The lineage is proven by fingerprints —
          ``g_old`` must hash to the checkpoint's and ``g_old + delta`` to
          this session's graph — and ``pagerank(warm=True)`` then runs
          the residual push (stream/incremental.py) instead of a cold
          solve.
        - Anything else raises ``ValueError``: a checkpoint of another
          graph must never seed answers."""
        from .core.plan import graph_fingerprint
        from .reliability.snapshot import load_rank_checkpoint
        ckpt = load_rank_checkpoint(path)
        fp_here = graph_fingerprint(self.graph)
        if ckpt.graph_fp == fp_here:
            self._solved_graph = self.graph
            self._delta_acc = None
        elif g_old is not None and delta is not None:
            from .stream.delta import shifted_fingerprint
            if graph_fingerprint(g_old) != ckpt.graph_fp:
                raise ValueError(
                    "checkpoint mismatch: g_old does not hash to the "
                    "checkpoint's graph fingerprint "
                    f"({ckpt.graph_fp[:12]}…)")
            if shifted_fingerprint(ckpt.graph_fp, delta) != fp_here:
                raise ValueError(
                    "checkpoint mismatch: g_old + delta is not this "
                    "session's graph (shifted fingerprint differs) — "
                    "the delta chain does not connect the checkpoint "
                    "to the current graph")
            self._solved_graph = g_old
            self._delta_acc = delta
        else:
            raise ValueError(
                "checkpoint is for a different graph (fingerprint "
                f"{ckpt.graph_fp[:12]}… != {fp_here[:12]}…); pass "
                "g_old= and delta= to warm-start across a delta chain")
        self._solved_ranks = torch.from_numpy(ckpt.ranks).to(self.device)
        self._solved_key = (ckpt.damping, ckpt.dangling)
        self._solved_res = float(ckpt.residual)
        return self

    def serve(self, *, route: str = "auto", **overrides):
        """A continuous-batching ``SlotScheduler`` sharing this
        session's plan, device and device streams. ``route`` picks the
        personalized-query path: ``"auto"`` sends loose-tolerance top-k
        queries through the forward-push backend and the rest to the
        masked chunk stepper, ``"push"``/``"stepper"`` force one side."""
        from .serve.scheduler import SlotScheduler
        cfg = self.config
        kw = dict(slots=cfg.slots, damping=cfg.damping, chunk=cfg.chunk,
                  dangling=cfg.dangling, route=route, idmap=self.idmap,
                  obs=self._obs)
        kw.update(overrides)
        return SlotScheduler(self.graph, engine=self.engine, **kw)

    def gateway(self, *, config=None, autotune: bool = True,
                **overrides):
        """An async serving front door over this session's plan
        (``repro_torch.gateway``): one device thread steps the slot pool,
        a worker pool answers push-eligible queries inline, and
        ``submit()`` returns a future at once, with a warm-result LRU
        serving repeats in O(k).

        ``autotune=True`` probes the engine's measured multi-vector SpMV
        (the call the stepper makes at width B) and sizes the slot pool
        against ``config.target_chunk_s`` instead of the session's
        static ``slots``; an explicit ``slots=`` override wins. The
        chosen size and the probe curve are ``gateway.autotune_report``.

        Over a sharded session it needs world size 1
        (``gateway.frontdoor.check_one_controller``).
        """
        from .gateway import Gateway, GatewayConfig, autotune_slots
        from .gateway.frontdoor import check_one_controller
        check_one_controller(self.engine)
        cfg = config or GatewayConfig()
        report = None
        if autotune and "slots" not in overrides:
            report = autotune_slots(
                self.engine, chunk=overrides.get("chunk",
                                                 self.config.chunk),
                target_chunk_s=cfg.target_chunk_s,
                candidates=cfg.autotune_candidates,
                default=self.config.slots)
            overrides["slots"] = report.chosen
        sch = self.serve(**overrides)
        gw = Gateway(sch, config=cfg)
        gw.autotune_report = report
        return gw

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


def open(g: Graph, config: EngineConfig | None = None, *, idmap=None,
         device=None, **overrides) -> Session:
    """Open a :class:`Session` on ``g`` — the public front door.
    ``overrides`` are ``EngineConfig`` fields applied on top of
    ``config`` (or the defaults): ``repro_torch.open(g, method="pdpr")``.
    ``idmap`` attaches a ``NodeIdMapping`` (ingest/idmap.py) so serving
    and ``top_ranked`` results carry the graph's external ids.
    ``device`` defaults to ``"cuda"``."""
    return Session(g, config, idmap=idmap, device=device, **overrides)
