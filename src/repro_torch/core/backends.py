"""Backend registry — the run-layer half of the plan/run split.

Every SpMV engine registers ONE ``Backend`` entry:

- ``build_plan(g, cfg) -> GraphPlan``: the host-side preprocessing
  (edge sorts, PNG build, schedules) for that method;
- ``spmv_fn(plan, device) -> (x -> A^T x)``: a closure over the plan's
  streams uploaded to ``device`` — what the fused driver and the engine
  call;
- optional ``phase_fns`` (two-phase scatter/gather) and capability
  flags (``multi_vector``, ``supports_push_query``,
  ``supports_sharding``) that consumers branch on instead of comparing
  method strings.

``SpMVEngine``, ``pagerank()``, ``Session`` and the serving front-ends
(``resolve_engine``) resolve backends through this table. Device
uploads are cached on ``plan._device`` per device — shared by every
consumer of the same plan on that device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..graphs.formats import Graph
from .partition import Partitioning
from .plan import GraphPlan, PlanConfig, shared_png
from .png import (GatherSchedule, block_png, build_gather_schedule,
                  flat_gather_schedule)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Backend:
    """One SpMV engine: plan builder + runner + capabilities.

    ``phase_fns`` (optional) returns ``(scatter, gather)`` closures
    over the plan's device streams — the seam for paper-faithful phase
    timing and for ``two_phase=True`` host-barrier execution; backends
    without it reject ``two_phase=True`` at engine construction.
    """
    name: str
    build_plan: Callable[[Graph, PlanConfig], GraphPlan]
    spmv_fn: Callable[[GraphPlan, torch.device], Callable]
    # runs vertex-sharded over several cards: the sharded-path slice;
    # False for every backend until then
    supports_sharding: bool = False
    multi_vector: bool = True          # accepts (n, d) as well as (n,)
    uses_gather_block: bool = False    # plan depends on cfg.gather_block
    # the forward-push query backend (serve/push.py) can answer
    # single-seed personalized queries against this backend's plans
    supports_push_query: bool = False
    phase_fns: Optional[Callable[[GraphPlan, torch.device],
                                 tuple[Callable, Callable]]] = None
    # incremental plan patching (stream/patch.py): rebuild only the
    # partitions an edge delta touched and splice them into the old
    # plan. ``(plan, g_new, delta) -> GraphPlan`` — backends without it
    # fall back to a full rebuild on every delta.
    patch_plan: Optional[Callable] = None

    @property
    def supports_two_phase(self) -> bool:
        return self.phase_fns is not None

    @property
    def supports_incremental(self) -> bool:
        return self.patch_plan is not None


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; registered: "
                         f"{available_backends()}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def resolve_engine(g: Graph, *, method: str, part_size: int,
                   engine=None, device=None):
    """Engine resolution of the serving front-ends (``PageRankServer``,
    ``SlotScheduler``): construct through the registry when no engine is
    given, otherwise use the caller's engine."""
    from .spmv import SpMVEngine
    if engine is None:
        return SpMVEngine(g, method=method, part_size=part_size,
                          device=device)
    return engine


def normalize_config(cfg: PlanConfig) -> PlanConfig:
    """Canonical cache key: validate the method and the ordering, and
    blank the knobs a backend ignores (gather_block) so configs
    differing only in irrelevant knobs share one plan."""
    from .plan import DEFAULT_GATHER_BLOCK
    backend = get_backend(cfg.method)
    if cfg.reorder != "none":
        from ..graphs.reorder import available_orderings
        if cfg.reorder not in available_orderings():
            raise ValueError(
                f"unknown reorder {cfg.reorder!r}; valid: "
                f"{available_orderings()}")
    if (not backend.uses_gather_block
            and cfg.gather_block != DEFAULT_GATHER_BLOCK):
        return cfg.replace(gather_block=DEFAULT_GATHER_BLOCK)
    return cfg


def _cached(plan: GraphPlan, name: str, device: torch.device, make):
    """``plan._device[(name, device)]``, made on first use."""
    key = (name, str(device))
    val = plan._device.get(key)
    if val is None:
        val = make()
        plan._device[key] = val
    return val


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # index streams stay int32 on the device: index_select/index_add_
    # take int32 indices, and int64 would double the bytes streamed
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def spmv_fn(plan: GraphPlan, device: torch.device):
    """The plan's runner closure on ``device``, built once and cached
    on the plan — every consumer of one plan shares one closure and one
    set of device uploads."""
    return _cached(plan, "spmv", device,
                   lambda: get_backend(plan.method).spmv_fn(plan, device))


def two_phase_spmv_fn(plan: GraphPlan, device: torch.device):
    """The plan's host-barriered scatter/gather closure (backends with
    ``phase_fns`` only), cached like ``spmv_fn``. The barrier makes the
    bins round-trip through device memory exactly as the paper's bins
    round-trip through DRAM (phase-timing fidelity)."""
    backend = get_backend(plan.method)
    if backend.phase_fns is None:
        raise ValueError(f"backend {plan.method!r} does not support "
                         "two_phase execution")

    def make():
        scatter, gather = backend.phase_fns(plan, device)

        def fn(x):
            bins = scatter(x)
            if bins.is_cuda:
                torch.cuda.synchronize(bins.device)
            return gather(bins)

        return fn

    return _cached(plan, "two_phase_spmv", device, make)


def reorder_device(plan: GraphPlan, device: torch.device):
    """Device-resident ``(perm, inv)`` int32 tensors for a reordered
    plan (``perm[old] = new``, ``inv[new] = old``), cached on the plan
    — the one-shot boundary maps (``x_int = x[inv]``,
    ``y_orig = y_int[perm]``) gather through these."""
    from .plan import reorder_inverse
    return _cached(plan, "reorder", device,
                   lambda: (_upload(plan.reorder_perm, device),
                            _upload(reorder_inverse(plan), device)))


def fused_loop_cache(plan: GraphPlan) -> dict:
    """Per-plan cache of iteration loops (keyed on their
    hyper-parameters and device) — shared across every engine wrapping
    the same plan."""
    return plan._device.setdefault("fused_cache", {})


# ---------------------------------------------------------------------------
# pdpr — pull-direction baseline (paper alg. 1)
# ---------------------------------------------------------------------------
def _plan_fields(g: Graph, cfg: PlanConfig) -> dict:
    return dict(config=cfg, num_nodes=g.num_nodes, num_edges=g.num_edges,
                partitioning=Partitioning(g.num_nodes, cfg.part_size))


def pdpr_schedule(csc_src: np.ndarray, csc_dst: np.ndarray, *,
                  num_nodes: int, block: int) -> GatherSchedule:
    """Blocked-gather schedule over the pull-order edge stream: the
    "update bins" are x itself, so the per-edge pointer stream is just
    the dst-sorted source ids. Gives pdpr the same hierarchical
    segmented reduction as pcpm — the engines differ only in what they
    stream, not in how they reduce."""
    eui, starts, ends, pdst = flat_gather_schedule(
        csc_src, csc_dst, num_nodes=num_nodes, block=block)
    return GatherSchedule(block, len(csc_dst), eui, starts, ends, pdst)


def _build_pdpr(g: Graph, cfg: PlanConfig) -> GraphPlan:
    order = np.lexsort((g.src, g.dst))
    src, dst = g.src[order], g.dst[order]
    return GraphPlan(csc_src=src, csc_dst=dst,
                     schedule=pdpr_schedule(src, dst,
                                            num_nodes=g.num_nodes,
                                            block=cfg.gather_block),
                     **_plan_fields(g, cfg))


def _sched_device(plan: GraphPlan, device: torch.device):
    s = plan.schedule
    return _cached(plan, "sched", device, lambda: tuple(
        _upload(a, device) for a in (s.edge_update_idx_padded,
                                     s.piece_start, s.piece_end,
                                     s.piece_dst)))


def _blocked_gather(plan: GraphPlan, device: torch.device):
    """The blocked gather over the plan's schedule; for pdpr, whose
    "bins" are x itself, this is the whole SpMV."""
    from .spmv import pcpm_gather_blocked
    eui, ps, pe, pd = _sched_device(plan, device)
    n, blk = plan.num_nodes, plan.schedule.block
    return lambda bins: pcpm_gather_blocked(bins, eui, ps, pe, pd,
                                            num_nodes=n, block=blk)


# ---------------------------------------------------------------------------
# bvgas — Binning w/ Vertex-centric GAS (paper alg. 2)
# ---------------------------------------------------------------------------
def bvgas_schedule(bv_dst: np.ndarray, *, num_nodes: int,
                   block: int) -> GatherSchedule:
    """Blocked-gather schedule over the per-edge bins: the pointer
    stream is the permutation putting the dst-partition-major bins in
    destination order (bins are written in scatter order and read in
    gather order, exactly the paper's bin round-trip)."""
    gorder = np.argsort(bv_dst, kind="stable").astype(np.int32)
    eui, starts, ends, pdst = flat_gather_schedule(
        gorder, bv_dst[gorder], num_nodes=num_nodes, block=block)
    return GatherSchedule(block, len(bv_dst), eui, starts, ends, pdst)


def _build_bvgas(g: Graph, cfg: PlanConfig) -> GraphPlan:
    dstp = g.dst.astype(np.int64) // cfg.part_size
    order = np.lexsort((g.dst, g.src, dstp))
    dst = g.dst[order]
    return GraphPlan(bv_src=g.src[order], bv_dst=dst,
                     schedule=bvgas_schedule(dst, num_nodes=g.num_nodes,
                                             block=cfg.gather_block),
                     **_plan_fields(g, cfg))


def _phases_bvgas(plan: GraphPlan, device: torch.device):
    from .spmv import bvgas_scatter
    src = _cached(plan, "bvgas", device,
                  lambda: _upload(plan.bv_src, device))
    return (lambda x: bvgas_scatter(src, x), _blocked_gather(plan, device))


def _spmv_bvgas(plan: GraphPlan, device: torch.device):
    scatter, gather = _phases_bvgas(plan, device)
    return lambda x: gather(scatter(x))


# ---------------------------------------------------------------------------
# pcpm — Partition-Centric, blocked hierarchical gather (paper algs. 4+5)
# ---------------------------------------------------------------------------
def _build_pcpm(g: Graph, cfg: PlanConfig) -> GraphPlan:
    png = shared_png(g, cfg.part_size)
    sched = build_gather_schedule(png, block=cfg.gather_block)
    return GraphPlan(png=png, schedule=sched, **_plan_fields(g, cfg))


def _phases_pcpm(plan: GraphPlan, device: torch.device):
    from .spmv import pcpm_scatter
    upd = _cached(plan, "pcpm", device,
                  lambda: _upload(plan.png.update_src, device))
    return (lambda x: pcpm_scatter(upd, x), _blocked_gather(plan, device))


def _spmv_pcpm(plan: GraphPlan, device: torch.device):
    scatter, gather = _phases_pcpm(plan, device)
    return lambda x: gather(scatter(x))


# ---------------------------------------------------------------------------
# pcpm_pallas — the gather-kernel path (kernels/pcpm_spmv; on the card
# the kernel is the CUDA port of the JAX package's Pallas kernel, the
# backend keeps its name so plans and configs carry over)
# ---------------------------------------------------------------------------
def _build_pcpm_pallas(g: Graph, cfg: PlanConfig) -> GraphPlan:
    png = shared_png(g, cfg.part_size)
    return GraphPlan(png=png, blocked=block_png(png),
                     **_plan_fields(g, cfg))


def _spmv_pcpm_pallas(plan: GraphPlan, device: torch.device):
    from ..kernels.pcpm_spmv import (pack_blocked, pcpm_spmv_pallas,
                                     tile_schedule)
    packed = _cached(plan, "packed", device, lambda: pack_blocked(
        plan.blocked, plan.num_nodes, device=device))
    # the d = 1 gather order of kernel B1's "tile" path
    schedule = _cached(plan, "tile_schedule", device, lambda: tile_schedule(
        plan.blocked, device=device))
    return lambda x: pcpm_spmv_pallas(packed, x, schedule=schedule)


# ---------------------------------------------------------------------------
# Incremental patchers (stream/patch.py) — imported lazily: the stream
# package imports this registry, so the hook bodies must not import it
# at module load. A patched plan is a new GraphPlan: its device uploads
# are made on first use, as for a fresh one.
# ---------------------------------------------------------------------------
def _patch_pdpr(plan, g_new, delta):
    from ..stream.patch import patch_pdpr_plan
    return patch_pdpr_plan(plan, g_new, delta)


def _patch_bvgas(plan, g_new, delta):
    from ..stream.patch import patch_bvgas_plan
    return patch_bvgas_plan(plan, g_new, delta)


def _patch_pcpm(plan, g_new, delta):
    from ..stream.patch import patch_pcpm_plan
    return patch_pcpm_plan(plan, g_new, delta)


def _patch_pcpm_pallas(plan, g_new, delta):
    from ..stream.patch import patch_pcpm_pallas_plan
    return patch_pcpm_pallas_plan(plan, g_new, delta)


# ---------------------------------------------------------------------------
for _backend in (
    Backend("pdpr", _build_pdpr, _blocked_gather, uses_gather_block=True,
            patch_plan=_patch_pdpr, supports_push_query=True),
    Backend("bvgas", _build_bvgas, _spmv_bvgas, uses_gather_block=True,
            phase_fns=_phases_bvgas, patch_plan=_patch_bvgas,
            supports_push_query=True),
    Backend("pcpm", _build_pcpm, _spmv_pcpm, uses_gather_block=True,
            phase_fns=_phases_pcpm, patch_plan=_patch_pcpm,
            supports_push_query=True),
    Backend("pcpm_pallas", _build_pcpm_pallas, _spmv_pcpm_pallas,
            patch_plan=_patch_pcpm_pallas, supports_push_query=True),
):
    register_backend(_backend)
