"""Backend registry — the run-layer half of the plan/run split.

Every SpMV engine registers ONE ``Backend`` entry:

- ``build_plan(g, cfg) -> GraphPlan``: the host-side preprocessing
  (edge sorts, PNG build, schedules) for that method;
- ``spmv_fn(plan, device) -> (x -> A^T x)``: a closure over the plan's
  streams uploaded to ``device`` — what the fused driver and the engine
  call;
- optional ``phase_fns`` (two-phase scatter/gather) and capability
  flags (``supports_sharding``, ``multi_vector``,
  ``supports_push_query``) that consumers branch on instead of comparing
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

from ..graphs.formats import Graph, lexsort_order, lexsorted
from .partition import Partitioning
from .plan import GraphPlan, PlanConfig, blocked_of, plan_span, shared_png
from .png import (GatherSchedule, build_gather_schedule,
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
    # runs vertex-sharded over the ranks of a torch.distributed group
    # (core/distributed.py)
    supports_sharding: bool = False
    # the JAX package's flag for closures it compiles ahead of time;
    # the port compiles nothing ahead of time, so it is always True and
    # nothing reads it (kept so a Backend written against the JAX
    # package constructs here)
    supports_aot: bool = True
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
    # ``d -> path``: the path kernel B1 takes for an SpMV of width d on
    # this backend's closure (``kernels.pcpm_spmv.b1_path``); None for
    # backends that do not run B1. Read by the solve's spans.
    b1_path: Optional[Callable[[int], str]] = None

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


def resolve_method(method: str, *, sharded: bool = False) -> str:
    """Map a requested method (+ the ``sharded=True`` convenience flag
    of the serving front-ends) to a registered backend name: when the
    named backend cannot shard, fall back to the registered
    sharding-capable one."""
    backend = get_backend(method)
    if not sharded or backend.supports_sharding:
        return method
    for b in _REGISTRY.values():
        if b.supports_sharding:
            return b.name
    raise ValueError("sharded=True but no registered backend supports "
                     "sharding")


def check_device_count(num_shards: int) -> None:
    """The single home of the shards-vs-devices rule (config
    normalization, the engine's loaded-plan path and mesh building). The
    available devices are the world size of the initialized default
    process group, or 1 without one."""
    from .distributed import available_devices
    avail = available_devices()
    if num_shards > avail:
        raise ValueError(f"num_shards={num_shards} exceeds the "
                         f"{avail} available devices")


def resolve_engine(g: Graph, *, method: str, part_size: int,
                   sharded: bool = False, num_shards: Optional[int] = None,
                   engine=None, device=None):
    """Shared engine resolution of the serving front-ends
    (``PageRankServer``, ``SlotScheduler``): construct through the
    registry when no engine is given, otherwise validate the caller's
    engine against the ``sharded=True`` request."""
    from .spmv import SpMVEngine
    if engine is None:
        return SpMVEngine(g, part_size=part_size, num_shards=num_shards,
                          method=resolve_method(method, sharded=sharded),
                          device=device)
    if sharded and not engine.backend.supports_sharding:
        raise ValueError(
            "sharded=True requires a sharding-capable engine; got "
            f"method={engine.method!r}")
    return engine


def normalize_config(cfg: PlanConfig) -> PlanConfig:
    """Canonical cache key: validate the method and the ordering,
    resolve ``num_shards=None`` to the device count for sharding
    backends (validating the bound), and blank the knobs a backend
    ignores (sharding fields, gather_block) so configs differing only
    in irrelevant knobs share one plan."""
    from .distributed import available_devices
    from .plan import DEFAULT_GATHER_BLOCK
    backend = get_backend(cfg.method)
    if cfg.reorder != "none":
        from ..graphs.reorder import available_orderings
        if cfg.reorder not in available_orderings():
            raise ValueError(
                f"unknown reorder {cfg.reorder!r}; valid: "
                f"{available_orderings()}")
    kw = {}
    if backend.supports_sharding:
        shards = cfg.num_shards or available_devices()
        check_device_count(shards)
        if shards != cfg.num_shards:
            kw["num_shards"] = shards
    elif cfg.num_shards is not None:
        kw["num_shards"] = None
    # the mesh axis NAME never affects host preprocessing (meshes are
    # cached per axis on plan._device) — keep it out of the cache key
    if cfg.shard_axis != "shards":
        kw["shard_axis"] = "shards"
    if (not backend.uses_gather_block
            and cfg.gather_block != DEFAULT_GATHER_BLOCK):
        kw["gather_block"] = DEFAULT_GATHER_BLOCK
    return cfg.replace(**kw) if kw else cfg


def _cached(plan: GraphPlan, name: str, device: torch.device, make):
    """``plan._device[(name, device)]``, made on first use, once: threads
    that reach a plan's first use together (the gateway's device thread
    and push workers) wait on the plan's lock for the one upload.
    Observers see each make as a ``device_layout`` span."""
    key = (name, str(device))
    val = plan._device.get(key)
    if val is None:
        with plan._lock:
            val = plan._device.get(key)
            if val is None:
                with plan_span("device_layout", name=name):
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


def sharded_mesh(plan: GraphPlan, axis: str | None = None, device=None):
    """The mesh (``core.distributed.ShardMesh``) a sharded plan runs on,
    built on first use and cached per axis name and device on the plan.
    Raises when the plan wants more shards than this runtime has devices
    (an 8-shard plan loaded at world size 1) instead of truncating the
    mesh against the plan's fixed-shape shard arrays. A mesh built under
    a default group that has since been destroyed is built again (with
    its uploads). Every rank must reach a plan's first use in the same
    order: a mesh smaller than the world is a ``dist.new_group`` that
    every rank creates."""
    from .distributed import build_mesh
    axis = axis or plan.config.shard_axis
    if plan.sharded is None:
        raise ValueError(
            f"backend {plan.method!r} has no sharded layout (mesh is "
            "only meaningful for sharding backends)")
    check_device_count(plan.sharded.num_shards)
    device = torch.device("cuda" if device is None else device)
    key = (("mesh", axis), str(device))
    with plan._lock:
        mesh = plan._device.get(key)
        if mesh is None or not mesh.current:
            mesh = plan._device[key] = build_mesh(
                plan.sharded.num_shards, device=device, axis=axis)
    return mesh


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
    dst, src = lexsorted(g.dst, g.src)
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
    gorder = lexsort_order(bv_dst).astype(np.int32)
    eui, starts, ends, pdst = flat_gather_schedule(
        gorder, bv_dst[gorder], num_nodes=num_nodes, block=block)
    return GatherSchedule(block, len(bv_dst), eui, starts, ends, pdst)


def _build_bvgas(g: Graph, cfg: PlanConfig) -> GraphPlan:
    dstp = g.dst.astype(np.int64) // cfg.part_size
    _, src, dst = lexsorted(dstp, g.src, g.dst)
    return GraphPlan(bv_src=src, bv_dst=dst,
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
    # no blocked form: ``plan.blocked_of`` derives it where it is read
    return GraphPlan(png=shared_png(g, cfg.part_size),
                     **_plan_fields(g, cfg))


def _b1_path_pcpm_pallas(d: int) -> str:
    from ..kernels.pcpm_spmv import b1_path
    # the plan's closure always passes its "tile" gather order
    return b1_path(d, True)


def _spmv_pcpm_pallas(plan: GraphPlan, device: torch.device):
    """d = 1 (B1's "tile" path) reads the PNG's own (U,) updates in the
    gather order built from its streams, O(m + U) on the card; d > 1
    (B1's "warp" path) reads the blocked streams, padded to the heaviest
    partition, which the closure's first such call packs from
    ``blocked_of`` and holds from then on, as it holds the d = 1
    layouts."""
    from ..kernels import pcpm_spmv as b1
    from ..kernels.pcpm_spmv import (pcpm_spmv_pallas, pcpm_spmv_tile,
                                     tile_schedule)
    png = plan.png
    updates = _cached(plan, "updates", device, lambda: (
        _upload(png.update_src, device),
        _upload(png.update_offsets.astype(np.int32), device)))
    schedule = _cached(plan, "tile_schedule", device, lambda: tile_schedule(
        png, device=device))

    packed = None

    def fn(x):
        nonlocal packed
        if x.dim() == 1 or x.shape[1] == 1:
            return pcpm_spmv_tile(x, *updates, schedule)
        if packed is None:
            # ``b1.pack_blocked`` read at the fill, which may come long
            # after the closure was made
            packed = _cached(plan, "packed", device, lambda: b1.pack_blocked(
                blocked_of(plan), plan.num_nodes, device=device))
        return pcpm_spmv_pallas(packed, x)

    return fn


# ---------------------------------------------------------------------------
# pcpm_sharded — all-to-all PCPM over torch.distributed ranks
# (core/distributed.py)
# ---------------------------------------------------------------------------
def _build_pcpm_sharded(g: Graph, cfg: PlanConfig) -> GraphPlan:
    from .distributed import build_sharded_png
    layout = build_sharded_png(g, cfg.num_shards,
                               gather_block=cfg.gather_block)
    return GraphPlan(sharded=layout, **_plan_fields(g, cfg))


def _spmv_pcpm_sharded(plan: GraphPlan, device: torch.device):
    """``x -> A^T x`` on (n,) or (n, d) x, the same on every rank: the
    all-to-all SpMV over x padded to the shards, sliced back to n, on
    the plan's current mesh (its uploads are cached on the mesh)."""
    from .distributed import pcpm_all_to_all_spmv
    n, n_pad = plan.num_nodes, plan.sharded.padded_nodes

    def fn(x):
        spmv = pcpm_all_to_all_spmv(plan.sharded,
                                    sharded_mesh(plan, device=device))
        xp = x.new_zeros((n_pad,) + tuple(x.shape[1:]))
        xp[:n] = x
        return spmv(xp)[:n]

    return fn


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
            patch_plan=_patch_pcpm_pallas, supports_push_query=True,
            b1_path=_b1_path_pcpm_pallas),
    # pcpm_sharded has no patcher: the shard-local receive buffers and
    # the all-to-all send schedule are global layouts (a delta anywhere
    # can grow any shard's wire stream), so deltas take a full rebuild —
    # the residual-push warm start still applies. No push queries
    # either: the (n,) query state is one device's.
    Backend("pcpm_sharded", _build_pcpm_sharded, _spmv_pcpm_sharded,
            supports_sharding=True, uses_gather_block=True),
):
    register_backend(_backend)
