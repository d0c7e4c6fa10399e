"""GraphPlan — the immutable preprocessing artifact.

The paper's central amortization argument (§VI-D3) is that PCPM is a
*preprocess-then-iterate* method: the PNG layout, partitioning and
gather schedules are built once on the host and reused by every
subsequent SpMV. This module makes that artifact a first-class value:

- ``PlanConfig``: the hashable knob set that determines a plan
  (method, part_size, gather_block, reorder).
- ``GraphPlan``: everything host-side preprocessing produces for one
  ``(graph, PlanConfig)`` — ``Partitioning``, ``PNGLayout``, blocked /
  gather-schedule variants. Immutable and hashable (identity), with a
  non-serialized runtime cache (``_device``) where backends park
  uploaded streams, packed kernel layouts and closures, keyed per
  device.
- a process-level plan cache keyed on ``(graph fingerprint, config)``
  — every consumer (``SpMVEngine``, ``pagerank()``, ``Session``,
  ``PageRankServer``, ``SlotScheduler``) resolves plans through it, so
  one graph served four ways still sorts its edges exactly once;
  ``evict_plans`` retires one graph's entries and ``plan_nbytes`` sizes
  a plan for ``GraphRegistry``'s memory budget.
- ``GraphPlan.save``/``load`` and ``plan_from_arrays``: the JAX
  package's ``.npz`` plan format (version 3), so a plan saved by either
  package loads in the other with equal arrays.

The per-backend *build* functions live in ``core/backends.py``; this
module only owns the artifact, the cache and the serialization.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np

from ..graphs.formats import Graph
from .partition import Partitioning
from .png import BlockedPNG, GatherSchedule, PNGLayout, build_png


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
DEFAULT_GATHER_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Host-preprocessing knobs. Hashable — the cache key half."""
    method: str = "pcpm"
    part_size: int = 65536
    gather_block: int = DEFAULT_GATHER_BLOCK
    # locality-enhancing node relabeling (paper §VI-D1, graphs/
    # reorder.py): the plan's layouts are built on the RELABELED graph
    # while the plan itself stays keyed to the original graph's
    # fingerprint — the reorder name is part of this cache-key half,
    # so each ordering gets its own plan entry
    reorder: str = "none"

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)   # eq=False: identity hash
class GraphPlan:
    """Everything host-side preprocessing produced for one
    ``(graph, PlanConfig)``. Only the fields the plan's backend needs
    are populated; the rest stay None.

    ``_device`` is a runtime-only cache (device uploads per device,
    packed kernel layouts, closures, the fused-loop cache) — it never
    participates in plan identity.
    """
    config: PlanConfig
    num_nodes: int
    num_edges: int
    partitioning: Partitioning
    # pdpr: edges in pull (dst-sorted) order
    csc_src: Optional[np.ndarray] = None
    csc_dst: Optional[np.ndarray] = None
    # bvgas: edges in dst-partition-major order
    bv_src: Optional[np.ndarray] = None
    bv_dst: Optional[np.ndarray] = None
    # pcpm / pcpm_pallas
    png: Optional[PNGLayout] = None
    schedule: Optional[GatherSchedule] = None
    blocked: Optional[BlockedPNG] = None
    # content hash of the graph this plan was built from — lets
    # install_plan refuse a plan/graph mismatch instead of silently
    # serving wrong preprocessing
    graph_fp: Optional[str] = None
    # fingerprint of the graph this plan was patched from (the streaming
    # slice): patched plans form a parent chain g0 -> g1 -> ... that
    # ``evict_plans`` releases as one unit
    parent_fp: Optional[str] = None
    # locality relabeling (config.reorder != "none"): the layouts above
    # were built on ``g.relabel(reorder_perm)``; every consumer maps
    # inputs in via the inverse and results back via the permutation
    # (``internal_graph`` / ``reorder_inverse`` below)
    reorder_perm: Optional[np.ndarray] = None    # (n,) int32, old -> new
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------- views
    @property
    def method(self) -> str:
        return self.config.method

    @property
    def part_size(self) -> int:
        return self.config.part_size

    @property
    def compression_ratio(self) -> float:
        """r = |E| / |E'| (paper table V)."""
        if self.png is not None:
            return self.png.compression_ratio
        return 1.0

    # ----------------------------------------------------- serialization
    def save(self, path: str) -> None:
        """Persist the host-side artifact as one compressed ``.npz`` in
        the JAX package's plan format (version 3), so either package
        loads it. Device-side state (``_device``) is rebuilt on first
        use after ``load``."""
        arrays: dict[str, np.ndarray] = {}
        if self.reorder_perm is not None:
            arrays["reorder_perm"] = self.reorder_perm
        c = self.config
        meta: dict[str, Any] = {
            "version": 3,
            # the JAX package's PlanConfig fields, sharding ones unset
            "config": {"method": c.method, "part_size": c.part_size,
                       "num_shards": None, "shard_axis": "shards",
                       "gather_block": c.gather_block,
                       "reorder": c.reorder},
            "num_nodes": self.num_nodes,
            "num_edges": self.num_edges,
            "graph_fp": self.graph_fp,
            "parent_fp": self.parent_fp,
        }
        for key in ("csc_src", "csc_dst", "bv_src", "bv_dst"):
            arr = getattr(self, key)
            if arr is not None:
                arrays[key] = arr
        if self.png is not None:
            p = self.png
            arrays.update({"png/update_src": p.update_src,
                           "png/update_offsets": p.update_offsets,
                           "png/edge_update_idx": p.edge_update_idx,
                           "png/edge_dst": p.edge_dst,
                           "png/edge_offsets": p.edge_offsets})
        if self.schedule is not None:
            s = self.schedule
            meta["schedule"] = {"block": s.block, "num_edges": s.num_edges}
            arrays.update({"sched/eui": s.edge_update_idx_padded,
                           "sched/piece_start": s.piece_start,
                           "sched/piece_end": s.piece_end,
                           "sched/piece_dst": s.piece_dst})
        if self.blocked is not None:
            b = self.blocked
            meta["blocked"] = {"part_size": b.part_size,
                               "update_pad_frac": b.update_pad_frac,
                               "edge_pad_frac": b.edge_pad_frac}
            arrays.update({"blk/update_src": b.update_src,
                           "blk/edge_update_local": b.edge_update_local,
                           "blk/edge_dst_local": b.edge_dst_local})
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)

    @staticmethod
    def load(path: str) -> "GraphPlan":
        """A plan saved by ``save`` here or by the JAX package's
        ``GraphPlan.save`` (format version 3, or 2, which lacks only the
        ``reorder`` field). Sharded plans raise ``NotImplementedError``
        (``plan_from_arrays``)."""
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z:
                raise ValueError(
                    f"{path!r} is not a GraphPlan file (no __meta__ entry "
                    "— a raw graph npz goes through graphs.io.load)")
            meta = json.loads(str(z["__meta__"]))
            arrays = {name: z[name] for name in z.files
                      if name != "__meta__"}
        if meta.get("version") not in (2, 3):
            raise ValueError(
                f"unsupported plan format version {meta.get('version')!r}"
                f" in {path!r} (this build reads versions 2 and 3)")
        return plan_from_arrays(meta, arrays)


def plan_from_arrays(fields: dict, arrays) -> GraphPlan:
    """A ``GraphPlan`` from host arrays and scalar fields.

    ``fields`` and ``arrays`` follow the JAX package's plan-file layout
    (format v3): ``fields`` holds ``config`` (the ``PlanConfig`` fields
    as a dict), ``num_nodes``, ``num_edges``, ``graph_fp`` and, where
    present, ``schedule`` ({block, num_edges}) and ``blocked``
    ({part_size, update_pad_frac, edge_pad_frac}); ``arrays`` maps
    ``csc_src``/``csc_dst``/``bv_src``/``bv_dst``/``reorder_perm`` and
    the ``png/*``, ``sched/*`` and ``blk/*`` names to numpy arrays.
    A plan built by the JAX package thus runs in the port unchanged.
    """
    cfg = dict(fields["config"])
    if cfg.pop("num_shards", None) is not None or "sharded" in fields:
        raise NotImplementedError(
            "sharded plans (pcpm_sharded) are not ported yet: they come "
            "with the sharded-path slice")
    cfg.pop("shard_axis", None)
    cfg = PlanConfig(**cfg)
    from .backends import get_backend
    get_backend(cfg.method)       # unknown method: crisp ValueError
    n, m = int(fields["num_nodes"]), int(fields["num_edges"])
    part = Partitioning(n, cfg.part_size)
    kw: dict[str, Any] = {}
    for key in ("csc_src", "csc_dst", "bv_src", "bv_dst", "reorder_perm"):
        if key in arrays:
            kw[key] = np.asarray(arrays[key])
    if "png/update_src" in arrays:
        kw["png"] = PNGLayout(part, *(np.asarray(arrays[f"png/{name}"])
                                      for name in ("update_src",
                                                   "update_offsets",
                                                   "edge_update_idx",
                                                   "edge_dst",
                                                   "edge_offsets")),
                              n, m)
    if "schedule" in fields:
        s = fields["schedule"]
        kw["schedule"] = GatherSchedule(
            int(s["block"]), int(s["num_edges"]),
            *(np.asarray(arrays[f"sched/{name}"])
              for name in ("eui", "piece_start", "piece_end",
                           "piece_dst")))
    if "blocked" in fields:
        b = fields["blocked"]
        kw["blocked"] = BlockedPNG(
            int(b["part_size"]), np.asarray(arrays["blk/update_src"]),
            np.asarray(arrays["blk/edge_update_local"]),
            np.asarray(arrays["blk/edge_dst_local"]),
            float(b["update_pad_frac"]), float(b["edge_pad_frac"]))
    needs = {"pdpr": ("csc_src", "schedule"), "bvgas": ("bv_src", "schedule"),
             "pcpm": ("png", "schedule"), "pcpm_pallas": ("png", "blocked")}
    missing = [f for f in needs.get(cfg.method, ()) if f not in kw]
    if missing:
        raise ValueError(f"a {cfg.method!r} plan needs {missing}; the "
                         "given arrays and fields do not hold them")
    if cfg.reorder != "none" and "reorder_perm" not in kw:
        raise ValueError(
            f"plan declares reorder={cfg.reorder!r} but holds no "
            "permutation — refusing to serve internal-space layouts "
            "without the mapping back")
    return GraphPlan(cfg, n, m, part, graph_fp=fields.get("graph_fp"),
                     parent_fp=fields.get("parent_fp"), **kw)


# ---------------------------------------------------------------------------
# Process-level plan cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PlanCacheStats:
    plan_builds: int = 0
    plan_hits: int = 0
    png_builds: int = 0
    png_hits: int = 0
    plan_patches: int = 0    # incremental patches (stream/patch.py)


_PLAN_CACHE: dict[tuple, GraphPlan] = {}
_PNG_CACHE: dict[tuple, PNGLayout] = {}
_STATS = PlanCacheStats()

# Bound on cached entries: a long-lived process streaming many graphs
# must not pin preprocessing arrays + device uploads without limit.
# Overflow evicts the least recently used entry — safe, because live
# engines/Sessions hold their own plan reference; only a future cache
# hit is lost.
MAX_CACHED_PLANS = 128
MAX_CACHED_PNGS = 128


def _bounded_insert(cache: dict, limit: int, key, value) -> None:
    if key not in cache and len(cache) >= limit:
        cache.pop(next(iter(cache)))       # least recently used
    cache[key] = value


def _touch(cache: dict, key) -> None:
    """Refresh recency (dicts iterate in insertion order, so a hit
    moves the entry to the back — a hot graph's plan is never the
    one evicted by a stream of one-shot graphs)."""
    cache[key] = cache.pop(key)


def plan_cache_stats() -> PlanCacheStats:
    """Live build/hit counters (tests assert build count == 1)."""
    return _STATS


def clear_plan_cache() -> None:
    """Drop every cached plan and PNG layout and reset the counters."""
    _PLAN_CACHE.clear()
    _PNG_CACHE.clear()
    _STATS.plan_builds = _STATS.plan_hits = 0
    _STATS.png_builds = _STATS.png_hits = 0
    _STATS.plan_patches = 0


def add_plan_observer(obs) -> None:
    """Plan build/hit/patch notifications come with the observability
    slice of the port."""
    from ..api import _later
    _later("add_plan_observer", "observability (A9)")


def peek_plan(fp: str, config: PlanConfig) -> Optional[GraphPlan]:
    """Plan-cache lookup by fingerprint without building on a miss (a
    hit refreshes LRU recency and counts as a cache hit)."""
    plan = _PLAN_CACHE.get((fp, config))
    if plan is not None:
        _STATS.plan_hits += 1
        _touch(_PLAN_CACHE, (fp, config))
    return plan


def peek_shared_png(fp: str, part_size: int) -> Optional[PNGLayout]:
    """PNG-cache lookup by fingerprint without building on a miss."""
    png = _PNG_CACHE.get((fp, part_size))
    if png is not None:
        _STATS.png_hits += 1
        _touch(_PNG_CACHE, (fp, part_size))
    return png


def _edge_hash64(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """splitmix64 of the packed (src, dst) pair, vectorized (uint64
    arithmetic wraps, which is the point)."""
    h = ((src.astype(np.uint64) << np.uint64(32))
         | dst.astype(np.uint64))
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def _fp_string(num_nodes: int, num_edges: int, parts) -> str:
    return (f"{num_nodes:x}.{num_edges:x}."
            f"{int(parts[0]):016x}{int(parts[1]):016x}")


def graph_fingerprint(g: Graph) -> str:
    """Content hash of the edge MULTISET — two equal graphs share
    plans even when their COO edge lists arrive in different orders
    (every backend lexsorts before building, so the plans are
    identical).

    The hash is a commutative-invertible pair (sum, xor) over per-edge
    splitmix64 values: order-independent WITHOUT sorting (one O(M)
    vectorized pass), the same string the JAX package computes for the
    same graph, and incrementally updatable: ``stream.apply_delta``
    derives the new graph's parts from the old one's in O(|delta|), so
    a delta stream never re-hashes the full edge list. The string and
    the parts are memoized on the instance."""
    fp = g.__dict__.get("_plan_fingerprint")
    if fp is None:
        parts = g.__dict__.get("_fp_parts")
        if parts is None:
            h = _edge_hash64(g.src, g.dst)
            parts = (int(h.sum(dtype=np.uint64)),
                     int(np.bitwise_xor.reduce(h, initial=np.uint64(0))))
            g.__dict__["_fp_parts"] = parts   # frozen-safe: dict write
        fp = _fp_string(g.num_nodes, g.num_edges, parts)
        g.__dict__["_plan_fingerprint"] = fp
    return fp


def validate_plan(g: Graph, plan: GraphPlan) -> GraphPlan:
    """Raise ``ValueError`` unless ``plan`` belongs to ``g`` (size and
    content fingerprint) — shared guard of ``install_plan`` and
    ``SpMVEngine(plan=...)``; a wrong plan must fail loudly, never
    silently serve wrong preprocessing."""
    if (plan.num_nodes, plan.num_edges) != (g.num_nodes, g.num_edges):
        raise ValueError(
            f"plan/graph mismatch: plan is for n={plan.num_nodes}, "
            f"m={plan.num_edges}; graph has n={g.num_nodes}, "
            f"m={g.num_edges}")
    fp = graph_fingerprint(g)
    if plan.graph_fp is not None and plan.graph_fp != fp:
        raise ValueError(
            "plan/graph mismatch: the plan was built from a graph "
            "with a different edge set (content fingerprint "
            f"{plan.graph_fp[:12]}… != {fp[:12]}…)")
    return plan


def shared_png(g: Graph, part_size: int) -> PNGLayout:
    """The PNG layout for ``(graph, part_size)`` — method-independent,
    so ``pcpm`` and ``pcpm_pallas`` plans share ONE build."""
    key = (graph_fingerprint(g), part_size)
    png = _PNG_CACHE.get(key)
    if png is not None:
        _STATS.png_hits += 1
        _touch(_PNG_CACHE, key)
        return png
    _STATS.png_builds += 1
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    _bounded_insert(_PNG_CACHE, MAX_CACHED_PNGS, key, png)
    return png


def build_plan(g: Graph, config: PlanConfig | None = None) -> GraphPlan:
    """THE way to get a plan: normalize the config, consult the
    process-level cache, delegate a miss to the registered backend's
    ``build_plan``."""
    from .backends import get_backend, normalize_config
    from ..graphs.formats import validate_graph
    validate_graph(g)     # crisp ValueError on out-of-range ids, not
    cfg = normalize_config(config or PlanConfig())   # an index crash
    fp = graph_fingerprint(g)
    key = (fp, cfg)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _STATS.plan_hits += 1
        _touch(_PLAN_CACHE, key)
        return plan
    _STATS.plan_builds += 1
    if cfg.reorder != "none":
        # build every layout on the RELABELED graph (contiguous hub
        # labels raise PNG compression), but stamp the ORIGINAL graph's
        # fingerprint: the plan belongs to g, and the reorder name in
        # cfg keeps the cache entry distinct
        from ..graphs.reorder import reorder_permutation
        perm = reorder_permutation(g, cfg.reorder)
        plan = get_backend(cfg.method).build_plan(g.relabel(perm), cfg)
        plan = dataclasses.replace(plan, reorder_perm=perm, graph_fp=fp)
    else:
        plan = get_backend(cfg.method).build_plan(g, cfg)
    if plan.graph_fp is None:
        plan = dataclasses.replace(plan, graph_fp=fp)
    _bounded_insert(_PLAN_CACHE, MAX_CACHED_PLANS, key, plan)
    return plan


def install_plan(g: Graph, plan: GraphPlan) -> GraphPlan:
    """Seed the cache with a plan built elsewhere (e.g. one carried over
    with ``plan_from_arrays``) so every subsequent ``build_plan`` /
    ``Session`` on ``g`` with the same config starts warm instead of
    re-sorting edges.

    Raises ``ValueError`` when the plan does not belong to ``g`` (size
    or content-fingerprint mismatch, see ``validate_plan``)."""
    from .backends import normalize_config
    validate_plan(g, plan)
    fp = graph_fingerprint(g)
    cfg = normalize_config(plan.config)
    if plan.graph_fp is None:
        plan = dataclasses.replace(plan, graph_fp=fp)
    _bounded_insert(_PLAN_CACHE, MAX_CACHED_PLANS, (fp, cfg), plan)
    # a reordered plan's PNG is of the RELABELED graph — seeding the
    # shared PNG cache under the original fingerprint would poison a
    # later reorder="none" build of the same (graph, part_size)
    if (plan.png is not None and plan.reorder_perm is None
            and (fp, cfg.part_size) not in _PNG_CACHE):
        _bounded_insert(_PNG_CACHE, MAX_CACHED_PNGS,
                        (fp, cfg.part_size), plan.png)
    return plan


def internal_graph(g: Graph, plan: GraphPlan) -> Graph:
    """The graph the plan's layouts actually index: ``g`` itself for
    plain plans, ``g.relabel(perm)`` (cached on the plan) for reordered
    ones. The fused driver runs wholly in this internal space — results
    map back once at the boundary, so the locality win is never taxed
    by per-iteration permutes."""
    if plan.reorder_perm is None:
        return g
    gi = plan._device.get("internal_graph")
    if gi is None:
        gi = g.relabel(plan.reorder_perm)
        plan._device["internal_graph"] = gi
    return gi


def reorder_inverse(plan: GraphPlan) -> np.ndarray:
    """``inv[internal_id] = original_id`` for a reordered plan (cached
    on the plan's runtime dict)."""
    inv = plan._device.get("reorder_inv")
    if inv is None:
        from ..graphs.reorder import inverse_permutation
        inv = inverse_permutation(plan.reorder_perm)
        plan._device["reorder_inv"] = inv
    return inv


def release_device(plan: GraphPlan) -> None:
    """Drop the plan's runtime cache (``_device``): its device uploads,
    closures and loops. The streaming rebinds call it on the plan they
    leave, which the plan cache keeps for its host arrays: at kron-21
    each version would otherwise pin ≈1.15 GB of the card. A closure a
    live consumer still holds keeps its own tensors, so an older handle
    keeps working; a later use of the plan uploads again."""
    plan._device.clear()


def plan_nbytes(plan: GraphPlan) -> int:
    """Host-side footprint of a plan in bytes: the sum of every array
    ``save`` persists. What ``GraphRegistry``'s memory budget accounts
    against (the plan streams dominate a resident graph's cost, and
    unlike device buffers they are exactly enumerable)."""
    arrays: list[np.ndarray] = []
    if plan.reorder_perm is not None:
        arrays.append(plan.reorder_perm)
    for key in ("csc_src", "csc_dst", "bv_src", "bv_dst"):
        arr = getattr(plan, key)
        if arr is not None:
            arrays.append(arr)
    if plan.png is not None:
        p = plan.png
        arrays += [p.update_src, p.update_offsets, p.edge_update_idx,
                   p.edge_dst, p.edge_offsets]
    if plan.schedule is not None:
        s = plan.schedule
        arrays += [s.edge_update_idx_padded, s.piece_start,
                   s.piece_end, s.piece_dst]
    if plan.blocked is not None:
        b = plan.blocked
        arrays += [b.update_src, b.edge_update_local, b.edge_dst_local]
    return sum(int(np.asarray(a).nbytes) for a in arrays)


def _chain_fingerprints(fp: str) -> set[str]:
    """Every fingerprint connected to ``fp`` through cached plans'
    ``parent_fp`` links (both directions, transitively): retiring any
    link of a patch chain retires the whole chain."""
    fps = {fp}
    changed = True
    while changed:
        changed = False
        for plan in _PLAN_CACHE.values():
            links = {f for f in (plan.graph_fp, plan.parent_fp)
                     if f is not None}
            if links & fps and not links <= fps:
                fps |= links
                changed = True
    return fps


def evict_plans(g: Graph, *, chain: bool = True) -> int:
    """Drop every cached plan and PNG layout of ``g`` (live Sessions
    and engines keep their own plan references; only the cache entries,
    and with them the pinned host and device memory once those
    references drop, are released). ``chain=True`` also releases every
    plan linked to ``g`` through ``parent_fp`` patch chains. Returns the
    number of entries evicted."""
    fps = ({graph_fingerprint(g)} if not chain
           else _chain_fingerprints(graph_fingerprint(g)))
    plan_keys = [k for k in _PLAN_CACHE if k[0] in fps]
    png_keys = [k for k in _PNG_CACHE if k[0] in fps]
    for k in plan_keys:
        del _PLAN_CACHE[k]
    for k in png_keys:
        del _PNG_CACHE[k]
    return len(plan_keys) + len(png_keys)
