"""Incremental plan patching (a copy of the JAX package's
``stream/patch.py``; DESIGN.md §9).

Every single-device plan layout in this repo is *partition-major*:
partitions are contiguous destination-ID ranges and each backend's
streams are primarily sorted by destination partition — so the segment
of a layout belonging to partition p depends ONLY on the edges whose
destination lands in p.  An edge delta therefore dirties exactly the
partitions ``{dst // part_size}`` of its changed edges, and a new plan
can be assembled by

  1. recovering the dirty partitions' edges FROM THE OLD PLAN (the PNG
     stores src via ``update_src[edge_update_idx]``; pdpr/bvgas store
     the raw streams),
  2. applying the delta (multiset removal + insertion) to those edges
     only,
  3. re-running the per-partition build — the ONLY sorting work, over
     dirty edges instead of all M — and
  4. splicing rebuilt segments between untouched ones (clean segments
     are memcpy + a per-partition pointer shift).

The splice is exact: the patched arrays are ``np.array_equal`` to a
from-scratch build, so a patched plan is not an approximation — it IS
the plan. tests/test_torch_stream.py holds them against ``build_png``/
``block_png``/``pdpr_schedule`` called directly: a build through
``build_plan`` would get the patched PNG back from the shared PNG cache,
which ``install_plan`` seeds.

Derived schedules (blocked gather runs, BlockedPNG re-layout) are
re-derived from the spliced streams: both are sort-free vectorized
O(M) passes, noise next to the lexsorts they replace.

``patch_plan`` is the front door: it consults the plan cache, applies
the registered backend patcher, falls back to a full rebuild past a
dirtiness threshold (or for backends without a patcher, e.g.
pcpm_sharded whose all-to-all wire layout is global), stamps the
``parent_fp`` chain and installs the result so every consumer — the
Session, schedulers, shims — warm-starts from it.

A patched plan is a new ``GraphPlan`` with an empty runtime cache: its
device uploads (for pcpm_pallas the packed streams and kernel B1's
"tile" gather order) are made on first use, as for a fresh plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import plan as plan_mod
from ..core.backends import get_backend
from ..core.plan import GraphPlan, graph_fingerprint, install_plan
from ..core.png import PNGLayout, build_gather_schedule, block_png
from ..graphs.formats import Graph
from .delta import GraphDelta, gather_ranges, multiset_keep_mask

# Past this fraction of dirty partitions a full rebuild is cheaper
# than recovering + splicing (measured crossover is flat between 0.3
# and 0.7 at bench scale; the win we chase is the <<1% regime anyway).
DIRTY_THRESHOLD = 0.5


def _dirty_edges(delta: GraphDelta, old_src: np.ndarray,
                 old_dst: np.ndarray, num_nodes: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Apply the delta to the dirty partitions' recovered edge set."""
    if delta.num_removed:
        keep = multiset_keep_mask(old_src, old_dst, delta.rem_src,
                                  delta.rem_dst, num_nodes=num_nodes)
        old_src, old_dst = old_src[keep], old_dst[keep]
    if delta.num_added:
        old_src = np.concatenate([old_src, delta.add_src])
        old_dst = np.concatenate([old_dst, delta.add_dst])
    return old_src, old_dst


def _splice(old_vals: np.ndarray, old_offsets: np.ndarray,
            dirty: np.ndarray, dirty_vals: np.ndarray,
            dirty_counts: np.ndarray,
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace the ``dirty`` partitions' segments of a partition-major
    stream with ``dirty_vals`` (concatenated in ascending-partition
    order, per-partition sizes ``dirty_counts``).

    Returns ``(new_vals, new_offsets, clean_positions)`` where
    ``clean_positions`` are the destination indices the old clean
    values were copied to (callers needing a per-partition fixup on
    clean entries — e.g. the PNG's update-pointer shift — apply it
    there).
    """
    k = len(old_offsets) - 1
    counts = np.diff(old_offsets)
    new_counts = counts.copy()
    new_counts[dirty] = dirty_counts
    new_offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(new_counts, out=new_offsets[1:])
    clean = np.ones(k, dtype=bool)
    clean[dirty] = False
    clean_idx = np.flatnonzero(clean)
    new_vals = np.empty(int(new_offsets[-1]), dtype=old_vals.dtype)
    clean_pos = gather_ranges(new_offsets[clean_idx], counts[clean_idx])
    new_vals[clean_pos] = old_vals[
        gather_ranges(old_offsets[clean_idx], counts[clean_idx])]
    new_vals[gather_ranges(new_offsets[dirty], dirty_counts)] = dirty_vals
    return new_vals, new_offsets, clean_pos


def patch_png(png: PNGLayout, delta: GraphDelta) -> PNGLayout:
    """Splice-rebuild the PNG for the delta's dirty partitions only.

    Exactly equals ``build_png(apply_delta(g), part)``: clean
    partitions keep their segments verbatim (edge pointers shifted by
    the preceding partitions' update-count change), dirty partitions
    re-run the paper's compress+transpose scans locally.
    """
    part = png.partitioning
    psz = part.part_size
    n = png.num_nodes
    dirty = delta.dirty_partitions(psz)

    # 1. recover the dirty partitions' edges from the old layout
    e_counts = np.diff(png.edge_offsets)
    idx = gather_ranges(png.edge_offsets[dirty], e_counts[dirty])
    old_src = png.update_src[png.edge_update_idx[idx]]
    old_dst = png.edge_dst[idx]

    # 2. delta on those edges only
    src2, dst2 = _dirty_edges(delta, old_src, old_dst, n)

    # 3. per-partition PNG build over the dirty edges (paper §IV-B
    #    scans, restricted): sort by (dstp, src, dst), dedup updates,
    #    then re-sort the edge stream by destination
    dstp2 = dst2.astype(np.int64) // psz
    order = np.lexsort((dst2, src2, dstp2))
    src_s, dst_s, dstp_s = src2[order], dst2[order], dstp2[order]
    pair_key = dstp_s * np.int64(n) + src_s
    new_update = np.empty(len(pair_key), dtype=bool)
    if len(pair_key):
        new_update[0] = True
        np.not_equal(pair_key[1:], pair_key[:-1], out=new_update[1:])
    upd_of_edge = (np.cumsum(new_update) - 1).astype(np.int64)
    upd_src_d = src_s[new_update].astype(np.int32)
    upd_dstp_d = dstp_s[new_update]

    # per-dirty-partition counts (aligned with ``dirty``'s order)
    d_pos = np.searchsorted(dirty, upd_dstp_d)
    u_cnt_d = np.bincount(d_pos, minlength=len(dirty)).astype(np.int64)
    e_pos = np.searchsorted(dirty, dstp_s)
    e_cnt_d = np.bincount(e_pos, minlength=len(dirty)).astype(np.int64)

    # 4a. splice the update stream
    new_update_src, new_uo, _ = _splice(
        png.update_src, png.update_offsets, dirty, upd_src_d, u_cnt_d)

    # global new index of each dirty update: partition base offset +
    # rank within its partition's dirty segment
    dirty_uo = np.zeros(len(dirty) + 1, dtype=np.int64)
    np.cumsum(u_cnt_d, out=dirty_uo[1:])
    upd_global = (new_uo[dirty[d_pos]]
                  + np.arange(len(upd_src_d), dtype=np.int64)
                  - dirty_uo[d_pos]).astype(np.int32)

    # 4b. splice the gather stream (dst-sorted; partitions are
    #     contiguous dst ranges, so the stable per-dirty re-sort
    #     composes into the global dst order)
    gorder = np.argsort(dst_s, kind="stable")
    eui_d = upd_global[upd_of_edge[gorder]]
    dst_d = dst_s[gorder].astype(np.int32)
    new_edge_dst, new_eo, _ = _splice(
        png.edge_dst, png.edge_offsets, dirty, dst_d, e_cnt_d)
    new_eui, _, clean_pos = _splice(
        png.edge_update_idx, png.edge_offsets, dirty, eui_d, e_cnt_d)
    # clean partitions' pointers still index the OLD update stream —
    # shift each by its partition's change in preceding update counts
    k = part.num_partitions
    clean = np.ones(k, dtype=bool)
    clean[dirty] = False
    clean_idx = np.flatnonzero(clean)
    shift = (new_uo[clean_idx] - png.update_offsets[clean_idx])
    e_counts_clean = e_counts[clean_idx]
    if len(clean_pos):
        new_eui[clean_pos] = (
            new_eui[clean_pos]
            + np.repeat(shift, e_counts_clean).astype(np.int32))

    return PNGLayout(part, new_update_src, new_uo, new_eui,
                     new_edge_dst, new_eo, n, int(new_eo[-1]))


# ---------------------------------------------------------------------------
# Backend patchers (registered as Backend.patch_plan in core/backends.py)
# ---------------------------------------------------------------------------
def _patched_fields(plan: GraphPlan, g_new: Graph, m_new: int) -> dict:
    return dict(config=plan.config, num_nodes=plan.num_nodes,
                num_edges=m_new, partitioning=plan.partitioning,
                graph_fp=graph_fingerprint(g_new),
                parent_fp=plan.graph_fp)


def _shared_patched_png(plan: GraphPlan, g_new: Graph,
                        delta: GraphDelta) -> PNGLayout:
    """One spliced PNG per (new graph, part_size): if the sibling
    pcpm/pcpm_pallas backend already patched it, reuse that layout."""
    fp = graph_fingerprint(g_new)
    png = plan_mod.peek_shared_png(fp, plan.part_size)
    if png is None:
        png = patch_png(plan.png, delta)
    return png


def patch_pcpm_plan(plan: GraphPlan, g_new: Graph,
                    delta: GraphDelta) -> GraphPlan:
    png = _shared_patched_png(plan, g_new, delta)
    sched = build_gather_schedule(png, block=plan.config.gather_block)
    return GraphPlan(png=png, schedule=sched,
                     **_patched_fields(plan, g_new, png.num_edges))


def patch_pcpm_pallas_plan(plan: GraphPlan, g_new: Graph,
                           delta: GraphDelta) -> GraphPlan:
    png = _shared_patched_png(plan, g_new, delta)
    return GraphPlan(png=png, blocked=block_png(png),
                     **_patched_fields(plan, g_new, png.num_edges))


def _partition_bounds(dstp: np.ndarray, k: int) -> np.ndarray:
    """Offsets (k+1,) of a dst-partition-major stream."""
    return np.searchsorted(dstp, np.arange(k + 1)).astype(np.int64)


def patch_pdpr_plan(plan: GraphPlan, g_new: Graph,
                    delta: GraphDelta) -> GraphPlan:
    """The pull stream is dst-sorted, hence partition-major: splice
    per-dirty re-sorted segments, then re-derive the blocked gather
    schedule (sort-free O(M))."""
    from ..core.backends import pdpr_schedule
    psz = plan.part_size
    k = plan.partitioning.num_partitions
    n = plan.num_nodes
    dirty = delta.dirty_partitions(psz)
    offsets = _partition_bounds(plan.csc_dst.astype(np.int64) // psz, k)
    e_counts = np.diff(offsets)
    idx = gather_ranges(offsets[dirty], e_counts[dirty])
    src2, dst2 = _dirty_edges(delta, plan.csc_src[idx],
                              plan.csc_dst[idx], n)
    order = np.lexsort((src2, dst2))     # dst-major, matches the build
    src_d, dst_d = src2[order], dst2[order]
    e_cnt_d = np.bincount(
        np.searchsorted(dirty, dst_d.astype(np.int64) // psz),
        minlength=len(dirty)).astype(np.int64)
    new_src, _, _ = _splice(plan.csc_src, offsets, dirty, src_d, e_cnt_d)
    new_dst, _, _ = _splice(plan.csc_dst, offsets, dirty, dst_d, e_cnt_d)
    return GraphPlan(csc_src=new_src, csc_dst=new_dst,
                     schedule=pdpr_schedule(
                         new_src, new_dst, num_nodes=n,
                         block=plan.config.gather_block),
                     **_patched_fields(plan, g_new, len(new_src)))


def patch_bvgas_plan(plan: GraphPlan, g_new: Graph,
                     delta: GraphDelta) -> GraphPlan:
    """BVGAS streams are (dstp, src, dst)-sorted — partition-major by
    construction.  The gather permutation (bins position per dst-
    sorted edge) is itself partition-segmented, so clean partitions
    keep their permutation entries up to a scalar base shift and only
    dirty partitions re-sort."""
    from ..core.png import GatherSchedule, flat_gather_schedule
    psz = plan.part_size
    k = plan.partitioning.num_partitions
    n = plan.num_nodes
    dirty = delta.dirty_partitions(psz)
    offsets = _partition_bounds(plan.bv_dst.astype(np.int64) // psz, k)
    e_counts = np.diff(offsets)
    idx = gather_ranges(offsets[dirty], e_counts[dirty])
    src2, dst2 = _dirty_edges(delta, plan.bv_src[idx],
                              plan.bv_dst[idx], n)
    dstp2 = dst2.astype(np.int64) // psz
    order = np.lexsort((dst2, src2, dstp2))
    src_d, dst_d = src2[order], dst2[order]
    e_cnt_d = np.bincount(np.searchsorted(dirty, dstp2[order]),
                          minlength=len(dirty)).astype(np.int64)
    new_src, new_offsets, _ = _splice(plan.bv_src, offsets, dirty,
                                      src_d, e_cnt_d)
    new_dst, _, _ = _splice(plan.bv_dst, offsets, dirty, dst_d, e_cnt_d)

    # gather permutation: recover the old one from the schedule (its
    # un-padded prefix), rebase clean segments, re-sort dirty ones
    old_perm = plan.schedule.edge_update_idx_padded[:plan.num_edges]
    perm_local_d = np.argsort(dst_d, kind="stable").astype(np.int64)
    # positions within the dirty concatenation -> global bins positions
    dirty_eo = np.zeros(len(dirty) + 1, dtype=np.int64)
    np.cumsum(e_cnt_d, out=dirty_eo[1:])
    part_of = np.repeat(np.arange(len(dirty)), e_cnt_d)
    perm_d = (perm_local_d + new_offsets[dirty[part_of[perm_local_d]]]
              - dirty_eo[part_of[perm_local_d]]).astype(np.int64)
    new_perm, _, clean_pos = _splice(
        old_perm.astype(np.int64), offsets, dirty, perm_d, e_cnt_d)
    clean = np.ones(k, dtype=bool)
    clean[dirty] = False
    clean_idx = np.flatnonzero(clean)
    if len(clean_pos):
        new_perm[clean_pos] = new_perm[clean_pos] + np.repeat(
            new_offsets[clean_idx] - offsets[clean_idx],
            e_counts[clean_idx])
    new_perm = new_perm.astype(np.int32)
    eui, starts, ends, pdst = flat_gather_schedule(
        new_perm, new_dst[new_perm], num_nodes=n,
        block=plan.config.gather_block)
    sched = GatherSchedule(plan.config.gather_block, len(new_dst), eui,
                           starts, ends, pdst)
    return GraphPlan(bv_src=new_src, bv_dst=new_dst, schedule=sched,
                     **_patched_fields(plan, g_new, len(new_src)))


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------
def patch_plan(plan: GraphPlan, delta: GraphDelta, g_new: Graph, *,
               dirty_threshold: float = DIRTY_THRESHOLD) -> GraphPlan:
    """Produce (and cache) the plan for ``g_new = g_old + delta`` from
    ``plan``.

    Dispatch: cache hit on the new graph's fingerprint wins; then the
    backend's registered incremental patcher, unless the delta dirties
    more than ``dirty_threshold`` of the partitions (or the backend has
    none), in which case a full rebuild runs — either way the result
    carries ``parent_fp = plan.graph_fp`` so the version chain is
    evictable as a unit, and is installed in the process plan cache.
    """
    if delta.is_empty:
        return plan
    backend = get_backend(plan.method)
    cfg = plan.config
    fp_new = graph_fingerprint(g_new)
    if plan.graph_fp is not None:
        from .delta import shifted_fingerprint
        expected = shifted_fingerprint(plan.graph_fp, delta)
        if fp_new != expected:
            raise ValueError(
                "patch_plan: g_new is not g_old + delta (content "
                f"fingerprint {fp_new[:20]}… != expected "
                f"{expected[:20]}…) — a plan patched against it would "
                "silently serve wrong preprocessing")
    cached = plan_mod.peek_plan(fp_new, cfg)
    if cached is not None:
        return cached
    k = plan.partitioning.num_partitions
    dirty_frac = len(delta.dirty_partitions(plan.part_size)) / max(k, 1)
    # reordered plans always rebuild: the ordering itself is a function
    # of the graph, and the delta's dirty partitions are original-space
    # ids while the plan's layouts live in relabeled space — a splice
    # would patch the wrong partitions.  build_plan recomputes the
    # permutation for g_new; the parent_fp chain is preserved.
    rebuilt = (backend.patch_plan is None or cfg.reorder != "none"
               or dirty_frac > dirty_threshold)
    if rebuilt:
        from ..core.plan import build_plan
        new_plan = dataclasses.replace(build_plan(g_new, cfg),
                                       parent_fp=plan.graph_fp)
    else:
        plan_mod.plan_cache_stats().plan_patches += 1
        new_plan = backend.patch_plan(plan, g_new, delta)
    # the JAX package notifies its plan observers here ("plan_patch");
    # they come with the observability slice (A9)
    return install_plan(g_new, new_plan)
