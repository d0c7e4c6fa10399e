"""Port vs reference: streaming edge deltas on CPU tensors.

``stream.delta`` (``GraphDelta``, ``apply_delta``, the incremental
fingerprint, ``DynamicGraph``), ``stream.patch`` (every backend's
patcher and the ``patch_plan`` front door), ``stream.incremental``
(``seed_residual``, ``update_ranks``), ``reliability.guardrails``,
``Session.apply_delta``/``pagerank(warm=True)`` and
``SlotScheduler.apply_delta``, each against the JAX package's
counterpart (loaded through ``load_reference_stream``, which compiles
its ``stream/delta.py`` with the dataclass defaults rewritten) and
against exact oracles: host arrays ``np.array_equal``, ranks within 1e-6
L∞, sweep counts equal. A patched plan is held against a fresh build
made through ``build_png``/``block_png``/``pdpr_schedule`` and the
backends' own build functions called directly: ``build_plan`` would get
the patched PNG back from the shared PNG cache that ``install_plan``
seeds, which is why the reference's own exactness test never compares
the PNG splice for pcpm and pcpm_pallas with a real build.

``pcpm_sharded`` (its full-rebuild fallback) comes with the sharded-path
slice (A10), and its cases with it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import backends
from repro_torch.core import plan as plan_mod
from repro_torch.core.pagerank import pagerank, pagerank_reference
from repro_torch.core.partition import Partitioning
from repro_torch.core.plan import (PlanConfig, build_plan, clear_plan_cache,
                                   evict_plans, graph_fingerprint)
from repro_torch.core.png import (block_png, build_gather_schedule,
                                  build_png)
from repro_torch.core.spmv import SpMVEngine
from repro_torch.graphs import generators
from repro_torch.graphs.formats import Graph
from repro_torch.kernels.pcpm_spmv import tile_schedule
from repro_torch.reliability import ResilienceConfig, check_plan_integrity
from repro_torch.serve import PushQueryEngine, SlotScheduler
from repro_torch.stream import (DynamicGraph, GraphDelta, apply_delta,
                                patch_plan, seed_residual, update_ranks)
from repro_torch.stream import delta as delta_mod
from repro_torch.stream import patch as patch_mod

from test_torch_reference import load_reference

ref_delta = load_reference("stream.delta")
ref_patch = load_reference("stream.patch")
ref_inc = load_reference("stream.incremental")
ref_gen = load_reference("graphs.generators")
ref_plan = load_reference("core.plan")
ref_backends = load_reference("core.backends")
ref_guard = load_reference("reliability.guardrails")
ref_api = load_reference("api")

PART = 128
PATCHABLE = ("pcpm", "pcpm_pallas", "pdpr", "bvgas")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_plan_cache()
    ref_plan.clear_plan_cache()
    yield
    clear_plan_cache()
    ref_plan.clear_plan_cache()


def _graphs(scale=10, ef=8, seed=3):
    g, r = (generators.rmat(scale, ef, seed=seed),
            ref_gen.rmat(scale, ef, seed=seed))
    assert np.array_equal(g.src, r.src) and np.array_equal(g.dst, r.dst)
    return g, r


def _random_edges(g, rng, *, n_add=40, n_rem=40, dst_parts=None):
    """(add, remove) edge arrays; ``dst_parts`` restricts destinations to
    the given partitions (a localized delta, the dirty-partition
    regime). The reference test's generator."""
    n, m = g.num_nodes, g.num_edges
    if dst_parts is None:
        rem_pool = np.arange(m)
        add_dst = rng.integers(0, n, size=n_add)
    else:
        rem_pool = np.flatnonzero(np.isin(g.dst // PART, dst_parts))
        p = rng.choice(dst_parts, size=n_add)
        add_dst = (p * PART + rng.integers(0, PART, size=n_add)).clip(
            0, n - 1)
    ridx = rng.choice(rem_pool, size=min(n_rem, len(rem_pool)),
                      replace=False)
    add = np.stack([rng.integers(0, n, size=n_add), add_dst],
                   axis=1).astype(np.int32)
    rem = np.stack([g.src[ridx], g.dst[ridx]], axis=1)
    return add, rem


def _dangling_edges(g):
    """Remove EVERY out-edge of a well-connected node (a new dangling
    node) and insert edges out of a previously dangling one."""
    deg = g.out_degree
    victim = int(np.argmax((deg > 0) & (deg < 8)))
    mask = g.src == victim
    rem = np.stack([g.src[mask], g.dst[mask]], axis=1)
    dangling = np.flatnonzero(deg == 0)
    add = np.empty((0, 2), dtype=np.int32)
    if len(dangling):
        u = int(dangling[0])
        add = np.array([[u, (u + 1) % g.num_nodes],
                        [u, (u + 7) % g.num_nodes]], dtype=np.int32)
    return add, rem


def _both(add, rem):
    return (GraphDelta.of(add=add, remove=rem),
            ref_delta.GraphDelta.of(add=add, remove=rem))


def _raises_same(port_call, ref_call, exc=ValueError):
    with pytest.raises(exc) as ours:
        port_call()
    with pytest.raises(exc) as theirs:
        ref_call()
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


def _fresh_plan(g, method):
    """The plan of ``g`` built without any cache: the PNG through
    ``build_png``/``block_png``/``build_gather_schedule``, pdpr and
    bvgas through their backends' build functions."""
    cfg = backends.normalize_config(PlanConfig(method=method,
                                               part_size=PART))
    if method in ("pdpr", "bvgas"):
        build = {"pdpr": backends._build_pdpr,
                 "bvgas": backends._build_bvgas}[method]
        return build(g, cfg)
    png = build_png(g, Partitioning(g.num_nodes, PART))
    if method == "pcpm":
        return plan_mod.GraphPlan(
            png=png, schedule=build_gather_schedule(
                png, block=cfg.gather_block), **backends._plan_fields(g, cfg))
    return plan_mod.GraphPlan(png=png, blocked=block_png(png),
                              **backends._plan_fields(g, cfg))


def _assert_plans_equal(a, b, what):
    """Every host array of two plans (port or reference) equal."""
    for field in ("csc_src", "csc_dst", "bv_src", "bv_dst"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), (what, field)
        if x is not None:
            assert np.array_equal(x, y), (what, field)
    for part, fields in (("png", ("update_src", "update_offsets",
                                  "edge_update_idx", "edge_dst",
                                  "edge_offsets")),
                         ("schedule", ("edge_update_idx_padded",
                                       "piece_start", "piece_end",
                                       "piece_dst")),
                         ("blocked", ("update_src", "edge_update_local",
                                      "edge_dst_local"))):
        x, y = getattr(a, part), getattr(b, part)
        assert (x is None) == (y is None), (what, part)
        for f in fields if x is not None else ():
            assert np.array_equal(getattr(x, f), getattr(y, f)), (
                what, part, f)
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)


def _assert_tile_schedules_equal(a, b):
    s, t = (tile_schedule(p.blocked, device="cpu") for p in (a, b))
    assert (s.tile, s.part_size, s.num_partitions) == (
        t.tile, t.part_size, t.num_partitions)
    for f in ("edge_upd", "edge_dst", "chunks", "block_chunks", "hubs"):
        assert torch.equal(getattr(s, f), getattr(t, f)), f


# ---------------------------------------------------------------------------
# Delta semantics
# ---------------------------------------------------------------------------
def test_apply_delta_multiset_and_errors():
    src = np.array([0, 0, 1, 2], np.int32)
    dst = np.array([1, 1, 2, 3], np.int32)
    g = Graph(4, src, dst)
    r = ref_delta.Graph(4, src, dst)
    # removing one copy of a multi-edge keeps the other
    g2 = apply_delta(g, GraphDelta.remove([[0, 1]]))
    assert g2.num_edges == 3
    assert ((g2.src == 0) & (g2.dst == 1)).sum() == 1
    # every failure raises the reference's error, word for word
    msg = _raises_same(
        lambda: apply_delta(g, GraphDelta.remove([[3, 0]])),
        lambda: ref_delta.apply_delta(r, ref_delta.GraphDelta.remove(
            [[3, 0]])))
    assert msg.startswith("cannot remove")
    _raises_same(
        lambda: apply_delta(g, GraphDelta.remove([[0, 1]] * 3)),
        lambda: ref_delta.apply_delta(r, ref_delta.GraphDelta.remove(
            [[0, 1]] * 3)))
    msg = _raises_same(
        lambda: apply_delta(g, GraphDelta.insert([[0, 4]])),
        lambda: ref_delta.apply_delta(r, ref_delta.GraphDelta.insert(
            [[0, 4]])))
    assert "out of range" in msg
    _raises_same(lambda: GraphDelta.insert(np.ones((2, 2))),
                 lambda: ref_delta.GraphDelta.insert(np.ones((2, 2))))
    _raises_same(lambda: GraphDelta.insert(np.ones((2, 3), np.int32)),
                 lambda: ref_delta.GraphDelta.insert(
                     np.ones((2, 3), np.int32)))
    # an empty delta is a no-op; the defaults are empty int32 arrays
    g3 = apply_delta(g, GraphDelta.of())
    assert np.array_equal(g3.src, g.src)
    empty = GraphDelta()
    assert empty.is_empty and empty.add_src.dtype == np.int32


def test_delta_views_match_reference():
    rng = np.random.default_rng(2)
    g, r = _graphs()
    add, rem = _random_edges(g, rng, dst_parts=np.array([1, 4]))
    add2, rem2 = _random_edges(g, rng, n_add=7, n_rem=3)
    (d1, e1), (d2, e2) = _both(add, rem), _both(add2, rem2)
    for ours, theirs in ((d1 + d2, e1 + e2), (d1, e1)):
        for f in ("add_src", "add_dst", "rem_src", "rem_dst"):
            assert np.array_equal(getattr(ours, f), getattr(theirs, f))
            assert getattr(ours, f).dtype == getattr(theirs, f).dtype
        assert np.array_equal(ours.touched_sources(),
                              theirs.touched_sources())
        assert np.array_equal(ours.dirty_partitions(PART),
                              theirs.dirty_partitions(PART))
        assert (ours.size, ours.num_added, ours.num_removed) == (
            theirs.size, theirs.num_added, theirs.num_removed)
    assert set(d1.dirty_partitions(PART)) <= {1, 4}
    keep = delta_mod.multiset_keep_mask(g.src, g.dst, d1.rem_src,
                                        d1.rem_dst, num_nodes=g.num_nodes)
    assert np.array_equal(keep, ref_delta.multiset_keep_mask(
        r.src, r.dst, e1.rem_src, e1.rem_dst, num_nodes=r.num_nodes))
    # heavy multi-edges: which copies go must be the reference's too
    src = rng.integers(0, 6, 500).astype(np.int32)
    dst = rng.integers(0, 6, 500).astype(np.int32)
    pick = rng.choice(500, 120, replace=False)
    keep = delta_mod.multiset_keep_mask(src, dst, src[pick], dst[pick],
                                        num_nodes=6)
    assert keep.sum() == 380 and np.array_equal(
        keep, ref_delta.multiset_keep_mask(src, dst, src[pick], dst[pick],
                                           num_nodes=6))
    counts = np.array([3, 0, 2, 5])
    starts = np.array([10, 4, 0, 7])
    assert np.array_equal(delta_mod.gather_ranges(starts, counts),
                          ref_delta.gather_ranges(starts, counts))


def test_apply_delta_and_fingerprint_match_reference():
    rng = np.random.default_rng(0)
    g, r = _graphs()
    graph_fingerprint(g)
    ref_plan.graph_fingerprint(r)
    d, e = _both(*_random_edges(g, rng))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    assert np.array_equal(g2.src, r2.src) and np.array_equal(g2.dst, r2.dst)
    assert g2.__dict__["_fp_parts"] == r2.__dict__["_fp_parts"]
    assert graph_fingerprint(g2) == ref_plan.graph_fingerprint(r2)
    assert delta_mod.shifted_fingerprint(graph_fingerprint(g), d) == \
        ref_delta.shifted_fingerprint(ref_plan.graph_fingerprint(r), e)


def test_incremental_fingerprint_matches_fresh(monkeypatch):
    rng = np.random.default_rng(0)
    g, _ = _graphs()
    graph_fingerprint(g)                       # memoize hash parts
    delta = GraphDelta.of(*_random_edges(g, rng))
    hashed = []
    real_hash = plan_mod._edge_hash64

    def counted(src, dst):
        hashed.append(len(src))
        return real_hash(src, dst)

    # the stream derives the new graph's parts from the old ones: no
    # hash over the full edge list, in apply_delta or after it
    monkeypatch.setattr(delta_mod, "_edge_hash64", counted)
    monkeypatch.setattr(plan_mod, "_edge_hash64", counted)
    g2 = apply_delta(g, delta)
    fp2 = graph_fingerprint(g2)
    assert hashed and max(hashed) <= delta.size, hashed
    hashed.clear()
    fresh = Graph(g2.num_nodes, g2.src.copy(), g2.dst.copy())
    assert fp2 == graph_fingerprint(fresh)
    assert hashed == [g2.num_edges]            # a fresh graph hashes once
    assert fp2 != graph_fingerprint(g)
    perm = rng.permutation(g2.num_edges)
    shuf = Graph(g2.num_nodes, g2.src[perm], g2.dst[perm])
    assert graph_fingerprint(shuf) == fp2


def test_dynamic_graph_tracks_dirtiness():
    rng = np.random.default_rng(1)
    g, r = _graphs()
    dyn, rdyn = DynamicGraph(g), ref_delta.DynamicGraph(r)
    d1, e1 = _both(*_random_edges(g, rng, dst_parts=np.array([1, 2])))
    dyn.apply(d1)
    rdyn.apply(e1)
    assert set(dyn.dirty_partitions(PART)) <= {1, 2}
    assert dyn.version == 1 and dyn.base_graph is g
    d2, e2 = _both(*_random_edges(dyn.graph, rng, dst_parts=np.array([5])))
    dyn.apply(d2)
    rdyn.apply(e2)
    assert set(dyn.dirty_partitions(PART)) <= {1, 2, 5}
    assert np.array_equal(dyn.dirty_partitions(PART),
                          rdyn.dirty_partitions(PART))
    assert np.array_equal(dyn.touched_sources(), rdyn.touched_sources())
    assert dyn.dirty_fraction(PART, 8) == rdyn.dirty_fraction(PART, 8)
    assert np.array_equal(dyn.graph.src, rdyn.graph.src)
    assert len(dyn.touched_sources()) > 0
    dyn.mark_clean()
    assert dyn.dirty_partitions(PART).size == 0
    assert dyn.base_graph is dyn.graph


# ---------------------------------------------------------------------------
# Patch exactness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", PATCHABLE)
@pytest.mark.parametrize("localized", [True, False])
def test_patch_matches_fresh_build_and_reference(method, localized):
    rng = np.random.default_rng(7)
    g, r = _graphs()
    plan = build_plan(g, PlanConfig(method=method, part_size=PART))
    rplan = ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                       part_size=PART))
    dst_parts = np.array([0, 3]) if localized else None
    d, e = _both(*_random_edges(g, rng, dst_parts=dst_parts))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    patched = patch_plan(plan, d, g2)
    ref_patched = ref_patch.patch_plan(rplan, e, r2)
    assert patched.num_edges == g2.num_edges
    assert patched.graph_fp == graph_fingerprint(g2) == ref_patched.graph_fp
    assert patched.parent_fp == graph_fingerprint(g)
    # the splice path for a localized delta, the rebuild past the
    # threshold for one spread over all partitions, as the reference
    stats = repro_torch.plan_cache_stats()
    assert stats.plan_patches == int(localized)
    assert stats.plan_patches == ref_plan.plan_cache_stats().plan_patches
    _assert_plans_equal(patched, _fresh_plan(g2, method), (method, "fresh"))
    _assert_plans_equal(patched, ref_patched, (method, "reference"))
    if method == "pcpm_pallas":
        _assert_tile_schedules_equal(patched, _fresh_plan(g2, method))
    assert patched._device == {}           # uploads made on first use


@pytest.mark.parametrize("method", PATCHABLE)
def test_patch_dangling_and_chain(method):
    """Chained deltas (with a dangling-node creation) stay exact."""
    rng = np.random.default_rng(11)
    g, r = _graphs()
    plan = build_plan(g, PlanConfig(method=method, part_size=PART))
    rplan = ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                       part_size=PART))
    cur, rcur = g, r
    for i in range(3):
        edges = (_dangling_edges(cur) if i == 1 else
                 _random_edges(cur, rng, dst_parts=np.array([i, i + 4])))
        d, e = _both(*edges)
        cur, rcur = apply_delta(cur, d), ref_delta.apply_delta(rcur, e)
        plan = patch_plan(plan, d, cur)
        rplan = ref_patch.patch_plan(rplan, e, rcur)
    assert repro_torch.plan_cache_stats().plan_patches == 3
    _assert_plans_equal(plan, _fresh_plan(cur, method), (method, "fresh"))
    _assert_plans_equal(plan, rplan, (method, "reference"))
    if method == "pcpm_pallas":
        _assert_tile_schedules_equal(plan, _fresh_plan(cur, method))


def test_patched_plan_spmv_agrees():
    rng = np.random.default_rng(23)
    g, _ = _graphs()
    d = GraphDelta.of(*_random_edges(g, rng, dst_parts=np.array([2])))
    g2 = apply_delta(g, d)
    # multiples of 1/64: every summation order gives the same bits
    x = (rng.integers(0, 64, g.num_nodes) / 64).astype(np.float32)
    want = np.zeros(g.num_nodes)
    np.add.at(want, g2.dst, x[g2.src].astype(np.float64))
    for method in PATCHABLE:
        plan = build_plan(g, PlanConfig(method=method, part_size=PART))
        patched = patch_plan(plan, d, g2)
        y = SpMVEngine(g2, plan=patched, **CPU)(torch.from_numpy(x))
        assert np.array_equal(y.numpy(), want.astype(np.float32)), method


def test_png_shared_across_patched_pcpm_and_pallas():
    rng = np.random.default_rng(29)
    g, _ = _graphs()
    p1 = build_plan(g, PlanConfig(method="pcpm", part_size=PART))
    p2 = build_plan(g, PlanConfig(method="pcpm_pallas", part_size=PART))
    assert p1.png is p2.png
    d = GraphDelta.of(*_random_edges(g, rng, dst_parts=np.array([1])))
    g2 = apply_delta(g, d)
    q1 = patch_plan(p1, d, g2)
    q2 = patch_plan(p2, d, g2)
    assert q1.png is q2.png        # one spliced PNG serves both


def test_patch_plan_front_door():
    rng = np.random.default_rng(3)
    g, r = _graphs()
    cfg = PlanConfig(method="pcpm", part_size=PART)
    plan = build_plan(g, cfg)
    rplan = ref_plan.build_plan(r, ref_plan.PlanConfig(method="pcpm",
                                                       part_size=PART))
    # an empty delta returns the same plan
    assert patch_plan(plan, GraphDelta.of(), g) is plan
    # a g_new that is not g_old + delta is refused, in the reference's
    # words
    (d, e), (d_other, e_other) = (
        _both(*_random_edges(g, rng, dst_parts=np.array([0]))),
        _both(*_random_edges(g, rng, dst_parts=np.array([0]))))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    msg = _raises_same(lambda: patch_plan(plan, d_other, g2),
                       lambda: ref_patch.patch_plan(rplan, e_other, r2))
    assert "not g_old + delta" in msg
    # the result is installed: a second patch hits the plan cache
    new = patch_plan(plan, d, g2)
    assert plan_mod.peek_plan(graph_fingerprint(g2), cfg) is new
    assert patch_plan(plan, d, g2) is new
    assert repro_torch.plan_cache_stats().plan_patches == 1
    assert build_plan(g2, cfg) is new
    # past the dirtiness threshold: a full rebuild, chained all the same
    builds = repro_torch.plan_cache_stats().plan_builds
    d3 = GraphDelta.of(*_random_edges(g, rng, dst_parts=np.array([1, 2])))
    g3 = apply_delta(g, d3)
    rebuilt = patch_plan(plan, d3, g3, dirty_threshold=0.2)
    assert repro_torch.plan_cache_stats().plan_patches == 1
    assert repro_torch.plan_cache_stats().plan_builds == builds + 1
    assert rebuilt.parent_fp == graph_fingerprint(g)
    _assert_plans_equal(rebuilt, _fresh_plan(g3, "pcpm"), "rebuilt")
    # a reordered plan always rebuilds (its layouts live in relabeled
    # space), keeps the chain, and carries the new graph's ordering
    oplan = build_plan(g, cfg.replace(reorder="degree"))
    onew = patch_plan(oplan, d, g2)
    assert repro_torch.plan_cache_stats().plan_patches == 1
    assert onew.parent_fp == graph_fingerprint(g)
    assert onew.reorder_perm is not None
    assert np.array_equal(onew.reorder_perm, ref_plan.build_plan(
        r2, ref_plan.PlanConfig(method="pcpm", part_size=PART,
                                reorder="degree")).reorder_perm)


def test_patch_stream_stays_bounded_and_chain_evicts():
    rng = np.random.default_rng(19)
    g, _ = _graphs()
    cfg = PlanConfig(method="pcpm", part_size=PART)
    plan = build_plan(g, cfg)
    graphs = [g]
    for i in range(6):
        d = GraphDelta.of(*_random_edges(graphs[-1], rng,
                                         dst_parts=np.array([i % 4])))
        g2 = apply_delta(graphs[-1], d)
        plan = patch_plan(plan, d, g2)
        graphs.append(g2)
        assert len(plan_mod._PLAN_CACHE) <= plan_mod.MAX_CACHED_PLANS
    assert len(plan_mod._PLAN_CACHE) == 7      # the whole version chain
    # ... and evicting ANY version releases the entire chain
    evicted = evict_plans(graphs[3])
    assert len(plan_mod._PLAN_CACHE) == 0 and len(plan_mod._PNG_CACHE) == 0
    assert evicted >= 7


def test_patch_stream_respects_lru_cap(monkeypatch):
    rng = np.random.default_rng(31)
    monkeypatch.setattr(plan_mod, "MAX_CACHED_PLANS", 4)
    monkeypatch.setattr(plan_mod, "MAX_CACHED_PNGS", 4)
    g, _ = _graphs()
    plan = build_plan(g, PlanConfig(method="pcpm", part_size=PART))
    cur = g
    for i in range(10):
        d = GraphDelta.of(*_random_edges(cur, rng,
                                         dst_parts=np.array([i % 4])))
        nxt = apply_delta(cur, d)
        plan = patch_plan(plan, d, nxt)
        cur = nxt
        assert len(plan_mod._PLAN_CACHE) <= 4
        assert len(plan_mod._PNG_CACHE) <= 4


def test_supports_incremental_flags():
    for method in PATCHABLE:
        assert backends.get_backend(method).supports_incremental
        assert ref_backends.get_backend(method).supports_incremental
    assert patch_mod.DIRTY_THRESHOLD == ref_patch.DIRTY_THRESHOLD


# ---------------------------------------------------------------------------
# Residual seed and warm updates
# ---------------------------------------------------------------------------
def _combined(g, rng):
    """A random delta with a dangling-node creation folded in."""
    add, rem = _random_edges(g, rng, n_add=30, n_rem=30)
    add2, rem2 = _dangling_edges(g)
    return np.concatenate([add, add2]), np.concatenate([rem, rem2])


@pytest.mark.parametrize("dangling", ["none", "redistribute"])
def test_seed_residual_matches_reference(dangling):
    rng = np.random.default_rng(13)
    g, r = _graphs(scale=11)
    d, e = _both(*_combined(g, rng))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    prev = rng.random(g.num_nodes).astype(np.float32)
    prev /= prev.sum()
    ours = seed_residual(g, g2, d, prev, damping=0.85, dangling=dangling)
    theirs = ref_inc.seed_residual(r, r2, e, prev, damping=0.85,
                                   dangling=dangling)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)
    # a concatenation of two batches seeds like the reference's too
    d2, e2 = _both(*_random_edges(g2, rng, dst_parts=np.array([3])))
    g3, r3 = apply_delta(g2, d2), ref_delta.apply_delta(r2, e2)
    assert np.array_equal(
        seed_residual(g, g3, d + d2, prev, dangling=dangling),
        ref_inc.seed_residual(r, r3, e + e2, prev, dangling=dangling))
    _raises_same(lambda: seed_residual(g, g2, d, prev, dangling="x"),
                 lambda: ref_inc.seed_residual(r, r2, e, prev,
                                               dangling="x"))


def _prior(g, method, dangling, **kw):
    """Converged float32 ranks of ``g`` from the port's cold solve."""
    plan = build_plan(g, PlanConfig(method=method, part_size=PART))
    res = pagerank(g, engine=SpMVEngine(g, plan=plan, **CPU),
                   num_iterations=400, tol=1e-10, dangling=dangling, **kw)
    return plan, res.ranks.numpy()


@pytest.mark.parametrize("method,dangling", [
    ("pcpm", "none"), ("pcpm", "redistribute"), ("pdpr", "none"),
    ("pcpm_pallas", "none")])
def test_update_ranks_matches_reference_and_cold(method, dangling):
    """The push path: the same sweeps as the reference and its ranks
    within 1e-6, and within 1e-6 of a cold solve on the new graph."""
    rng = np.random.default_rng(13)
    scale = 10 if method == "pcpm_pallas" else 11
    g, r = _graphs(scale=scale)
    plan, prev = _prior(g, method, dangling)
    prev_before = prev.copy()
    d, e = _both(*_combined(g, rng))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    patched = patch_plan(plan, d, g2)
    rpatched = ref_patch.patch_plan(
        ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                   part_size=PART)), e, r2)
    warm = update_ranks(patched, d, prev, g_old=g, g_new=g2,
                        dangling=dangling, tol=1e-9, **CPU)
    ref = ref_inc.update_ranks(rpatched, e, prev, g_old=r, g_new=r2,
                               dangling=dangling, tol=1e-9)
    assert 0 < warm.iterations == ref.iterations < 200
    ranks = warm.ranks.numpy()
    assert np.abs(ranks - np.asarray(ref.ranks)).max() <= 1e-6
    # the residual norms agree to the float32 rounding of the first
    # sweep's vector, which the later sweeps carry (mixed signs)
    np.testing.assert_allclose(warm.residuals, ref.residuals, rtol=1e-4,
                               atol=1e-6 * warm.residuals[0])
    cold = pagerank(g2, engine=SpMVEngine(g2, plan=patched, **CPU),
                    num_iterations=400, tol=1e-10, dangling=dangling)
    assert np.abs(ranks - cold.ranks.numpy()).max() <= 1e-6
    want = pagerank_reference(g2, num_iterations=300, dangling=dangling)
    assert np.abs(ranks - want).max() <= 1e-5
    if dangling == "redistribute":
        assert abs(float(ranks.sum()) - 1.0) < 1e-4    # mass conserved
    assert np.array_equal(prev, prev_before)    # the caller's array kept


def test_update_ranks_dense_fallback_and_shortcut():
    rng = np.random.default_rng(17)
    g, r = _graphs()
    n, m = g.num_nodes, g.num_edges
    plan, prev = _prior(g, "pcpm", "none")
    # rewire a third of the edges: a seed past DENSE_FALLBACK_L1
    k = m // 3
    ridx = rng.choice(m, size=k, replace=False)
    add = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)],
                   axis=1).astype(np.int32)
    d, e = _both(add, np.stack([g.src[ridx], g.dst[ridx]], axis=1))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    assert float(np.abs(seed_residual(g, g2, d, prev)).sum()) > \
        ref_inc.DENSE_FALLBACK_L1
    patched = patch_plan(plan, d, g2)
    warm = update_ranks(patched, d, prev, g_old=g, g_new=g2, tol=1e-9,
                        max_push=400, **CPU)
    ref = ref_inc.update_ranks(
        ref_patch.patch_plan(ref_plan.build_plan(
            r, ref_plan.PlanConfig(method="pcpm", part_size=PART)), e, r2),
        e, prev, g_old=r, g_new=r2, tol=1e-9, max_push=400)
    cold = pagerank(g2, engine=SpMVEngine(g2, plan=patched, **CPU),
                    num_iterations=400, tol=1e-10)
    assert warm.iterations == ref.iterations
    assert len(warm.residuals) == warm.iterations     # the fused loop's
    assert np.abs(warm.ranks.numpy() - np.asarray(ref.ranks)).max() <= 1e-6
    assert np.abs(warm.ranks.numpy() - cold.ranks.numpy()).max() <= 1e-6
    # an empty delta: zero sweeps, the ranks as they were
    res = update_ranks(plan, GraphDelta.of(), prev, g_old=g, g_new=g, **CPU)
    assert res.iterations == 0 and np.array_equal(res.ranks.numpy(), prev)
    # a seed already under tol: the first-order correction folded in
    d4, e4 = _both(*_random_edges(g, rng, n_add=1, n_rem=0))
    g4, r4 = apply_delta(g, d4), ref_delta.apply_delta(r, e4)
    p4 = patch_plan(plan, d4, g4)
    r0 = seed_residual(g, g4, d4, prev)
    tol = 2 * float(np.abs(r0, dtype=np.float64).sum())
    res = update_ranks(p4, d4, prev, g_old=g, g_new=g4, tol=tol, **CPU)
    ref = ref_inc.update_ranks(
        ref_patch.patch_plan(ref_plan.build_plan(
            r, ref_plan.PlanConfig(method="pcpm", part_size=PART)), e4, r4),
        e4, prev, g_old=r, g_new=r4, tol=tol)
    assert res.iterations == ref.iterations == 0
    assert res.residuals == ref.residuals
    assert np.array_equal(res.ranks.numpy(), np.asarray(ref.ranks))
    assert np.array_equal(res.ranks.numpy(), prev + r0)


# ---------------------------------------------------------------------------
# Session front door
# ---------------------------------------------------------------------------
def _two_deltas(g, r, rng):
    d1, e1 = _both(*_random_edges(g, rng, dst_parts=np.array([2, 9])))
    g1 = apply_delta(g, d1)
    d2, e2 = _both(*_random_edges(g1, rng, dst_parts=np.array([5])))
    return (d1, e1), (d2, e2)


@pytest.mark.parametrize("reorder", ["none", "hybrid"])
def test_session_apply_delta_warm_parity(reorder):
    rng = np.random.default_rng(41)
    g, r = _graphs(scale=11)
    sess = repro_torch.open(g, method="pcpm", part_size=PART,
                            reorder=reorder, **CPU)
    rsess = ref_api.open(r, ref_api.EngineConfig(method="pcpm",
                                                 part_size=PART,
                                                 reorder=reorder))
    # 1e-6 is the tightest tolerance the cold driver can verify in
    # float32; the warm gate requires the prior to have reached it
    for s in (sess, rsess):
        s.pagerank(num_iterations=400, tol=1e-6)
    if reorder != "none":
        # a pure re-solve: the stored ranks already satisfy tol
        again = sess.pagerank(warm=True, tol=1e-6, num_iterations=400)
        assert again.iterations == 0
        assert rsess.pagerank(warm=True, tol=1e-6,
                              num_iterations=400).iterations == 0
    (d1, e1), (d2, e2) = _two_deltas(g, r, rng)
    assert sess.apply_delta(d1) is sess
    sess.apply_delta(d2)          # two deltas accumulate
    rsess.apply_delta(e1)
    rsess.apply_delta(e2)
    assert repro_torch.plan_cache_stats().plan_patches == (
        2 if reorder == "none" else 0)
    assert np.array_equal(sess.graph.src, rsess.graph.src)
    warm = sess.pagerank(warm=True, tol=1e-6, num_iterations=400)
    rwarm = rsess.pagerank(warm=True, tol=1e-6, num_iterations=400)
    cold = pagerank(sess.graph, engine=sess.engine, num_iterations=400,
                    tol=1e-10)
    ranks = warm.ranks.numpy()
    assert 0 < warm.iterations == rwarm.iterations < 400
    assert np.abs(ranks - np.asarray(rwarm.ranks)).max() <= 1e-6
    assert np.abs(ranks - cold.ranks.numpy()).max() <= 1e-6
    ids, _ = sess.top_ranked(10)
    assert np.array_equal(ids, rsess.top_ranked(10)[0])


def test_session_warm_unconverged_or_unsolved_falls_back_cold():
    """The sparse seed is only exact over a CONVERGED prior: warm=True
    after a 20-iteration tol=0 run, with another damping, or with no
    solve at all is an honest cold solve."""
    rng = np.random.default_rng(47)
    g, r = _graphs(scale=11)
    sess = repro_torch.open(g, method="pcpm", part_size=PART,
                            num_iterations=30, **CPU)
    res = sess.pagerank(warm=True)         # no previous solve
    assert res.iterations == 30
    assert np.abs(res.ranks.numpy()
                  - pagerank_reference(g, num_iterations=30)).max() <= 1e-5
    sess.pagerank(num_iterations=20, tol=0.0)      # NOT converged
    sess.apply_delta(GraphDelta.of(*_random_edges(
        g, rng, dst_parts=np.array([1]))))
    warm = sess.pagerank(warm=True, tol=1e-8, num_iterations=400)
    cold = pagerank(sess.graph, engine=sess.engine, num_iterations=400,
                    tol=1e-10)
    assert warm.iterations > 40           # a cold run, not a push
    assert np.abs(warm.ranks.numpy() - cold.ranks.numpy()).max() <= 1e-6
    # converged at damping 0.85, asked at 0.9: cold
    other = sess.pagerank(warm=True, tol=1e-8, num_iterations=400,
                          damping=0.9)
    assert other.iterations > 40


def test_session_delta_releases_the_old_plans_device_uploads():
    rng = np.random.default_rng(5)
    g, _ = _graphs()
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=PART, **CPU)
    sess.pagerank(num_iterations=50, tol=1e-7)
    old_plan, old_engine = sess.plan, sess.engine
    held = old_engine.spmv_fn()             # a live consumer's closure
    assert len(old_plan._device) > 0
    d = GraphDelta.of(*_random_edges(g, rng, dst_parts=np.array([3])))
    sess.apply_delta(d)
    assert sess.plan is not old_plan and len(old_plan._device) == 0
    assert plan_mod.peek_plan(graph_fingerprint(g), old_plan.config) \
        is old_plan                          # host arrays still cached
    x = torch.from_numpy((rng.integers(0, 64, g.num_nodes) / 64)
                         .astype(np.float32))
    want = np.zeros(g.num_nodes, np.float32)
    np.add.at(want, g.dst, x.numpy()[g.src])
    assert np.array_equal(held(x).numpy(), want)      # still works
    assert len(old_plan._device) == 0
    sess.pagerank(warm=True, tol=1e-7, num_iterations=200)
    assert len(sess.plan._device) > 0


# ---------------------------------------------------------------------------
# Serving across a delta
# ---------------------------------------------------------------------------
def test_scheduler_apply_delta_keeps_inflight_queries():
    rng = np.random.default_rng(43)
    g, r = _graphs(scale=11)
    sess = repro_torch.open(g, method="pcpm", part_size=PART, **CPU)
    rsess = ref_api.open(r, ref_api.EngineConfig(method="pcpm",
                                                 part_size=PART))
    sch, rsch = (s.serve(slots=2, chunk=4) for s in (sess, rsess))
    old_plan = sch.engine.plan
    # tol 1e-6: the reference's test asks 1e-7, below the float32 floor
    # of the port's blocked gather on this graph (on the CPU its columns
    # do not reach 1e-7 in 500 iterations, with or without a delta)
    for s in (sch, rsch):
        s.submit(tol=1e-6, max_iters=500)                 # uniform
        s.submit(top_k=5, tol=1e-6, max_iters=500)        # top-k
        s.step()
        assert s.active_slots == 2
    d, e = _both(*_random_edges(g, rng, dst_parts=np.array([3])))
    g2, r2 = apply_delta(g, d), ref_delta.apply_delta(r, e)
    sch.apply_delta(d, g_new=g2)
    rsch.apply_delta(e, g_new=r2)
    assert len(old_plan._device) == 0        # the old uploads released
    out, rout = sch.run_until_drained(), rsch.run_until_drained()
    assert len(out) == len(rout) == 2
    # one stepper rebuild, no admit rebuild, the state carried over
    assert (sch.trace_count, sch.admit_trace_count, sch.rebind_count) == (
        rsch.trace_count, rsch.admit_trace_count, rsch.rebind_count) == (
        2, 1, 1)
    sch.metrics.reconcile()
    for ours, theirs in zip(out, rout):
        assert ours.iterations == theirs.iterations
        assert ours.converged and theirs.converged
    uni = [x for x in out if x.top_ids is None][0]
    runi = [x for x in rout if x.top_ids is None][0]
    assert np.abs(uni.ranks - np.asarray(runi.ranks)).max() <= 1e-6
    assert np.abs(uni.ranks - pagerank_reference(
        g2, num_iterations=300)).max() <= 1e-5
    top = [x for x in out if x.top_ids is not None][0]
    assert np.array_equal(top.top_ids, [x for x in rout
                                        if x.top_ids is not None][0].top_ids)
    # queries after the delta run on the same stepper
    sch.submit(tol=1e-6, max_iters=200)
    sch.run_until_drained()
    assert sch.trace_count == 2 and sch.admit_trace_count == 1


def test_scheduler_apply_delta_is_atomic_and_refreshes_push():
    rng = np.random.default_rng(53)
    g, r = _graphs()
    n = g.num_nodes
    sch = SlotScheduler(g, slots=2, chunk=4, method="pcpm", part_size=PART,
                        **CPU)
    plan, engine = sch.engine.plan, sch.engine
    d = GraphDelta.of(*_random_edges(g, rng, dst_parts=np.array([2])))
    # a seed whose out-edges the delta changes, so its answer moves
    seed = np.zeros(n, np.float32)
    seed[d.rem_src[0]] = 1.0
    before = sch._push_engine()
    # bad deltas: counted, re-raised, the old plan still serving
    bad = GraphDelta.insert([[0, n]])
    with pytest.raises(ValueError, match="out of range"):
        sch.apply_delta(bad)
    with pytest.raises(ValueError, match="cannot remove"):
        sch.apply_delta(GraphDelta.remove([[0, 0], [0, 0], [0, 0]]))
    # a patch that yields a corrupted plan fails its integrity check
    real_patch = patch_mod.patch_plan

    def corrupting(plan, delta, g_new, **kw):
        p = real_patch(plan, delta, g_new, **kw)
        eui = p.png.edge_update_idx.copy()
        eui[0] = p.png.num_updates + 5
        return dataclasses.replace(p, png=dataclasses.replace(
            p.png, edge_update_idx=eui))

    patch_mod.patch_plan = corrupting
    try:
        with pytest.raises(ValueError, match="plan integrity"):
            sch.apply_delta(d)
    finally:
        patch_mod.patch_plan = real_patch
    assert sch.metrics.counters["delta_failures"] == 3
    assert sch.engine is engine and sch.engine.plan is plan
    assert sch.g is g and sch.rebind_count == 0 and len(plan._device) > 0
    assert sch._push_engine() is before          # no generation bump
    uid = sch.submit(seed, top_k=10, tol=1e-6, max_iters=300)
    sch.run_until_drained()
    assert {x.uid: x for x in sch.completed}[uid].error is None
    uid_old = sch.submit(seed, top_k=10, tol=1e-4, route="push")
    # a good delta rebinds: push engines rebuilt on the new edges
    g2 = apply_delta(g, d)
    sch.apply_delta(d, g_new=g2)
    assert sch.rebind_count == 1 and sch._push_engine() is not before
    uid = sch.submit(seed, top_k=10, tol=1e-4, route="push")
    done = {x.uid: x for x in sch.completed}
    for graph, u in ((g, uid_old), (g2, uid)):
        want = PushQueryEngine(graph).query(
            seed, tol=1e-4, max_sweeps=sch.push_max_sweeps, top_k=10)
        # the host push's BLAS sums round by buffer alignment (a few
        # ulps of these scores)
        assert np.array_equal(done[u].top_ids, want.top_ids)
        np.testing.assert_allclose(done[u].top_scores, want.top_scores,
                                   rtol=0, atol=1e-8)
    assert not np.array_equal(done[uid].top_scores,
                              done[uid_old].top_scores)


def test_scheduler_apply_delta_refuses_reorder_as_the_reference():
    g, r = _graphs()
    d = GraphDelta.insert([[0, 1]])
    sess = repro_torch.open(g, method="pcpm", part_size=PART,
                            reorder="degree", **CPU)
    rsess = ref_api.open(r, ref_api.EngineConfig(method="pcpm",
                                                 part_size=PART,
                                                 reorder="degree"))
    _raises_same(lambda: sess.serve().apply_delta(d),
                 lambda: rsess.serve().apply_delta(
                     ref_delta.GraphDelta.insert([[0, 1]])))


# ---------------------------------------------------------------------------
# Plan integrity
# ---------------------------------------------------------------------------
def _corruptions(method):
    """(name, edit) pairs: each edit makes one index stream of a plan of
    ``method`` unsound (applied alike to the port's and the reference's
    plans, which hold equal arrays)."""
    def stream(field, idx, value):
        def edit(p):
            arr = getattr(p, field).copy()
            arr[idx] = value(p)
            return dataclasses.replace(p, **{field: arr})
        return edit

    def sub(part, field, idx, value):
        def edit(p):
            obj = getattr(p, part)
            arr = getattr(obj, field).copy()
            arr[idx] = value(p)
            return dataclasses.replace(p, **{part: dataclasses.replace(
                obj, **{field: arr})})
        return edit

    n = lambda p: p.num_nodes                                # noqa: E731
    out = []
    if method == "pdpr":
        out += [("csc_src", stream("csc_src", 0, n)),
                ("csc_dst", stream("csc_dst", -1, lambda p: -1))]
    if method == "bvgas":
        out += [("bv_src", stream("bv_src", 3, n))]
    if method in ("pdpr", "bvgas", "pcpm"):
        out += [("piece_end", sub("schedule", "piece_end", 0,
                                  lambda p: -1)),
                ("piece_dst", sub("schedule", "piece_dst", 1,
                                  lambda p: p.num_nodes + 1))]
    if method in ("pcpm", "pcpm_pallas"):
        out += [("edge_update_idx", sub("png", "edge_update_idx", 0,
                                        lambda p: p.png.num_updates)),
                ("update_offsets", sub("png", "update_offsets", 1,
                                       lambda p: -1))]
    if method == "pcpm_pallas":
        out += [("edge_dst_local", sub("blocked", "edge_dst_local", (0, 0),
                                       lambda p: p.blocked.part_size + 1)),
                ("update_src", sub("blocked", "update_src", (1, 0),
                                   lambda p: -2))]
    return out


@pytest.mark.parametrize("method", PATCHABLE)
def test_check_plan_integrity_matches_reference(method):
    g, r = _graphs(scale=8)
    plan = build_plan(g, PlanConfig(method=method, part_size=PART))
    rplan = ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                       part_size=PART))
    assert check_plan_integrity(plan) is plan
    ref_guard.check_plan_integrity(rplan)
    for name, edit in _corruptions(method):
        msg = _raises_same(lambda: check_plan_integrity(edit(plan)),
                           lambda: ref_guard.check_plan_integrity(
                               edit(rplan)))
        assert msg.startswith("plan integrity"), name
    assert repro_torch.check_plan_integrity is check_plan_integrity
    assert ResilienceConfig().verify_plans
