"""``pcpm_pallas`` on a graph relabeled hub-first (``reorder="degree"``),
on the CPU: the solve against the benchmark's plain reference in
float64 and against the same solve on the graph as labeled, the "tile"
gather order built from the PNG's own streams against the one built
from its blocked form, a d = 1 solve that builds no array padded to the
heaviest partition, ragged bins in the plain "tile" gather, the blocked
form derived where it is read (``blocked_of``), and the spans of the
relabeling.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import Partitioning, block_png, build_png
from repro_torch.core import plan as plan_mod
from repro_torch.core.backends import spmv_fn
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.reorder import degree_order
from repro_torch.kernels import pcpm_spmv as b1
from repro_torch.kernels.pcpm_spmv import (ops, pack_blocked,
                                           pcpm_gather_ref, tile_gather_cuda,
                                           tile_gather_ref, tile_schedule)

from test_torch_reference import dense_spmv

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench.gen import kron as bench_kron                     # noqa: E402
from bench.reference import pagerank as bench_reference      # noqa: E402

PART = 512
KRON = {"edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}


def _kron(seed, scale=10):
    """The benchmark's kron graph (``bench/gen/kron.py``), drawn on the
    CPU."""
    n, src, dst = bench_kron.make(dict(KRON, scale=scale), seed, "cpu")
    return Graph(n, src.numpy(), dst.numpy())


def _labeled(labels, seed=5, scale=10):
    g = _kron(seed, scale)
    return g if labels == "random" else g.relabel(degree_order(g))


def _session(g, reorder, **kw):
    return repro_torch.open(g, repro_torch.EngineConfig(
        method="pcpm_pallas", part_size=PART, reorder=reorder, **kw),
        device="cpu")


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_degree_ordered_solve_vs_the_benchmark_reference(seed):
    g = _kron(seed)
    ref = bench_reference.pagerank(torch.from_numpy(g.src),
                                   torch.from_numpy(g.dst), g.num_nodes,
                                   damping=0.85, iterations=20)
    ranks = {}
    for reorder in ("none", "degree"):
        res = _session(g, reorder).pagerank()
        assert res.iterations == 20
        ranks[reorder] = res.ranks.double()
        gap = (ranks[reorder] - ref).abs()
        assert float(gap.sum() / ref.sum()) <= 1e-6, reorder
        assert float(gap.max() / ref.max()) <= 1e-6, reorder
    gap = (ranks["degree"] - ranks["none"]).abs().max()
    assert float(gap / ranks["none"].max()) <= 1e-6


def test_degree_order_concentrates_the_arcs_and_raises_r():
    g = _kron(5)
    cfg = dict(method="pcpm_pallas", part_size=128)
    plain = plan_mod.build_plan(g, plan_mod.PlanConfig(**cfg))
    hubs = plan_mod.build_plan(g, plan_mod.PlanConfig(**cfg,
                                                      reorder="degree"))

    def first_share(p):
        return np.diff(p.png.edge_offsets)[0] / p.num_edges

    assert hubs.compression_ratio > 1.5 * plain.compression_ratio
    assert first_share(hubs) > 3 * first_share(plain)


def _blocked_schedule(blk, *, tile_bytes, blocks, device):
    """The gather order as the port built it from the blocked form: the
    real edges (update < U, destination < P) found by a scan of its
    padded (k, max_e) streams, partition after partition."""
    k, num_updates = blk.update_src.shape
    psz = blk.part_size
    tile = ops.tile_size(psz, tile_bytes)
    if blocks is None:
        blocks = ops.tile_blocks(torch.device(device), tile_bytes)
    eu, ed = blk.edge_update_local, blk.edge_dst_local
    part, pos = np.nonzero((eu < num_updates) & (ed < psz))
    shape = dict(k=k, psz=psz, num_updates=num_updates, tile=tile)
    key = ops.edge_keys(part, eu[part, pos], ed[part, pos], **shape)
    return ops.order_keys(key, **shape, blocks=blocks,
                          device=torch.device(device))


@pytest.mark.parametrize("labels", ["random", "degree"])
@pytest.mark.parametrize("part_size,tile_bytes,blocks", [
    (128, 1024, 3), (128, 64, 7), (512, ops.TILE_BYTES, None)])
def test_tile_schedule_from_the_png_equals_the_blocked_one(
        labels, part_size, tile_bytes, blocks):
    """Built from the PNG's streams, the gather order, chunks and hubs
    are those built from the blocked form, as the port built them before
    the blocked form was left off the d = 1 path."""
    g = _labeled(labels)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    kw = dict(tile_bytes=tile_bytes, blocks=blocks, device="cpu")
    a = tile_schedule(png, **kw)
    b = _blocked_schedule(block_png(png), **kw)
    assert (a.tile, a.part_size, a.num_partitions, a.blocks) == (
        b.tile, b.part_size, b.num_partitions, b.blocks)
    for f in ("edge_upd", "edge_dst", "chunks", "block_chunks", "hubs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _refuse(*args, **kw):
    raise AssertionError("an array padded to the heaviest partition was "
                         "built")


def test_a_hub_first_d1_solve_builds_no_padded_array(monkeypatch):
    plan_mod.clear_plan_cache()
    g = _kron(7)
    for mod, name in ((plan_mod, "block_png"), (b1, "pack_blocked"),
                      (ops, "pack_blocked")):
        monkeypatch.setattr(mod, name, _refuse)
    sess = _session(g, "degree")
    for _ in range(2):
        res = sess.pagerank()
    plan = sess.plan
    assert plan.blocked is None
    assert not [k for k in plan._device if k[0] == "packed"]
    oracle = repro_torch.core.pagerank_reference(g)
    assert np.abs(res.ranks.numpy() - oracle).max() <= 1e-6
    # a d > 1 SpMV packs the blocked form at its first call; the plan
    # keeps the packed streams, not the host form
    monkeypatch.undo()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (g.num_nodes, 3)).astype(np.float32))
    y = sess.spmv(x)
    assert plan.blocked is None
    assert [k for k in plan._device if k[0] == "packed"]
    want = dense_spmv(g.num_nodes, g.src, g.dst, x.numpy().astype(np.float64))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
    plan_mod.clear_plan_cache()


@pytest.mark.parametrize("labels", ["random", "degree"])
def test_ragged_bins_in_the_tile_gather_equal_padded_ones(labels):
    """The plain "tile" gather over a PNG's own (U,) updates with their
    offsets equals it over the (k, U, 1) padded bins, and the plain
    blocked gather, on sums exact in any order; so does the wrapper."""
    g = _labeled(labels, seed=9)
    png = build_png(g, Partitioning(g.num_nodes, 128))
    blk = block_png(png)
    packed = pack_blocked(blk, g.num_nodes, edge_block=16, device="cpu")
    s = tile_schedule(png, tile_bytes=64, blocks=5, device="cpu")
    x = torch.from_numpy((np.random.default_rng(1).integers(
        0, 16, g.num_nodes) / 16).astype(np.float32))
    k, u = packed.update_src.shape
    padded = x[packed.update_src.view(-1)].view(k, u, 1)
    ragged = x[torch.from_numpy(png.update_src).long()]
    offsets = torch.from_numpy(png.update_offsets.astype(np.int32))
    want = pcpm_gather_ref(padded, packed.edge_upd, packed.edge_dst,
                           part_size=128)
    assert torch.equal(tile_gather_ref(ragged, s, offsets), want)
    assert torch.equal(tile_gather_ref(ragged[:, None], s, offsets), want)
    assert torch.equal(tile_gather_cuda(ragged, offsets, s), want)
    y = ops.pcpm_spmv_tile(x, torch.from_numpy(png.update_src), offsets, s)
    assert y.shape == x.shape
    assert torch.equal(y, want.view(-1)[:g.num_nodes])


def test_ragged_tile_gather_rejects_what_it_cannot_take():
    g = _kron(9)
    png = build_png(g, Partitioning(g.num_nodes, 128))
    s = tile_schedule(png, device="cpu")
    bins = torch.ones(png.num_updates)
    offsets = torch.from_numpy(png.update_offsets.astype(np.int32))
    with pytest.raises(ValueError, match="update_offsets"):
        tile_gather_cuda(bins, offsets[:-1], s)
    with pytest.raises(ValueError, match="update_offsets"):
        tile_gather_cuda(bins, offsets.long(), s)
    with pytest.raises(ValueError, match="ragged bins"):
        tile_gather_cuda(torch.ones((png.num_updates, 2)), offsets, s)


def test_blocked_of_derives_the_blocked_form_and_keeps_none(tmp_path):
    """A pcpm_pallas plan holds no blocked form; ``blocked_of`` builds
    it from the PNG each time, and returns the one a plan file gave."""
    g = _kron(11)
    plan = plan_mod.build_plan(g, plan_mod.PlanConfig(method="pcpm_pallas",
                                                      part_size=128))
    assert plan.blocked is None
    blk = plan_mod.blocked_of(plan)
    want = block_png(plan.png)
    for f in ("update_src", "edge_update_local", "edge_dst_local"):
        assert np.array_equal(getattr(blk, f), getattr(want, f)), f
    assert plan.blocked is None
    plan.save(str(tmp_path / "plan.npz"))
    loaded = plan_mod.GraphPlan.load(str(tmp_path / "plan.npz"))
    assert plan_mod.blocked_of(loaded) is loaded.blocked is not None
    for f in ("update_src", "edge_update_local", "edge_dst_local"):
        assert np.array_equal(getattr(loaded.blocked, f),
                              getattr(want, f)), f
    assert plan_mod.blocked_of(plan_mod.build_plan(g, plan_mod.PlanConfig(
        method="pcpm", part_size=128))) is None


def test_spans_of_the_relabeling_and_one_relabel(monkeypatch):
    """``plan_make`` of a reordered plan holds the ``reorder`` and
    ``relabel`` stages and the PNG's figures; the solve finds the graph
    relabeled there instead of relabeling again; ``solve`` carries the
    ordering."""
    plan_mod.clear_plan_cache()
    g = _kron(13)
    calls = []
    real = Graph.relabel
    monkeypatch.setattr(Graph, "relabel",
                        lambda self, perm: calls.append(1) or real(self, perm))
    sess = repro_torch.open(g, repro_torch.EngineConfig(
        method="pcpm_pallas", part_size=PART, reorder="degree",
        observe=True), device="cpu")
    try:
        sess.pagerank(num_iterations=3)
        sess.pagerank(num_iterations=3)
        assert len(calls) == 1
        assert plan_mod.internal_graph(g, sess.plan) is \
            sess.plan._device["internal_graph"]
        recs = sess.obs.recorder.snapshot()
        make, = [r for r in recs if r.name == "plan_make"]
        stages = [r for r in recs if r.name == "plan_stage"
                  and r.parent_id == make.span_id]
        assert [r.attrs["stage"] for r in stages] == [
            "validate", "fingerprint", "reorder", "relabel", "png"]
        assert stages[2].attrs["ordering"] == "degree"
        png = sess.plan.png
        assert make.attrs["updates"] == png.num_updates
        assert make.attrs["r"] == png.compression_ratio > 1
        share = np.diff(png.edge_offsets).max() / png.num_edges
        assert make.attrs["max_part_share"] == share
        solves = [r for r in recs if r.name == "solve"]
        assert [r.attrs["reorder"] for r in solves] == ["degree"] * 2
    finally:
        sess.obs.close()
        plan_mod.clear_plan_cache()


@pytest.mark.parametrize("d", [1, 4])
def test_the_reordered_closure_at_any_width_vs_dense(d):
    """The plan's closure, in the relabeled ids, at d = 1 ("tile") and
    d > 1 ("warp", its blocked form made then)."""
    g = _kron(15)
    plan = plan_mod.build_plan(g, plan_mod.PlanConfig(
        method="pcpm_pallas", part_size=128, reorder="degree"))
    gi = plan_mod.internal_graph(g, plan)
    x = np.random.default_rng(d).random((g.num_nodes, d)).astype(np.float32)
    xt = torch.from_numpy(x[:, 0] if d == 1 else x)
    y = spmv_fn(plan, torch.device("cpu"))(xt)
    assert y.shape == xt.shape
    want = dense_spmv(g.num_nodes, gi.src, gi.dst, x.astype(np.float64))
    np.testing.assert_allclose(y.numpy().reshape(-1, d), want, rtol=1e-5,
                               atol=1e-6)
