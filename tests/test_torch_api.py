"""Port vs reference: the ``open(g).pagerank()`` front door, on CPU tensors,
and the port's device rule (CUDA by default, raising without it)."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import EngineConfig
from repro_torch.core import pagerank_reference, plan_cache_stats
from repro_torch.graphs import generators

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_api = load_reference("api")

METHODS = ["pdpr", "bvgas", "pcpm", "pcpm_pallas"]


@pytest.fixture(scope="module")
def graphs():
    return generators.rmat(10, 8, seed=0), ref_gen.rmat(10, 8, seed=0)


@pytest.mark.parametrize("reorder", ["none", "hybrid"])
@pytest.mark.parametrize("method", METHODS)
def test_open_pagerank_matches_reference(graphs, method, reorder):
    g, r = graphs
    sess = repro_torch.open(g, EngineConfig(method=method, part_size=256,
                                            reorder=reorder), device="cpu")
    ref_sess = ref_api.open(r, ref_api.EngineConfig(
        method=method, part_size=256, reorder=reorder))
    res, ref = sess.pagerank(), ref_sess.pagerank()
    assert res.iterations == ref.iterations
    assert len(res.residuals) == len(ref.residuals)
    assert np.abs(res.ranks.numpy() - np.asarray(ref.ranks)).max() <= 1e-6
    assert np.abs(res.ranks.numpy() - pagerank_reference(g)).max() <= 1e-6
    ids, scores = sess.top_ranked(10)
    ref_ids, ref_scores = ref_sess.top_ranked(10)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-6)
    assert np.all(np.diff(scores) <= 0)


@pytest.mark.parametrize("method", METHODS)
def test_session_overrides_and_spmv(graphs, method):
    g, r = graphs
    sess = repro_torch.open(g, method=method, part_size=256, tol=1e-6,
                            check_every=3, device="cpu")
    ref_sess = ref_api.open(r, method=method, part_size=256, tol=1e-6,
                            check_every=3)
    kw = dict(num_iterations=100, dangling="redistribute")
    res, ref = sess.pagerank(**kw), ref_sess.pagerank(**kw)
    assert res.iterations == ref.iterations < 100
    assert np.abs(res.ranks.numpy() - np.asarray(ref.ranks)).max() <= 1e-6
    x = (np.random.default_rng(1).integers(0, 64, (g.num_nodes, 4))
         / 64).astype(np.float32)
    np.testing.assert_allclose(sess.spmv(x).numpy(),
                               np.asarray(ref_sess.spmv(x)), rtol=1e-5,
                               atol=1e-6)


def test_one_plan_per_graph_and_config():
    g = generators.rmat(9, 4, seed=11)          # fresh to this test
    before = plan_cache_stats().plan_builds
    s1 = repro_torch.open(g, method="pcpm", part_size=128, device="cpu")
    s2 = repro_torch.open(g, method="pcpm", part_size=128, device="cpu",
                          damping=0.9)
    assert s1.plan is s2.plan
    assert plan_cache_stats().plan_builds == before + 1
    stats = s2.stats()
    assert (stats["method"], stats["device"], stats["n"]) == (
        "pcpm", "cpu", g.num_nodes)


def test_top_ranked_ties_lowest_id_first():
    from repro_torch.graphs import from_edge_list
    # only node 1 has an in-edge: nodes 0, 2..5 tie exactly at the
    # teleport rank and come lowest id first
    g = from_edge_list(6, np.array([[3, 1]], dtype=np.int32))
    sess = repro_torch.open(g, method="pdpr", part_size=4, device="cpu")
    with pytest.raises(ValueError, match="pagerank"):
        sess.top_ranked(2)
    sess.pagerank()
    ids, scores = sess.top_ranked(6)
    assert list(ids) == [1, 0, 2, 3, 4, 5]
    assert len(set(scores[1:].tolist())) == 1
    assert list(sess.top_ranked(3)[0]) == [1, 0, 2]


def test_cuda_is_the_default_and_raises_without_it(graphs):
    g, _ = graphs
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs there")
    for call in (lambda: repro_torch.open(g, method="pcpm", part_size=256),
                 lambda: repro_torch.open(g, EngineConfig(method="pdpr"),
                                          device="cuda"),
                 lambda: repro_torch.resolve_device(None),
                 lambda: g.device_coo()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_later_slices_raise(graphs):
    g, r = graphs
    sess = repro_torch.open(g, method="pcpm", part_size=256, device="cpu")
    # the sharded slice (A10) is in, with the reference's rules: a
    # backend that cannot shard ignores num_shards, and a sharded plan
    # wider than the devices (the world size; 1 here) is refused
    assert repro_torch.open(g, method="pcpm", part_size=256, device="cpu",
                            num_shards=2).plan.config.num_shards is None
    assert ref_api.open(r, method="pcpm", part_size=256,
                        num_shards=2).plan.config.num_shards is None
    for open_ in (lambda: repro_torch.open(g, method="pcpm_sharded",
                                           num_shards=2, device="cpu"),
                  lambda: ref_api.open(r, method="pcpm_sharded",
                                       num_shards=2)):
        with pytest.raises(ValueError, match="num_shards=2 exceeds"):
            open_()
    # the gateway (A8) and observability (A9) slices are in
    obs = sess.observe()
    assert sess.observe() is obs and sess.obs is obs
    with sess.gateway(autotune=False, slots=2) as gw:
        assert gw.obs is obs
        assert gw.submit(None, tol=1e-6).result(timeout=60).converged
    observed = repro_torch.open(g, method="pcpm", part_size=256,
                                device="cpu", observe=True)
    assert observed.obs is not None and "obs" in observed.stats()
    obs.close()
    observed.obs.close()
    # the streaming slice is in: a warm call with no prior solve is a
    # cold one, and an empty delta keeps the plan
    assert sess.pagerank(warm=True).iterations == sess.config.num_iterations
    plan = sess.plan
    assert sess.apply_delta(repro_torch.GraphDelta()) is sess
    assert sess.plan is plan
    # the reliability slice is in: a checkpoint needs a solve first
    fresh = repro_torch.open(g, method="pcpm", part_size=256, device="cpu")
    with pytest.raises(ValueError, match="nothing to checkpoint"):
        fresh.save_checkpoint("x")


def test_engine_attributes_preserved():
    """reference test_api.py::test_engine_attributes_preserved (ROADMAP
    C3), and the sharded case: a sharded plan's ratio is on the wire."""
    from repro_torch.core import SpMVEngine
    g, r = generators.rmat(8, 4, seed=0), ref_gen.rmat(8, 4, seed=0)
    ref_core = load_reference("core")
    eng = SpMVEngine(g, method="pcpm", part_size=32, device="cpu")
    ref = ref_core.SpMVEngine(r, method="pcpm", part_size=32)
    assert eng.partitioning.part_size == 32
    assert eng.layout.compression_ratio == eng.compression_ratio > 1
    assert eng.compression_ratio == ref.compression_ratio
    assert round(eng.compression_ratio, 4) == 2.0687
    assert eng.num_nodes == g.num_nodes
    eng_p = SpMVEngine(g, method="pdpr", device="cpu")
    assert eng_p.compression_ratio == 1.0
    with pytest.raises(AttributeError):
        eng_p.layout
    with pytest.raises(AttributeError):
        eng_p.sharded_layout
    eng_s = SpMVEngine(g, method="pcpm_sharded", device="cpu")
    ref_s = ref_core.SpMVEngine(r, method="pcpm_sharded")
    assert (eng_s.compression_ratio == eng_s.sharded_layout.wire_compression
            == ref_s.compression_ratio)
    assert eng_s.shard_axis == ref_s.shard_axis == "shards"
    with pytest.raises(AttributeError):
        eng_s.layout


def test_bad_config_rejected(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="unknown method"):
        repro_torch.open(g, method="gespmm", device="cpu")
    with pytest.raises(ValueError, match="unknown reorder"):
        repro_torch.open(g, method="pcpm", reorder="gorder", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        repro_torch.open(g, method="pcpm", device="meta")
