"""Port vs reference: the PageRank drivers on CPU tensors, for all four
engines. Ranks agree to L∞ 1e-6; the iteration count and the residual
slots (which iterations checked convergence) are identical, and the
residual values agree to float32 summation order."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro_torch.core import (SpMVEngine, fused_power_iteration, pagerank,
                              pagerank_reference)
from repro_torch.graphs import generators

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_core = load_reference("core")

METHODS = ["pdpr", "bvgas", "pcpm", "pcpm_pallas"]
PART = 256


@pytest.fixture(scope="module")
def graphs():
    return generators.rmat(10, 8, seed=0), ref_gen.rmat(10, 8, seed=0)


def assert_same_run(res, ref, oracle=None):
    ranks = res.ranks.numpy()
    assert res.iterations == ref.iterations
    assert len(res.residuals) == len(ref.residuals)
    # residuals are L1 sums over n rank differences, each of which
    # carries the two packages' rounding: same bound as the ranks'
    np.testing.assert_allclose(res.residuals, ref.residuals, rtol=1e-5,
                               atol=1e-6)
    assert np.abs(ranks - np.asarray(ref.ranks)).max() <= 1e-6
    if oracle is not None:
        assert np.abs(ranks - oracle).max() <= 1e-6


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("tol", [0.0, 1e-6])
@pytest.mark.parametrize("method", METHODS)
def test_pagerank_matches_reference(graphs, method, tol, check_every):
    g, r = graphs
    kw = dict(method=method, part_size=PART, tol=tol,
              check_every=check_every)
    res = pagerank(g, device="cpu", **kw)
    assert_same_run(res, ref_core.pagerank(r, **kw), pagerank_reference(g))
    expected_slots = 20 if check_every == 1 else 7      # 3, 6, ..., 18, 20
    assert len(res.residuals) == expected_slots


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("method", METHODS)
def test_early_exit_matches_reference(graphs, method, check_every):
    g, r = graphs
    kw = dict(method=method, part_size=PART, num_iterations=100, tol=1e-6,
              check_every=check_every)
    res = pagerank(g, device="cpu", **kw)
    ref = ref_core.pagerank(r, **kw)
    assert res.iterations < 100
    assert_same_run(res, ref)
    assert res.residuals[-1] < 1e-6 <= res.residuals[-2]


@pytest.mark.parametrize("dangling", ["none", "redistribute"])
@pytest.mark.parametrize("method", METHODS)
def test_dangling_policies(graphs, method, dangling):
    g, r = graphs
    assert (g.out_degree == 0).any()          # the graph has sinks
    kw = dict(method=method, part_size=PART, dangling=dangling)
    res = pagerank(g, device="cpu", **kw)
    assert_same_run(res, ref_core.pagerank(r, **kw),
                    pagerank_reference(g, dangling=dangling))
    if dangling == "redistribute":
        assert abs(float(res.ranks.double().sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("method", METHODS)
def test_reordered_plan(graphs, method):
    from repro_torch.core import PlanConfig, build_plan
    g, r = graphs
    eng = SpMVEngine(g, plan=build_plan(g, PlanConfig(
        method=method, part_size=PART, reorder="hybrid")), device="cpu")
    ref_eng = ref_core.SpMVEngine(r, plan=ref_core.build_plan(
        r, ref_core.PlanConfig(method=method, part_size=PART,
                               reorder="hybrid")))
    res = pagerank(g, engine=eng, tol=1e-6, check_every=3)
    ref = ref_core.pagerank(r, engine=ref_eng, tol=1e-6, check_every=3)
    assert_same_run(res, ref, pagerank_reference(g))


@pytest.mark.parametrize("method", ["pdpr", "pcpm_pallas"])
def test_python_driver(graphs, method):
    g, r = graphs
    kw = dict(method=method, part_size=PART, driver="python",
              num_iterations=100, tol=1e-6, dangling="redistribute")
    assert_same_run(pagerank(g, device="cpu", **kw),
                    ref_core.pagerank(r, **kw))


@pytest.mark.parametrize("method", ["pcpm", "pcpm_pallas"])
def test_multi_vector_fused_loop(graphs, method):
    g, r = graphs
    n, d = g.num_nodes, 3
    rng = np.random.default_rng(0)
    seeds = rng.random((n, d)).astype(np.float32)
    base = (seeds / seeds.sum(0) * 0.15).astype(np.float32)
    pr0 = np.full((n, d), 1.0 / n, np.float32)
    inv = np.where(g.out_degree == 0, 0.0,
                   1.0 / np.maximum(g.out_degree, 1)).astype(np.float32)
    kw = dict(num_iterations=30, tol=1e-5, check_every=2, multi=True)
    run = fused_power_iteration(SpMVEngine(g, method=method, part_size=PART,
                                           device="cpu"), **kw)
    pr, it, res = run(torch.from_numpy(pr0), torch.from_numpy(inv),
                      torch.from_numpy(base))
    ref_run = ref_core.fused_power_iteration(
        ref_core.SpMVEngine(r, method=method, part_size=PART), **kw)
    rpr, rit, rres = ref_run(jnp.asarray(pr0), jnp.asarray(inv),
                             jnp.asarray(base))
    assert it == int(rit)
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(pr.numpy() - np.asarray(rpr)).max() <= 1e-6


def test_inv_degree_matches_and_is_memoized(graphs):
    from repro_torch.core.pagerank import _inv_degree
    g, r = graphs
    inv = _inv_degree(g, "cpu")
    np.testing.assert_array_equal(
        inv.numpy(),
        np.asarray(load_reference("core.pagerank")._inv_degree(r)))
    assert _inv_degree(g, torch.device("cpu")) is inv


def test_reference_oracle_copied(graphs):
    g, r = graphs
    for dangling in ("none", "redistribute"):
        np.testing.assert_array_equal(
            pagerank_reference(g, dangling=dangling, num_iterations=7),
            ref_core.pagerank_reference(r, dangling=dangling,
                                        num_iterations=7))


def test_unknown_policy_and_driver(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="dangling"):
        pagerank(g, method="pcpm", part_size=PART, dangling="spread",
                 device="cpu")
    with pytest.raises(ValueError, match="driver"):
        pagerank(g, method="pcpm", part_size=PART, driver="jit",
                 device="cpu")
