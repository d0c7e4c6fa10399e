"""Port vs reference: the PageRank drivers on CPU tensors, for all four
engines. Ranks agree to L∞ 1e-6; the iteration count and the residual
slots (which iterations checked convergence) are identical, and the
residual values agree to float32 summation order."""
import importlib

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


# ------------------------------------------ fixed-count solves as CUDA graphs
def _engine_on(device_type, method):
    """What ``graph_eligible`` reads of an engine: its device and its
    backend."""
    from types import SimpleNamespace
    from repro_torch.core.backends import get_backend
    return SimpleNamespace(device=torch.device(device_type),
                           backend=get_backend(method))


@pytest.mark.parametrize("device_type,method,tol,want", [
    ("cuda", "pcpm_pallas", 0.0, True),
    ("cpu", "pcpm_pallas", 0.0, False),
    ("cuda", "pcpm_pallas", 1e-6, False),
    ("cuda", "pcpm_sharded", 0.0, False),
    ("cuda", "pdpr", 0.0, True),
    ("cuda", "bvgas", 0.0, True),
    ("cuda", "pcpm", 0.0, True),
], ids=["cuda", "cpu", "tol", "sharding", "cuda-pdpr", "cuda-bvgas",
        "cuda-pcpm"])
def test_graph_eligibility_rule(device_type, method, tol, want):
    from repro_torch.core.pagerank import graph_eligible
    assert graph_eligible(_engine_on(device_type, method), tol) is want


@pytest.mark.parametrize("tol", [0.0, 1e-6])
@pytest.mark.parametrize("method", METHODS)
def test_cpu_solves_stay_eager(graphs, method, tol):
    """On the CPU a solve neither captures nor replays: the counters stay
    and the plan's loop cache holds no graph."""
    solver = importlib.import_module("repro_torch.core.pagerank")
    g, _ = graphs
    eng = SpMVEngine(g, method=method, part_size=PART, device="cpu")
    before = solver.graph_captures, solver.graph_replays
    for _ in range(2):
        pagerank(g, engine=eng, tol=tol)
    assert (solver.graph_captures, solver.graph_replays) == before
    assert not [k for k in eng._fused_cache if k[0] == "graph"]


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` for the CPU: the capture block runs its
    body eagerly, so the static outputs hold the solve's result, and a
    replay leaves them as they are (the captured solve has no input that
    changes between replays)."""
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph path on CPU tensors: every ``tol == 0`` solve eligible,
    ``torch.cuda.graph`` a block that runs its body, and each call of
    B1's "tile" entry counted as a launch, as on the card; plans made
    afresh, and dropped after, so no other test meets a marked or
    captured loop."""
    import contextlib
    from repro_torch.core.plan import clear_plan_cache
    solver = importlib.import_module("repro_torch.core.pagerank")
    clear_plan_cache()
    from repro_torch.kernels.pcpm_spmv import kernel, ops
    monkeypatch.setattr(solver, "graph_eligible", lambda eng, tol: tol == 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())
    gather = ops.tile_gather_cuda

    def counted(*args, **kw):
        kernel.count_launches({"tile": 1})
        return gather(*args, **kw)

    monkeypatch.setattr(ops, "tile_gather_cuda", counted)
    _FakeGraph.replays = 0
    yield solver, kernel
    clear_plan_cache()


def _graph_entries(eng):
    return [v for k, v in eng._fused_cache.items() if k[0] == "graph"]


@pytest.mark.parametrize("check_every", [1, 3])
@pytest.mark.parametrize("dangling", ["none", "redistribute"])
def test_graph_path_flow_on_the_cpu(graphs, fake_graphs, dangling,
                                    check_every):
    """The first eligible solve runs eagerly, the second captures and
    replays, later ones replay, each into fresh ranks and residuals equal
    to the eager solve's, adding the captured launches; ``release_device``
    drops the graph and the loop starts over; ``tol > 0`` stays eager."""
    from repro_torch.core.plan import release_device
    solver, kernel = fake_graphs
    g, _ = graphs
    eng = SpMVEngine(g, method="pcpm_pallas", part_size=PART, device="cpu")
    kw = dict(engine=eng, dangling=dangling, check_every=check_every)
    eager = pagerank(g, **kw, driver="fused", tol=1e-30)
    captures, replays = solver.graph_captures, solver.graph_replays
    tiles = kernel.launch_counts["tile"]
    results = [pagerank(g, **kw) for _ in range(4)]
    assert solver.graph_captures == captures + 1
    assert solver.graph_replays == replays + 3 == _FakeGraph.replays + replays
    assert kernel.launch_counts["tile"] == tiles + 4 * 20
    for res in results:
        assert res.iterations == eager.iterations == 20
        assert torch.equal(res.ranks, eager.ranks)
        assert res.residuals == eager.residuals
    ptrs = {res.ranks.data_ptr() for res in results}
    assert len(ptrs) == len(results)
    held = results[1].ranks.clone()
    pagerank(g, **kw)
    assert torch.equal(results[1].ranks, held)
    release_device(eng.plan)
    pagerank(g, **kw)
    assert solver.graph_captures == captures + 1
    pagerank(g, **kw)
    assert solver.graph_captures == captures + 2
    pagerank(g, **kw, tol=1e-6)
    assert solver.graph_replays == replays + 5


def test_one_off_solve_captures_nothing(graphs, fake_graphs):
    """A loop solved once pays no capture and pins no graph: each new
    ``num_iterations`` runs eagerly and leaves only a mark."""
    solver, _ = fake_graphs
    g, _ = graphs
    eng = SpMVEngine(g, method="pcpm_pallas", part_size=PART, device="cpu")
    captures = solver.graph_captures
    for iterations in (3, 4, 5):
        assert pagerank(g, engine=eng,
                        num_iterations=iterations).iterations == iterations
    assert solver.graph_captures == captures
    assert _graph_entries(eng) == [solver._SEEN] * 3


def test_held_graph_keeps_what_its_kernels_read(graphs, fake_graphs):
    """A graph held after ``release_device`` has dropped the plan's loop
    cache keeps the loop's closure, which holds the device layouts its
    kernels read, and replays the same ranks as a fresh solve; the
    closure goes with the graph."""
    import gc
    import weakref
    from repro_torch.core.plan import release_device
    g, _ = graphs
    eng = SpMVEngine(g, method="pcpm_pallas", part_size=PART, device="cpu")
    for _ in range(2):
        pagerank(g, engine=eng)
    (solve,) = _graph_entries(eng)
    assert solve.run is fused_power_iteration(eng)
    loop = weakref.ref(solve.run)
    release_device(eng.plan)
    gc.collect()
    assert loop() is not None
    ranks, it, _ = solve.replay()
    fresh = pagerank(g, engine=eng)
    assert it == fresh.iterations == 20
    assert torch.equal(ranks, fresh.ranks)
    del solve
    gc.collect()
    assert loop() is None


def test_capture_takes_back_only_its_own_threads_launches(
        graphs, fake_graphs, monkeypatch):
    """B1 launches another thread counts while a solve is captured stay
    counted: the capture takes back only the launches of its own
    thread, and each replay adds exactly those."""
    import contextlib
    import threading
    _, kernel = fake_graphs

    def graph_with_a_neighbour(graph, **kw):
        other = threading.Thread(target=kernel.count_launches,
                                 args=({"warp": 3, "tile": 5},))
        other.start()
        other.join()
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "graph", graph_with_a_neighbour)
    g, _ = graphs
    eng = SpMVEngine(g, method="pcpm_pallas", part_size=PART, device="cpu")
    pagerank(g, engine=eng)
    before = dict(kernel.launch_counts)
    pagerank(g, engine=eng)                 # captures and replays
    (solve,) = _graph_entries(eng)
    assert solve.launches == {"warp": 0, "tile": 20}
    assert kernel.launch_counts == {"warp": before["warp"] + 3,
                                    "tile": before["tile"] + 5 + 20}
