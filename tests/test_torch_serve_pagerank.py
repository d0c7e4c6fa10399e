"""Port vs reference: PageRank query serving on CPU tensors.

The masked chunk stepper, ``PageRankServer``, the continuous-batching
``SlotScheduler`` (routes, resilience, quarantine, exactly-once
terminals), forward push (host and device), top-k, the metrics and
``GraphRegistry``, each against the JAX package's counterpart on the
same inputs: iteration counts, routes and top-k ids equal; ranks within
1e-6 L∞ of the reference's and 1e-5 of a float64 dense oracle; push
results within ``tol·d/(1−d)`` L1 of the exact fixed point. pcpm_pallas
runs kernel B1 through its plain version on the CPU (and the reference
its Pallas kernel in interpret mode)."""
import dataclasses
import importlib
import threading

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import SpMVEngine, masked_chunk_stepper
from repro_torch.core.pagerank import StepperFailure
from repro_torch.graphs import generators, io as graph_io
from repro_torch.obs.metrics import MetricsRegistry, render_prometheus
from repro_torch.reliability import ResilienceConfig
from repro_torch.serve import (GraphRegistry, PageRankServer,
                               PushQueryEngine, ServeMetrics, SlotScheduler)
from repro_torch.serve import scheduler as sched_mod
from repro_torch.serve.topk import host_topk, make_slot_topk, topk_ranks

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_core = load_reference("core")
ref_sched = load_reference("serve.scheduler")
ref_push = load_reference("serve.push")
ref_topk = load_reference("serve.topk")
ref_metrics = load_reference("serve.metrics")
ref_obs = load_reference("obs.metrics")
ref_adm = load_reference("reliability.admission")
ref_api = load_reference("api")

# the module (``repro_torch.core.pagerank`` the attribute is the function)
pagerank_mod = importlib.import_module("repro_torch.core.pagerank")
PART, DAMPING = 32, 0.85
METHODS = ["pcpm", "pcpm_pallas"]


@pytest.fixture(scope="module")
def graphs():
    return generators.rmat(7, 8, seed=9), ref_gen.rmat(7, 8, seed=9)


def dense_w(g):
    """W[v, u] = 1/deg[u]: the damping-free transition operator."""
    w = np.zeros((g.num_nodes, g.num_nodes))
    np.add.at(w, (g.dst, g.src), 1.0 / np.maximum(g.out_degree, 1)[g.src])
    return w


def personalized_oracle(g, seed, iterations):
    """float64 personalized power iteration at a given iteration count."""
    w = dense_w(g)
    v = np.asarray(seed, np.float64)
    v = v / v.sum()
    x = v.copy()
    for _ in range(iterations):
        x = (1 - DAMPING) * v + DAMPING * (w @ x)
    return x


def fixed_point(g, seed):
    """float64 personalized fixed point, solved directly."""
    w = dense_w(g)
    v = np.asarray(seed, np.float64)
    v = v / v.sum()
    return np.linalg.solve(np.eye(g.num_nodes) - DAMPING * w,
                           (1 - DAMPING) * v)


def one_hot(n, *nodes):
    s = np.zeros(n, np.float32)
    s[list(nodes)] = 1.0
    return s


def both_schedulers(graphs, method, **kw):
    g, r = graphs
    kw = dict(dict(slots=4, part_size=PART, chunk=4), **kw)
    return (SlotScheduler(g, method=method, device="cpu", **kw),
            ref_sched.SlotScheduler(r, method=method, **kw))


def by_order(sch, uids):
    done = {res.uid: res for res in sch.completed}
    return [done[u] for u in uids]


# ------------------------------------------------------------ the stepper
@pytest.mark.parametrize("dangling", ["none", "redistribute"])
@pytest.mark.parametrize("method", ["pdpr", "bvgas"] + METHODS)
def test_masked_chunk_stepper_matches_reference(graphs, method, dangling):
    """Per-column freeze, tol and budget as data, the isfinite
    quarantine and the early exit, chunk after chunk: ``took``,
    ``active`` and ``res`` equal the reference's, ranks within 1e-6, and
    frozen columns stay bit-identical."""
    import jax.numpy as jnp
    g, r = graphs
    n, B = g.num_nodes, 6
    rng = np.random.default_rng(5)
    seeds = rng.random((n, B)).astype(np.float32)
    seeds /= seeds.sum(0)
    pr0 = seeds.copy()
    pr0[:, 4] = np.nan                           # a poisoned column
    base = ((1 - DAMPING) * seeds).astype(np.float32)
    active = np.array([True, True, True, False, True, True])
    tol = np.array([1e-3, 1e-6, 0.0, 1e-6, 1e-6, 1e-5], np.float32)
    budget = np.array([50, 50, 7, 50, 50, 3], np.int32)
    inv = np.where(g.out_degree == 0, 0.0,
                   1.0 / np.maximum(g.out_degree, 1)).astype(np.float32)
    eng = SpMVEngine(g, method=method, part_size=PART, device="cpu")
    step = masked_chunk_stepper(eng, damping=DAMPING, chunk=4,
                                dangling=dangling)
    assert masked_chunk_stepper(eng, damping=DAMPING, chunk=4,
                                dangling=dangling) is step
    ref_step = ref_core.masked_chunk_stepper(
        ref_core.SpMVEngine(r, method=method, part_size=PART),
        damping=DAMPING, chunk=4, dangling=dangling)
    pr, act = torch.from_numpy(pr0.copy()), torch.from_numpy(active)
    rpr, ract = jnp.asarray(pr0), jnp.asarray(active)
    left, rleft = budget.copy(), budget.copy()
    for _ in range(20):
        before = pr.clone()
        pr, act, took, res = step(pr, torch.from_numpy(base), act,
                                  torch.from_numpy(tol),
                                  torch.from_numpy(left),
                                  torch.from_numpy(inv))
        rpr, ract, rtook, rres = ref_step(rpr, jnp.asarray(base), ract,
                                          jnp.asarray(tol),
                                          jnp.asarray(rleft),
                                          jnp.asarray(inv))
        np.testing.assert_array_equal(took.numpy(), np.asarray(rtook))
        np.testing.assert_array_equal(act.numpy(), np.asarray(ract))
        np.testing.assert_allclose(res.numpy(), np.asarray(rres),
                                   rtol=1e-5, atol=1e-7)
        gap = np.abs(pr.numpy() - np.asarray(rpr))
        assert np.nanmax(gap) <= 1e-6
        # the poisoned column is NaN wherever an edge carried its NaN;
        # the reference's Pallas gather (a one-hot product) also spreads
        # it to the destinations without in-edges (NaN * 0), the port's
        # gather (and every other engine of either package) does not
        nan, ref_nan = np.isnan(pr.numpy()), np.isnan(np.asarray(rpr))
        assert np.array_equal(nan[:, [0, 1, 2, 3, 5]],
                              ref_nan[:, [0, 1, 2, 3, 5]])
        assert (nan[:, 4] <= ref_nan[:, 4]).all() and nan[:, 4].any()
        idle = (took == 0).numpy()
        assert np.array_equal(pr[:, idle].numpy(),          # frozen bits
                              before[:, idle].numpy(), equal_nan=True)
        left = left - took.numpy()
        rleft = rleft - np.asarray(rtook)
        if not act.any():
            break
    assert not act.any()
    assert not np.isfinite(res.numpy()[4]) or took.numpy()[4] == 0
    # the column that ran its budget of 7 at tol 0 took exactly 7
    assert budget[2] - left[2] == 7


def test_stepper_reads_the_host_once_per_iteration(graphs, monkeypatch):
    """The exit test is the stepper's only host read: at most one per
    iteration, none after the chunk's last; the scheduler adds one read
    of (active, took, res) per chunk."""
    g, _ = graphs
    reads = {"any": 0, "chunk": 0, "calls": 0, "iters": 0}
    real_any, real_read = pagerank_mod._host_any, sched_mod._read_chunk

    def count_any(t):
        reads["any"] += 1
        return real_any(t)

    def count_read(*a):
        reads["chunk"] += 1
        out = real_read(*a)
        reads["iters"] += int(out[1].max())
        return out

    monkeypatch.setattr(pagerank_mod, "_host_any", count_any)
    monkeypatch.setattr(sched_mod, "_read_chunk", count_read)
    sch = SlotScheduler(g, slots=3, method="pcpm_pallas", part_size=PART,
                        chunk=5, device="cpu", route="stepper")
    real_step = sch._step_c

    def count_step(*a):
        reads["calls"] += 1
        return real_step(*a)

    sch._step_c = count_step
    for i in range(7):
        sch.submit(tol=1e-6 if i % 2 else 0.0, max_iters=3 + 4 * i)
    sch.run_until_drained()
    assert reads["chunk"] == reads["calls"] > 0
    assert reads["any"] <= reads["iters"]
    assert reads["any"] >= reads["iters"] - reads["calls"]


def test_stepper_failure_marks_a_written_pool(graphs):
    g, _ = graphs
    eng = SpMVEngine(g, method="pcpm", part_size=PART, device="cpu")
    step = masked_chunk_stepper(eng, chunk=4)
    n = g.num_nodes
    pr = torch.full((n, 2), 1.0 / n)
    args = (torch.full((n, 2), 0.15 / n), torch.tensor([True, True]),
            torch.zeros(2), torch.tensor([9, 9], dtype=torch.int32))
    with pytest.raises(StepperFailure) as info:
        step(pr, *args, torch.zeros(n + 1))       # wrong inv_deg shape
    assert not info.value.pool_written


# ---------------------------------------------------------- PageRankServer
@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("method", METHODS)
def test_pagerank_server_matches_reference(graphs, method, batch, reorder):
    g, r = graphs
    n = g.num_nodes
    kw = dict(num_iterations=40, tol=1e-6, check_every=2)
    sess = repro_torch.open(g, method=method, part_size=PART,
                            reorder=reorder, device="cpu")
    srv = sess.server(batch=batch, **kw)
    ref = ref_api.open(r, method=method, part_size=PART,
                       reorder=reorder).server(batch=batch, **kw)
    assert srv.trace_count == ref.trace_count == 1
    rng = np.random.default_rng(7)
    seeds = rng.random((n, batch)).astype(np.float32)
    seeds[rng.random((n, batch)) < 0.8] = 0.0
    for q in (None, seeds, None):
        arg = None if q is None else (q if batch > 1 else q[:, 0])
        pr, it, res = srv.query(arg)
        rpr, rit, rres = ref.query(arg)
        assert it == rit and len(res) == len(rres)
        np.testing.assert_allclose(res, rres, rtol=1e-5, atol=1e-6)
        assert pr.shape == tuple(np.shape(rpr))
        assert np.abs(pr.numpy() - np.asarray(rpr)).max() <= 1e-6
        col = (np.full(n, 1.0 / n) if q is None else q[:, 0])
        oracle = personalized_oracle(g, col, it)
        got = pr.numpy() if batch == 1 else pr.numpy()[:, 0]
        assert np.abs(got - oracle).max() <= 1e-5
    assert srv.trace_count == 1


def test_pagerank_server_b1_paths(graphs, monkeypatch):
    """batch > 1 runs the (n, batch) state through B1 "warp", batch 1
    through "tile": the path of each gather, counted on the CPU."""
    from repro_torch.kernels.pcpm_spmv import kernel
    g, _ = graphs
    seen = []
    real = kernel.b1_path
    monkeypatch.setattr(kernel, "b1_path",
                        lambda d, s: seen.append(real(d, s)) or real(d, s))
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=PART,
                            device="cpu")
    sess.server(batch=4).query()
    assert seen == ["warp"] * 20
    seen.clear()
    sess.server(batch=1).query()
    assert seen == ["tile"] * 20


def test_server_rejects_bad_seeds_and_sharding(graphs):
    g, _ = graphs
    srv = PageRankServer(g, part_size=PART, batch=2, device="cpu")
    with pytest.raises(ValueError, match="positive mass"):
        srv.query(np.zeros((g.num_nodes, 2)))
    # sharding (A10) as in the reference: one shard at world size 1 (no
    # process group), the same answers; two shards exceed the devices
    r = graphs[1]
    srv = PageRankServer(g, part_size=PART, sharded=True, device="cpu")
    assert srv.sharded and srv.engine.method == "pcpm_sharded"
    pr, it, _ = srv.query()
    rpr, rit, _ = ref_api.open(r, method="pcpm_sharded",
                               part_size=PART).server().query()
    assert it == rit
    assert np.abs(pr.numpy() - np.asarray(rpr)).max() <= 1e-6
    for make in (lambda: PageRankServer(g, sharded=True, num_shards=2,
                                        device="cpu"),
                 lambda: ref_api.open(r, method="pcpm_sharded",
                                      num_shards=2)):
        with pytest.raises(ValueError, match="available devices"):
            make()


# ---------------------------------------------------------- the scheduler
def mixed_workload(n, push: bool):
    """The reference test's 50 requests by ``i % 4``; with ``push`` the
    single-seed loose-tolerance kind asks for its top 10 (auto-routed to
    push)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(50):
        kind = i % 4
        if kind == 0:
            out.append((None, dict(tol=0.0, max_iters=20)))
        elif kind == 1:
            out.append((one_hot(n, rng.integers(0, n)),
                        dict(tol=1e-3, max_iters=200,
                             top_k=10 if push else None)))
        elif kind == 2:
            out.append((one_hot(n, *rng.integers(0, n, size=4)),
                        dict(tol=1e-6, max_iters=200)))
        else:
            out.append((None, dict(top_k=10, tol=0.0, max_iters=20)))
    return out


# Queries whose stopping test lies within float32 rounding of their tol,
# so the two packages may stop one iteration apart; they are held to the
# dense oracle at their own iteration count instead of the reference's
# count. Query 2 (four seeds, tol 1e-6) on pcpm_pallas: its L1 step change
# at iteration 54 is 1.0349e-6 here and 9.758e-7 in the reference. It
# sums 128 float32 differences of ~1e-8 between ranks of ~1e-2, whose
# rounding (ulp 9.3e-10) is ~10% of each difference, so which side of
# 1e-6 it falls on is rounding, not the algorithm.
ROUNDING_STOPS = {("pcpm_pallas", 2)}


@pytest.mark.parametrize("push", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_mixed_workload_matches_reference(graphs, method, push):
    g, r = graphs
    sch, ref = both_schedulers(graphs, method)
    assert (sch.trace_count, sch.admit_trace_count) == (1, 1)
    work = mixed_workload(g.num_nodes, push)
    uids = [sch.submit(s, **kw) for s, kw in work]
    ref_uids = [ref.submit(s, **kw) for s, kw in work]
    assert len(sch.run_until_drained()) == 50 - sch.metrics.counters[
        "push_served"]
    ref.run_until_drained()
    assert (sch.trace_count, sch.admit_trace_count) == (1, 1)
    ref20 = ref_core.pagerank_reference(r, num_iterations=20)
    for i, ((seed, kw), u, ru, res, rres) in enumerate(zip(
            work, uids, ref_uids, by_order(sch, uids),
            by_order(ref, ref_uids))):
        assert (sch.metrics.traces[u].route, res.converged) == (
            ref.metrics.traces[ru].route, rres.converged)
        if (method, i) in ROUNDING_STOPS:
            assert abs(res.iterations - rres.iterations) <= 1
        else:
            assert res.iterations == rres.iterations
        if res.ranks is not None:
            assert np.abs(res.ranks - rres.ranks).max() <= 1e-6
            oracle = (ref20 if seed is None else
                      personalized_oracle(g, seed, res.iterations))
            assert np.abs(res.ranks - oracle).max() <= 1e-5
        else:
            np.testing.assert_array_equal(res.top_ids, rres.top_ids)
            np.testing.assert_allclose(res.top_scores, rres.top_scores,
                                       atol=1e-6)
        if sch.metrics.traces[u].route == "push":
            exact = fixed_point(g, seed)
            assert np.abs(res.top_scores - exact[res.top_ids]).sum() <= (
                kw["tol"] * DAMPING / (1 - DAMPING))
    assert dict(sch.metrics.counters) == dict(ref.metrics.counters)
    assert sch.metrics.reconcile() == ref.metrics.reconcile()
    assert len({res.iterations for res in sch.completed}) > 1


def test_per_slot_early_exit_and_reuse(graphs):
    g, _ = graphs
    sch = SlotScheduler(g, slots=2, method="pcpm", part_size=PART, chunk=4,
                        device="cpu")
    fast = sch.submit(tol=1e-3, max_iters=200)
    slow = sch.submit(tol=1e-6, max_iters=200)
    more = [sch.submit(tol=0.0, max_iters=5 + 3 * i) for i in range(4)]
    results = sch.run_until_drained()
    by = {res.uid: res for res in results}
    assert results[0].uid == fast
    assert by[fast].iterations < by[slow].iterations
    for u in more:
        assert by[u].iterations == 5 + 3 * more.index(u)
    for u in (fast, slow, *more):
        oracle = ref_core.pagerank_reference(
            ref_gen.rmat(7, 8, seed=9), num_iterations=by[u].iterations)
        assert np.abs(by[u].ranks - oracle).max() <= 1e-5
    assert sch.queued == 0 and sch.active_slots == 0


def test_topk_query_ships_no_vector(graphs):
    g, _ = graphs
    sch = SlotScheduler(g, slots=2, method="pcpm", part_size=PART, chunk=4,
                        device="cpu", route="stepper")
    s = one_hot(g.num_nodes, 11, 29)
    full = sch.submit(s, tol=0.0, max_iters=25)
    top = sch.submit(s, tol=0.0, max_iters=25, top_k=16)
    by = {res.uid: res for res in sch.run_until_drained()}
    assert by[top].ranks is None and by[top].top_ids.dtype == np.int32
    ids, scores = host_topk(by[full].ranks, 16)
    np.testing.assert_array_equal(by[top].top_ids, ids)
    np.testing.assert_array_equal(by[top].top_scores, scores)


def test_reordered_plan_serves_original_ids(graphs):
    g, r = graphs
    kw = dict(method="pcpm_pallas", part_size=PART, reorder="degree")
    sch = repro_torch.open(g, device="cpu", **kw).serve(chunk=4)
    ref = ref_api.open(r, **kw).serve(chunk=4)
    s = one_hot(g.num_nodes, 3, 70)
    for arg in (dict(), dict(top_k=5)):
        a, b = sch.submit(s, tol=1e-6, **arg), ref.submit(s, tol=1e-6, **arg)
        sch.run_until_drained()
        ref.run_until_drained()
        (res,), (rres,) = by_order(sch, [a]), by_order(ref, [b])
        assert res.iterations == rres.iterations
        if res.ranks is not None:
            assert np.abs(res.ranks - rres.ranks).max() <= 1e-6
        else:
            np.testing.assert_array_equal(res.top_ids, rres.top_ids)


def test_invalid_inputs_rejected_as_the_reference_does(graphs):
    g, _ = graphs
    sch = SlotScheduler(g, slots=1, part_size=PART, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        sch.submit(np.zeros(g.num_nodes, np.float32))
    with pytest.raises(ValueError, match="top_k"):
        sch.submit(top_k=0)
    with pytest.raises(ValueError, match="max_iters"):
        sch.submit(max_iters=-1)
    with pytest.raises(ValueError, match="route"):
        sch.submit(route="fast")
    with pytest.raises(ValueError, match="needs a seed"):
        sch.submit(route="push", tol=1e-3)
    with pytest.raises(ValueError, match="slot"):
        SlotScheduler(g, slots=0, device="cpu")
    red = SlotScheduler(g, slots=1, part_size=PART, device="cpu",
                        dangling="redistribute")
    with pytest.raises(ValueError, match="dangling"):
        red.submit(one_hot(g.num_nodes, 1), route="push", tol=1e-3)
    # auto never pushes under redistribute
    u = red.submit(one_hot(g.num_nodes, 1), tol=1e-3, top_k=3)
    red.run_until_drained()
    assert red.metrics.traces[u].route is None


def test_float64_seeds_taken_as_float32(graphs):
    g, _ = graphs
    sch = SlotScheduler(g, slots=2, part_size=PART, device="cpu")
    s64 = np.random.default_rng(1).random(g.num_nodes)
    a, b = sch.submit(s64, tol=1e-6), sch.submit(s64.astype(np.float32),
                                                 tol=1e-6)
    sch.run_until_drained()
    ra, rb = by_order(sch, [a, b])
    assert np.array_equal(ra.ranks, rb.ranks) and ra.ranks.dtype == np.float32


# --------------------------------------------------- routing and fallback
@pytest.mark.parametrize("method", METHODS)
def test_push_fallback_resumes_on_the_stepper(graphs, method):
    g, _ = graphs
    sch, ref = both_schedulers(graphs, method, push_max_sweeps=2)
    s = one_hot(g.num_nodes, 5)
    a, b = (x.submit(s, tol=1e-4, max_iters=100, top_k=5)
            for x in (sch, ref))
    sch.run_until_drained()
    ref.run_until_drained()
    (res,), (rres,) = by_order(sch, [a]), by_order(ref, [b])
    assert sch.metrics.counters["push_fallbacks"] == 1
    assert res.iterations == rres.iterations > 2 and res.converged
    np.testing.assert_array_equal(res.top_ids, rres.top_ids)
    assert (sch.trace_count, sch.admit_trace_count) == (1, 1)


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("method", ["pdpr"] + METHODS)
def test_push_matches_reference(graphs, method, mode):
    g, r = graphs
    eng = PushQueryEngine(g, SpMVEngine(g, method=method, part_size=PART,
                                        device="cpu"), mode=mode)
    ref = ref_push.PushQueryEngine(
        r, ref_core.SpMVEngine(r, method=method, part_size=PART), mode=mode)
    n = g.num_nodes
    deg = np.asarray(g.out_degree)
    sinks = np.nonzero(deg == 0)[0]
    seeds = [one_hot(n, int(np.argmax(deg))), one_hot(n, 7, 90),
             np.full(n, 1.0 / n, np.float32)]
    if sinks.size:
        seeds.append(one_hot(n, int(sinks[0])))
    for seed in seeds:
        for tol in (1e-2, 1e-4):
            res = eng.query(seed / seed.sum(), tol=tol, max_sweeps=100,
                            top_k=10)
            rres = ref.query(seed / seed.sum(), tol=tol, max_sweeps=100,
                             top_k=10)
            assert (res.sweeps, res.converged, res.mode, res.work_nnz) == (
                rres.sweeps, rres.converged, rres.mode, rres.work_nnz)
            assert np.abs(res.estimate - rres.estimate).max() <= 1e-6
            assert abs(res.residual - rres.residual) <= 1e-6
            np.testing.assert_array_equal(res.top_ids, rres.top_ids)
            exact = fixed_point(g, seed)
            assert np.abs(res.estimate - exact).sum() <= (
                tol * DAMPING / (1 - DAMPING))


def test_device_push_reuses_its_state_buffer(graphs):
    g, _ = graphs
    eng = PushQueryEngine(g, SpMVEngine(g, method="pcpm_pallas",
                                        part_size=PART, device="cpu"),
                          mode="device")
    first = eng.query(one_hot(g.num_nodes, 1), tol=1e-4)
    state = eng._dev[3]
    second = eng.query(one_hot(g.num_nodes, 2), tol=1e-4)
    assert eng._dev[3] is state
    assert not np.array_equal(first.estimate, second.estimate)
    again = eng.query(one_hot(g.num_nodes, 1), tol=1e-4)
    np.testing.assert_array_equal(first.estimate, again.estimate)


def test_push_auto_mode_follows_the_engine(graphs):
    """``"auto"`` runs the push where the plan lives: the host loop
    without an engine or with one on the CPU (the device loop for an
    engine on the card: tests/test_torch_cuda.py)."""
    g, _ = graphs
    cpu = SpMVEngine(g, method="pcpm_pallas", part_size=PART, device="cpu")
    assert PushQueryEngine(g).mode == "host"
    assert PushQueryEngine(g, cpu).mode == "host"
    sch = SlotScheduler(g, engine=cpu)
    assert sch.push_mode == "auto" and sch._push_engine().mode == "host"


def test_push_rejects_redistribute_and_tol0(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="dangling"):
        PushQueryEngine(g, dangling="redistribute")
    with pytest.raises(ValueError, match="tol > 0"):
        PushQueryEngine(g).query(one_hot(g.num_nodes, 1), tol=0.0)
    from repro_torch.core.backends import get_backend
    for m in ("pdpr", "bvgas", "pcpm", "pcpm_pallas"):
        b, rb = get_backend(m), ref_core.get_backend(m)
        assert (b.supports_push_query, b.multi_vector,
                b.supports_sharding) == (rb.supports_push_query,
                                         rb.multi_vector,
                                         rb.supports_sharding)


# ---------------------------------------------------------------- top-k
def test_topk_tie_break_lowest_id():
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    for size, k in ((200, 17), (1000, 999), (64, 64), (5, 1)):
        vals = rng.integers(0, 50, size=size).astype(np.float32) / 50.0
        ids, sc = host_topk(vals, k)
        rids, rsc = ref_topk.host_topk(vals, k)
        jids, jsc = ref_topk.topk_ranks(jnp.asarray(vals), k)
        tids, tsc = topk_ranks(torch.from_numpy(vals), k)
        for a, b in ((ids, rids), (ids, np.asarray(jids)),
                     (ids, tids.numpy()), (sc, tsc.numpy()), (sc, rsc)):
            np.testing.assert_array_equal(a, b)
        assert tids.dtype == torch.int32
    pool = torch.zeros(300, 3)                    # every score equal
    pool[[250, 10, 60], 1] = 0.5
    ids, _ = make_slot_topk(300)(pool, 1, 6)
    assert ids.tolist() == [10, 60, 250, 0, 1, 2]


# -------------------------------------------------------------- metrics
def test_metrics_and_prometheus_text_equal_reference():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    out = []
    for mm in ((ServeMetrics, MetricsRegistry, render_prometheus),
               (ref_metrics.ServeMetrics, ref_obs.MetricsRegistry,
                ref_obs.render_prometheus)):
        t[0] = 0.0
        m = mm[0](clock=clock)
        for uid in range(6):
            m.submitted(uid)
        for uid in range(4):
            m.admitted(uid)
        m.completed(0, iterations=12, converged=True)
        m.completed(1, iterations=3, converged=True, route="push")
        m.incr("push_served")
        m.completed(2, iterations=0, converged=False,
                    error="rejected: admission queue full (4)")
        m.incr("rejected")
        m.completed(4, iterations=0, converged=False,
                    error="deadline expired in queue")
        m.incr("expired")
        m.completed(3, iterations=40, converged=False, degraded=True)
        m.incr("degraded")
        with pytest.raises(RuntimeError, match="duplicate terminal"):
            m.completed(3, iterations=1, converged=True)
        reg = mm[1]()
        reg.histogram("lat_s", "latency", graph="a").observe(0.003)
        reg.gauge("depth").set(7)
        reg.counter("c_total", "c").inc(2)
        with pytest.raises(ValueError):
            reg.gauge("c_total")
        text = mm[2]([(m.registry, {"graph": "g"}), (reg, {})])
        out.append((m.reconcile(), m.summary(), m.percentile(50),
                    m.percentile(99, of="queue"), dict(m.counters), text,
                    reg.to_json()))
    assert out[0] == out[1]


def test_resilience_config_equals_reference():
    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(
        ref_adm.ResilienceConfig())
    assert ResilienceConfig().replace(max_queue=3).max_queue == 3


# ----------------------------------------------------------- resilience
def _seeds(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return [one_hot(n, *rng.integers(0, n, size=2)) for _ in range(k)]


def test_max_queue_sheds_explicitly_as_the_reference(graphs):
    g, _ = graphs
    res = ResilienceConfig(max_queue=4, default_deadline_s=30.0)
    sch, ref = both_schedulers(graphs, "pcpm", slots=2, resilience=res)
    ref.resilience = ref_adm.ResilienceConfig(max_queue=4,
                                              default_deadline_s=30.0)
    for x in (sch, ref):
        for s in _seeds(g.num_nodes, 12):
            x.submit(s, tol=1e-6, max_iters=300)
        assert x.queued <= 4
        x.run_until_drained()
    for x in (sch, ref):
        errs = sorted(bool(q.error) for q in x.completed)
        assert errs == [False] * 4 + [True] * 8
        assert all(q.converged for q in x.completed if not q.error)
        assert x.metrics.counters["rejected"] == 8
        x.metrics.reconcile()
    assert [q.error for q in sch.completed] == [
        q.error for q in ref.completed]


def test_deadline_expiry_and_degrade(graphs):
    g, _ = graphs
    t = [0.0]
    for mod, cfg in ((sched_mod, ResilienceConfig),
                     (ref_sched, ref_adm.ResilienceConfig)):
        sch = mod.SlotScheduler(
            g if mod is sched_mod else ref_gen.rmat(7, 8, seed=9),
            slots=1, method="pcpm", part_size=PART, chunk=4,
            resilience=cfg(max_queue=8, degrade_tol=1e-3),
            **({"device": "cpu"} if mod is sched_mod else {}))
        sch.metrics.clock = sch.clock = lambda: t[0]
        t[0] = 0.0
        s1, s2 = _seeds(g.num_nodes, 2)
        u1 = sch.submit(s1, tol=1e-6, max_iters=300)
        u2 = sch.submit(s2, tol=1e-6, max_iters=300, deadline_s=0.5)
        t[0] = 1.0                 # u2's deadline passes while queued
        sch.run_until_drained()
        done = {q.uid: q for q in sch.completed}
        assert "deadline" in done[u2].error and done[u1].converged
        assert sch.metrics.counters["expired"] == 1
        # SLO pressure: a tight query is admitted degraded, not dropped
        sch._iter_s, sch._query_iters = 0.05, 60.0
        u3 = sch.submit(s1, tol=1e-8, max_iters=300, deadline_s=1.0)
        sch.run_until_drained()
        done = {q.uid: q for q in sch.completed}
        assert done[u3].degraded and done[u3].error is None
        assert sch.metrics.counters["degraded"] == 1
        # in flight past its deadline: served with its current iterate
        u4 = sch.submit(s2, tol=1e-9, max_iters=300, deadline_s=5.0)
        sch.step()
        t[0] += 10.0
        sch.step()
        done = {q.uid: q for q in sch.completed}
        assert done[u4].degraded and done[u4].ranks is not None
        assert sch.metrics.counters["deadline_hits"] == 1


def test_priority_order(graphs):
    g, _ = graphs
    sch = SlotScheduler(g, slots=1, part_size=PART, chunk=4, device="cpu")
    s = _seeds(g.num_nodes, 3)
    sch.submit(s[0], tol=1e-6, max_iters=300)
    sch.step()
    a = sch.submit(s[1], tol=1e-6, max_iters=300, priority=0)
    b = sch.submit(s[2], tol=1e-6, max_iters=300, priority=5)
    order = [q.uid for q in sch.run_until_drained()]
    assert order.index(b) < order.index(a)


@pytest.mark.parametrize("retries", [1, 0])
def test_poisoned_slot_quarantined(graphs, retries):
    """A NaN column freezes on the device; its query is re-admitted from
    its clean seed (or failed explicitly), its neighbours untouched."""
    g, _ = graphs
    s = _seeds(g.num_nodes, 3)
    clean = SlotScheduler(g, slots=3, part_size=PART, chunk=4,
                          device="cpu")
    cu = [clean.submit(x, tol=1e-6, max_iters=300) for x in s]
    clean.run_until_drained()
    sch = SlotScheduler(g, slots=3, part_size=PART, chunk=4, device="cpu",
                        resilience=ResilienceConfig(max_retries=retries))
    uids = [sch.submit(x, tol=1e-6, max_iters=300) for x in s]
    sch.step()
    sch._pr[:, 1] = float("nan")
    sch.run_until_drained()
    res, ref = by_order(sch, uids), by_order(clean, cu)
    assert sch.metrics.counters["quarantined"] == 1
    for i in (0, 2):
        assert np.array_equal(res[i].ranks, ref[i].ranks)
    if retries:
        assert sch.metrics.counters["requeued"] == 1
        assert res[1].converged
        assert res[1].iterations == ref[1].iterations + 5   # 4 + 1 burnt
        assert np.abs(res[1].ranks - ref[1].ranks).max() <= 1e-6
    else:
        assert "quarantined" in res[1].error and res[1].ranks is None
    sch.metrics.reconcile()


def _one_slot(g, clock, **kw):
    sch = SlotScheduler(g, slots=1, part_size=PART, chunk=4, device="cpu",
                        **kw)
    sch.metrics.clock = sch.clock = lambda: clock[0]
    return sch


def test_retry_accounting_and_residual_sentinels(graphs):
    """The reference's serve-accounting cases: iterations burnt before a
    quarantine count against ``max_iters`` and are reported; the queue
    wait is the first admission's; a query that ends before any residual
    read back (deadline in the step that re-admitted it, ``max_iters=0``)
    reports ``residual=None``, never the -1 sentinel."""
    g, _ = graphs
    s, t = _seeds(g.num_nodes, 1)[0], [0.0]
    clean = _one_slot(g, t)
    cu = clean.submit(s, tol=1e-6, max_iters=300)
    clean.run_until_drained()
    need = by_order(clean, [cu])[0].iterations
    # a poison after the first chunk burns 4 + 1 iterations
    sch = _one_slot(g, t)
    u = sch.submit(s, tol=1e-6, max_iters=300)
    sch.step()
    t[0] = 1.0
    sch._pr[:, 0] = float("nan")
    sch.run_until_drained()
    (r,) = by_order(sch, [u])
    assert r.converged and r.iterations == need + 5
    assert sch.metrics.traces[u].queue_wait_s == 0.0
    # a budget the poisoned run used up: failed explicitly, no retry
    t[0] = 0.0
    sch = _one_slot(g, t)
    u = sch.submit(s, tol=1e-6, max_iters=5)
    sch.step()
    sch._pr[:, 0] = float("nan")
    sch.run_until_drained()
    (r,) = by_order(sch, [u])
    assert not r.converged and r.residual is None
    assert r.iterations == 5 and "budget exhausted" in r.error
    assert sch.metrics.counters["requeued"] == 0
    # deadline passing in the step that re-admits from the clean seed
    sch = _one_slot(g, t)
    u = sch.submit(s, tol=1e-6, max_iters=300, deadline_s=0.5)
    sch.step()
    t[0] = 1.0
    sch._pr[:, 0] = float("nan")
    sch.step()
    (r,) = by_order(sch, [u])
    assert r.residual is None and r.degraded and r.error is None
    assert r.ranks is not None and sch.metrics.counters["deadline_hits"] == 1
    # no budget at all: the seed itself, no residual
    u = sch.submit(s, tol=1e-6, max_iters=0)
    sch.run_until_drained()
    (r,) = by_order(sch, [u])
    assert r.residual is None and r.iterations == 0 and not r.converged
    np.testing.assert_allclose(r.ranks, s / s.sum(), atol=1e-7)
    sch.metrics.reconcile()


@pytest.mark.parametrize("written", [False, True])
def test_stepper_failure_recovery(graphs, written):
    g, _ = graphs
    sch = SlotScheduler(g, slots=2, part_size=PART, chunk=4, device="cpu")
    real = sch._step_c
    calls = [0]

    def flaky(*a):
        calls[0] += 1
        if calls[0] == 2:
            raise StepperFailure(RuntimeError("boom"), pool_written=written)
        return real(*a)

    sch._step_c = flaky
    uids = [sch.submit(x, tol=1e-6, max_iters=300)
            for x in _seeds(g.num_nodes, 4)]
    sch.run_until_drained()
    res = by_order(sch, uids)
    assert sch.metrics.counters["stepper_failures"] == 1
    if written:
        assert ["stepper failure" in (q.error or "") for q in res] == [
            True, True, False, False]
    else:
        assert all(q.converged for q in res)
    sch.metrics.reconcile()


def test_exactly_once_terminals_under_threads(graphs):
    """More submitting threads than cores, a short switch interval: every
    uid ends exactly once and the counters reconcile."""
    import os
    import sys
    g, _ = graphs
    sch = SlotScheduler(g, slots=3, part_size=PART, chunk=4, device="cpu")
    n = g.num_nodes
    uids, lock = [], threading.Lock()

    def storm(seed):
        rng = np.random.default_rng(seed)
        for i in range(10):
            s = one_hot(n, rng.integers(0, n))
            u = sch.submit(s, tol=1e-3 if i % 2 else 1e-6,
                           top_k=5 if i % 2 else None)
            with lock:
                uids.append(u)

    # more threads than cores, capped to keep the test short
    workers = min((os.cpu_count() or 1) + 2, 24)
    threads = [threading.Thread(target=storm, args=(k,))
               for k in range(workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    sch.run_until_drained()
    done = [q.uid for q in sch.completed]
    assert sorted(done) == sorted(uids) and len(set(done)) == 10 * workers
    sch.metrics.reconcile()
    # the slot pool has one stepping thread
    sch._step_lock.acquire()
    try:
        with pytest.raises(RuntimeError, match="concurrently"):
            sch.step()
    finally:
        sch._step_lock.release()


def test_uid_floor():
    sched_mod.ensure_uid_floor(10 ** 6)
    assert sched_mod.next_uid() >= 10 ** 6


# ------------------------------------------------------------- front door
def test_session_serve_and_server_share_the_plan(graphs):
    from repro_torch.core import plan_cache_stats
    g = generators.rmat(7, 5, seed=41)            # fresh to this test
    before = plan_cache_stats().plan_builds
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=PART,
                            slots=3, chunk=2, device="cpu")
    sch = sess.serve(route="stepper")
    srv = sess.server(batch=2)
    assert sch.engine.plan is srv.engine.plan is sess.plan
    assert plan_cache_stats().plan_builds == before + 1
    assert (sch.slots, sch.chunk, sch.route) == (3, 2, "stepper")
    assert sess.serve(slots=5).slots == 5


def test_later_slices_raise_naming_them(graphs):
    g, _ = graphs
    kw = dict(part_size=PART, device="cpu")
    # the sharded slice (A10) is in, with the reference's rules:
    # sharded=True picks pcpm_sharded (one shard at world size 1),
    # num_shards alone is ignored by a method that cannot shard, and
    # more shards than devices are refused
    for make in (SlotScheduler, PageRankServer):
        assert make(g, **kw, sharded=True).engine.method == "pcpm_sharded"
        assert make(g, **kw, num_shards=4).engine.plan.num_shards is None
        with pytest.raises(ValueError, match="num_shards=4 exceeds"):
            make(g, **kw, sharded=True, num_shards=4)
    with pytest.raises(ValueError, match="num_shards=4 exceeds"):
        ref_sched.SlotScheduler(graphs[1], part_size=PART, sharded=True,
                                num_shards=4)
    with pytest.raises(TypeError, match="no_such_knob"):
        SlotScheduler(g, **kw, no_such_knob=1)
    SlotScheduler(g, **kw, sharded=False, num_shards=1, obs=None)
    # the reliability (A6) and ingest (A7) slices are in
    from repro_torch.ingest import NodeIdMapping
    from repro_torch.reliability import FaultInjector, FaultPlan
    sch = SlotScheduler(g, **kw, fault_injector=FaultInjector(FaultPlan()),
                        idmap=NodeIdMapping.identity(g.num_nodes))
    assert sch.idmap.num_nodes == g.num_nodes
    # the streaming slice (A5) is in: an empty delta rebinds in place
    sch = SlotScheduler(g, **kw)
    plan = sch.engine.plan
    sch.apply_delta(repro_torch.GraphDelta())
    assert sch.rebind_count == 1 and sch.engine.plan is plan
    # the gateway (A8) and observability (A9) slices are in
    from repro_torch.obs import Observability
    obs = Observability()
    assert SlotScheduler(g, **kw, obs=obs).obs is obs
    obs.close()
    reg = GraphRegistry(device="cpu", part_size=PART)
    reg.add("a", g)
    u = reg.submit("a", tol=1e-6)
    assert [r.uid for r in reg.run_until_drained()["a"]] == [u]
    with reg.gateway() as gw:
        assert gw.submit(None, tol=1e-6).result(timeout=60).converged


# --------------------------------------------------------------- registry
def test_registry_loads_and_keeps_a_memory_budget(tmp_path):
    from repro_torch.core import GraphPlan, build_plan, PlanConfig
    from repro_torch.core.plan import plan_nbytes
    graphs_ = {f"g{i}": generators.rmat(6, 4, seed=50 + i) for i in range(3)}
    g0 = graphs_["g0"]
    graph_io.save(str(tmp_path / "g0.npz"), g0)
    plan = build_plan(g0, PlanConfig(method="pcpm", part_size=PART))
    plan.save(str(tmp_path / "g0.plan.npz"))
    size = plan_nbytes(plan)
    reg = GraphRegistry(memory_budget_bytes=2 * size + size // 2,
                        device="cpu", method="pcpm", part_size=PART,
                        slots=2, chunk=4)
    sch0 = reg.load("g0", str(tmp_path / "g0.npz"),
                    plan_path=str(tmp_path / "g0.plan.npz"))
    assert isinstance(sch0.engine.plan, GraphPlan)
    reg.add("g1", graphs_["g1"])
    u = reg.submit("g1", tol=1e-6)              # g1 busy, g0 idle
    reg.add("g2", graphs_["g2"])                # over budget: evict g0
    assert "g0" not in reg and "g1" in reg and reg.evictions == 1
    assert reg.names() == ["g1", "g2"] and len(reg) == 2
    with pytest.raises(ValueError, match="drain it first"):
        reg.evict("g1")
    reg.get("g1").run_until_drained()
    assert reg.get("g1").completed[0].uid == u
    with pytest.raises(KeyError, match="unknown graph"):
        reg.get("g0")
    with pytest.raises(ValueError, match="already registered"):
        reg.add("g2", graphs_["g2"])
