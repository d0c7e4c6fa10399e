"""Port vs reference: the async serving gateway on CPU tensors.

Every case of the JAX package's ``tests/test_gateway.py`` runs here on the
port and on the reference, side by side on the same inputs: the front
door under concurrency (exactly-once futures, synchronous validation,
backlog rejection, the scheduler's queue cap, deadlines, priority), the
warm-result cache (bit-identical hits, what is not cached, invalidation
at a delta's commit), slot autotune, ``WeightedFair`` and the registry's
weighted drain and memory budget. Where the outcome is deterministic the
two packages' results are held equal: terminal states, iteration counts,
top-k ids, ranks and scores within 1e-6, error messages, pick sequences
and ``seed_digest`` strings.
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import gateway as port_gateway
from repro_torch.graphs import generators
from repro_torch.reliability import ResilienceConfig
from repro_torch.serve import GraphRegistry, SlotScheduler
from repro_torch.stream import GraphDelta
from repro_torch.stream.delta import apply_delta as apply_edges

from test_torch_reference import load_reference

ref_stream = load_reference("stream")
ref_gateway = load_reference("gateway")
ref_cache = load_reference("gateway.cache")
ref_gen = load_reference("graphs.generators")
ref_rel = load_reference("reliability")
ref_serve = load_reference("serve")
ref_api = load_reference("api")
ref_plan = load_reference("core.plan")

SMALL = dict(method="pcpm", part_size=64, chunk=4)


class Pkg:
    """One package's names, so each case's body runs on both."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.gen, self.gw = generators, port_gateway
            self.cache = port_gateway.cache
            self.SlotScheduler, self.GraphRegistry = (SlotScheduler,
                                                      GraphRegistry)
            self.ResilienceConfig, self.GraphDelta = (ResilienceConfig,
                                                      GraphDelta)
            self.apply_edges = apply_edges
            self.open, self.EngineConfig = (repro_torch.open,
                                            repro_torch.EngineConfig)
            self.cpu = dict(device="cpu")
            from repro_torch.core.plan import plan_nbytes
        else:
            self.gen, self.gw, self.cache = ref_gen, ref_gateway, ref_cache
            self.SlotScheduler = ref_serve.SlotScheduler
            self.GraphRegistry = ref_serve.GraphRegistry
            self.ResilienceConfig = ref_rel.ResilienceConfig
            self.GraphDelta = ref_stream.GraphDelta
            self.apply_edges = ref_stream.delta.apply_delta
            self.open, self.EngineConfig = ref_api.open, ref_api.EngineConfig
            self.cpu = {}
            plan_nbytes = ref_plan.plan_nbytes
        self.plan_nbytes = plan_nbytes

    def scheduler(self, g, **kw):
        return self.SlotScheduler(g, **{**SMALL, **self.cpu, **kw})

    def registry(self, **kw):
        return self.GraphRegistry(**{**SMALL, **self.cpu, **kw})

    def session(self, g, **kw):
        return self.open(g, self.EngineConfig(**kw), **self.cpu)


PORT, REF = Pkg(True), Pkg(False)
BOTH = (PORT, REF)


@pytest.fixture(scope="module")
def graphs():
    g, r = generators.rmat(8, 8, seed=1), ref_gen.rmat(8, 8, seed=1)
    assert np.array_equal(g.src, r.src) and np.array_equal(g.dst, r.dst)
    return {PORT: g, REF: r}


def _seed(g, at=3):
    s = np.zeros(g.num_nodes, np.float32)
    s[at] = 1.0
    s[(at * 7 + 1) % g.num_nodes] = 1.0
    return s


def _delta(pkg, g, rng_seed=0, k=24):
    rng = np.random.default_rng(rng_seed)
    src = rng.integers(0, g.num_nodes, k).astype(np.int64)
    dst = rng.integers(0, g.num_nodes, k).astype(np.int64)
    return pkg.GraphDelta.insert(np.stack([src, dst], axis=1))


def _audit_futures(sch, results):
    """Exactly-once: every future resolved to a distinct uid whose trace
    is terminal and consistent with the result."""
    counts = collections.Counter(r.uid for r in results)
    assert all(c == 1 for c in counts.values())
    for r in results:
        tr = sch.metrics.traces[r.uid]
        assert tr.t_done is not None
        assert tr.converged == r.converged
        assert tr.error == r.error


def _same(port, ref):
    """Two packages' results of the same requests, in the same order:
    the same terminal states and iteration counts, top-k ids equal,
    ranks and scores within 1e-6."""
    assert len(port) == len(ref)
    for x, y in zip(port, ref):
        assert x.error == y.error
        assert (x.converged, x.iterations, x.cached) == (
            y.converged, y.iterations, y.cached)
        for a, b in ((x.ranks, y.ranks), (x.top_scores, y.top_scores)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-6
        if x.top_ids is not None or y.top_ids is not None:
            assert np.array_equal(x.top_ids, np.asarray(y.top_ids))


# ----------------------------------------------------------- front door
def test_mixed_traffic_resolves(graphs):
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=4)
        with pkg.gw.Gateway(sch) as gw:
            futs = [gw.submit(_seed(g, at=i), top_k=8, tol=1e-2,
                              max_iters=300) for i in range(3)]
            futs += [gw.submit(None, tol=1e-6, max_iters=200)
                     for _ in range(3)]
            res = [f.result(timeout=120) for f in futs]
        assert all(r.error is None and r.converged for r in res)
        assert sch.metrics.counters["push_served"] == 3
        assert sch.trace_count == 1
        assert sch.admit_trace_count == 1
        _audit_futures(sch, res)
        # the three uniform requests are one cache key: which of them
        # solved and which were served from the cache is a race
        out[pkg] = res[:3]
    _same(out[PORT], out[REF])


def test_submit_validates_synchronously(graphs):
    messages = {}
    for pkg in BOTH:
        sch = pkg.scheduler(graphs[pkg], slots=1)
        got = []
        with pkg.gw.Gateway(sch) as gw:
            for kw, match in ((dict(max_iters=-1), "max_iters"),
                              (dict(top_k=0), "top_k"),
                              (dict(route="push"), "needs a seed")):
                with pytest.raises(ValueError, match=match) as err:
                    gw.submit(None, **kw)
                got.append(str(err.value))
        messages[pkg] = got
    assert messages[PORT] == messages[REF]


def test_backlog_rejection_is_explicit(graphs):
    """max_pending=0: every stepper query is shed at the gateway with a
    terminal, counted result; push-eligible traffic keeps flowing."""
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=1)
        cfg = pkg.gw.GatewayConfig(max_pending=0, cache_entries=0)
        with pkg.gw.Gateway(sch, config=cfg) as gw:
            r_step = gw.submit(None, tol=1e-6).result(timeout=60)
            r_push = gw.submit(_seed(g), top_k=8,
                               tol=1e-2).result(timeout=60)
        assert "gateway backlog full" in r_step.error
        assert not r_step.converged
        assert r_push.error is None and r_push.converged
        assert sch.metrics.counters["rejected"] == 1
        _audit_futures(sch, [r_step, r_push])
        out[pkg] = [r_step, r_push]
    _same(out[PORT], out[REF])


def test_scheduler_queue_cap_survives_gateway(graphs):
    """A bounded scheduler queue still sheds explicitly through the async
    path, and the shed results come back through the futures."""
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(
            g, slots=1, route="stepper",
            resilience=pkg.ResilienceConfig(max_queue=1))
        with pkg.gw.Gateway(sch, config=pkg.gw.GatewayConfig(
                cache_entries=0)) as gw:
            futs = [gw.submit(_seed(g, at=i), tol=0.0, max_iters=200)
                    for i in range(8)]
            res = [f.result(timeout=120) for f in futs]
        rejected = [r for r in res if r.error
                    and "admission queue full" in r.error]
        served = [r for r in res if r.error is None]
        assert len(rejected) + len(served) == 8
        assert sch.metrics.counters["rejected"] == len(rejected) > 0
        _audit_futures(sch, res)


def test_deadline_expiry_through_gateway(graphs):
    """Deadlines are absolute from gateway intake: a query stuck behind a
    long-running slot expires in the queue, explicitly."""
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=1, route="stepper")
        with pkg.gw.Gateway(sch, config=pkg.gw.GatewayConfig(
                cache_entries=0)) as gw:
            f_long = gw.submit(_seed(g, at=1), tol=0.0, max_iters=400)
            f_exp = gw.submit(_seed(g, at=2), tol=1e-6, max_iters=400,
                              deadline_s=1e-4)
            r_long = f_long.result(timeout=120)
            r_exp = f_exp.result(timeout=120)
        assert r_long.error is None
        assert r_exp.error is not None and "deadline" in r_exp.error
        assert sch.metrics.counters["expired"] == 1
        out[pkg] = [r_long, r_exp]
    _same(out[PORT], out[REF])


def test_priority_orders_backlog(graphs):
    """The device thread hands the whole backlog to the scheduler before
    admitting, so priorities submitted out of order still win."""
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=1, route="stepper")
        gw = pkg.gw.Gateway(sch, config=pkg.gw.GatewayConfig(
            cache_entries=0))
        try:
            # occupy the single slot so the rest queue behind it
            f0 = gw.submit(_seed(g, at=0), tol=0.0, max_iters=200)
            lo = gw.submit(_seed(g, at=1), tol=0.0, max_iters=20,
                           priority=0)
            hi = gw.submit(_seed(g, at=2), tol=0.0, max_iters=20,
                           priority=5)
            res = {id(f): f.result(timeout=120) for f in (f0, lo, hi)}
            tr_hi = sch.metrics.traces[res[id(hi)].uid]
            tr_lo = sch.metrics.traces[res[id(lo)].uid]
            assert tr_hi.t_admit <= tr_lo.t_admit
        finally:
            gw.close()


def test_concurrent_submit_storm_exactly_once(graphs):
    """Six submitter threads against one gateway: every future resolves
    exactly once, uids are unique, the stepper stays at one build, and
    the accounting audit holds."""
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=4)
        results, lock = [], threading.Lock()
        with pkg.gw.Gateway(sch, config=pkg.gw.GatewayConfig(
                cache_entries=0)) as gw:
            def storm(i):
                futs = []
                for j in range(15):
                    if (i + j) % 2:
                        futs.append(gw.submit(_seed(g, at=i * 7 + j),
                                              top_k=8, tol=1e-2,
                                              max_iters=300))
                    else:
                        futs.append(gw.submit(_seed(g, at=i * 5 + j),
                                              tol=1e-5, max_iters=300))
                got = [f.result(timeout=120) for f in futs]
                with lock:
                    results.extend(got)

            ts = [threading.Thread(target=storm, args=(i,))
                  for i in range(6)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in ts)
        assert len(results) == 90
        assert len({r.uid for r in results}) == 90
        assert all(r.error is None for r in results)
        assert sch.trace_count == 1
        assert sch.admit_trace_count == 1
        _audit_futures(sch, results)


def test_close_drains_and_rejects_after(graphs):
    for pkg in BOTH:
        sch = pkg.scheduler(graphs[pkg], slots=2)
        gw = pkg.gw.Gateway(sch)
        futs = [gw.submit(None, tol=1e-6, max_iters=200)
                for _ in range(4)]
        gw.close()                      # default drain=True
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError, match="closed"):
            gw.submit(None)


# ---------------------------------------------------------- result cache
def test_hit_is_bit_identical_and_o_k(graphs):
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=2)
        with pkg.gw.Gateway(sch) as gw:
            r1 = gw.submit(_seed(g), top_k=8, tol=1e-2).result(timeout=120)
            r2 = gw.submit(_seed(g), top_k=8, tol=1e-2).result(timeout=120)
        assert not r1.cached and r2.cached
        assert r2.uid != r1.uid                   # fresh uid + trace
        assert r2.top_ids is r1.top_ids           # the same arrays
        assert r2.top_scores is r1.top_scores
        assert sch.metrics.counters["cache_hits"] == 1
        assert sch.metrics.traces[r2.uid].t_done is not None
        assert gw.cache.hits == 1
        out[pkg] = [r1, r2]
    _same(out[PORT], out[REF])


def test_stepper_results_cache_too(graphs):
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=2, route="stepper")
        with pkg.gw.Gateway(sch) as gw:
            r1 = gw.submit(_seed(g), tol=1e-6).result(timeout=120)
            r2 = gw.submit(_seed(g), tol=1e-6).result(timeout=120)
        assert r2.cached and r2.ranks is r1.ranks
        out[pkg] = [r1, r2]
    _same(out[PORT], out[REF])


def test_unconverged_and_errored_not_cached(graphs):
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=1, route="stepper")
        with pkg.gw.Gateway(sch) as gw:
            # tol=0 runs the budget and never converges -> uncached
            r1 = gw.submit(_seed(g), tol=0.0, max_iters=8).result(timeout=120)
            r2 = gw.submit(_seed(g), tol=0.0, max_iters=8).result(timeout=120)
        assert not r1.converged and not r2.cached
        assert gw.cache.hits == 0 and len(gw.cache) == 0


def test_distinct_requests_miss(graphs):
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=2)
        with pkg.gw.Gateway(sch) as gw:
            r0 = gw.submit(_seed(g, at=3), top_k=8,
                           tol=1e-2).result(timeout=120)
            r = gw.submit(_seed(g, at=4), top_k=8,
                          tol=1e-2).result(timeout=120)
            r_tol = gw.submit(_seed(g, at=3), top_k=8,
                              tol=1e-3).result(timeout=120)
        assert not r.cached and not r_tol.cached
        out[pkg] = [r0, r, r_tol]
    _same(out[PORT], out[REF])


def test_delta_invalidates_atomically(graphs):
    """apply_delta through the gateway: entries keyed on the outgoing
    plan fingerprint drop, the same request re-solves on the new graph,
    and the push path answers against the new CSR."""
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        sch = pkg.scheduler(g, slots=2)
        d = _delta(pkg, g)
        with pkg.gw.Gateway(sch) as gw:
            r1 = gw.submit(_seed(g), top_k=8, tol=1e-3).result(timeout=120)
            dropped = gw.apply_delta(d).result(timeout=120)
            assert dropped >= 1
            r2 = gw.submit(_seed(g), top_k=8, tol=1e-3).result(timeout=120)
        assert not r2.cached                      # recomputed
        assert sch.rebind_count == 1
        assert sch.trace_count == 2               # one rebind build
        # a fresh scheduler on the post-delta graph agrees
        g_new = pkg.apply_edges(g, d)
        ref = pkg.scheduler(g_new, slots=2)
        u = ref.submit(_seed(g), top_k=8, tol=1e-3)
        ref.run_until_drained()
        r_ref = {r.uid: r for r in ref.completed}[u]
        assert list(r2.top_ids) == list(r_ref.top_ids)
        np.testing.assert_allclose(r2.top_scores, r_ref.top_scores,
                                   atol=1e-5)
        assert gw.cache.invalidated >= 1
        out[pkg] = [r1, r2]
    _same(out[PORT], out[REF])


def test_cache_unit_lru_and_fp_invalidation():
    seen = {}
    for pkg in BOTH:
        c = pkg.cache.ResultCache(capacity=2)
        c.put(("g", "fp1", "s1", 1e-3, 8, 100, "auto"), "a")
        c.put(("g", "fp1", "s2", 1e-3, 8, 100, "auto"), "b")
        got = [c.get(("g", "fp1", "s1", 1e-3, 8, 100, "auto"))]
        c.put(("g", "fp2", "s3", 1e-3, 8, 100, "auto"), "c")  # evicts s2
        got.append(c.get(("g", "fp1", "s2", 1e-3, 8, 100, "auto")))
        got.append(c.invalidate_fp("fp1"))
        got.append(c.get(("g", "fp1", "s1", 1e-3, 8, 100, "auto")))
        got.append(c.get(("g", "fp2", "s3", 1e-3, 8, 100, "auto")))
        assert got == ["a", None, 1, None, "c"]
        seen[pkg] = (got, c.hits, c.misses, c.evictions, c.invalidated,
                     len(c))
    assert seen[PORT] == seen[REF]


def test_seed_digest_stability(graphs):
    g = graphs[PORT]
    digests = {}
    for pkg in BOTH:
        sd = pkg.cache.seed_digest
        s = _seed(g)
        assert sd(s) == sd(s.copy())
        assert sd(s) != sd(_seed(g, at=4))
        assert sd(None) == "uniform"
        digests[pkg] = [sd(s), sd(_seed(g, at=4)), sd(s.astype(np.float64)),
                        sd(None), sd([0.25, 0.75])]
    assert digests[PORT] == digests[REF]


# --------------------------------------------------------------- autotune
def test_report_sane(graphs):
    for pkg in BOTH:
        eng = pkg.session(graphs[pkg], method="pcpm", part_size=64).engine
        rep = pkg.gw.autotune_slots(eng, chunk=4, target_chunk_s=10.0,
                                    candidates=(2, 4, 8), repeats=2)
        assert rep.chosen == 8            # everything under 10 s
        assert set(rep.probes) == {2, 4, 8}
        assert all(t > 0 for t in rep.probes.values())
        tight = pkg.gw.autotune_slots(eng, chunk=4, target_chunk_s=1e-12,
                                      candidates=(2, 4, 8), repeats=1)
        assert tight.chosen == 2          # nothing passes -> smallest
        assert len(tight.probes) == 1     # early stop after first miss
        assert set(rep.summary()) == {"target_chunk_s", "chunk", "chosen",
                                      "probes_ms"}


def test_autotune_probes_the_stepper_spmv_and_builds_no_stepper(graphs):
    """The port's probe calls ``engine.spmv_fn()`` — the closure the chunk
    stepper calls at width B — once to warm up and ``repeats`` times per
    candidate, on one (n, B) tensor each."""
    g = graphs[PORT]
    eng = PORT.session(g, method="pcpm", part_size=64).engine
    real = eng.spmv_fn()
    calls = []

    class Probe:
        backend, num_nodes, device = eng.backend, eng.num_nodes, eng.device

        def spmv_fn(self):
            def fn(x):
                calls.append((x.data_ptr(), tuple(x.shape)))
                return real(x)
            return fn

    rep = port_gateway.autotune_slots(Probe(), chunk=4, target_chunk_s=10.0,
                                      candidates=(2, 8), repeats=3)
    assert rep.chosen == 8
    assert [s for _, s in calls] == [(g.num_nodes, 2)] * 4 + [
        (g.num_nodes, 8)] * 4
    assert len({p for p, _ in calls[:4]}) == 1      # uploaded once


def test_non_multivector_backend_defaults():
    class FakeBackend:
        multi_vector = False

    class FakeEngine:
        backend = FakeBackend()

    for pkg in BOTH:
        rep = pkg.gw.autotune_slots(FakeEngine(), chunk=4, default=6)
        assert rep.chosen == 6 and rep.probes == {}


def test_session_gateway_wires_chosen_slots(graphs):
    out = {}
    for pkg in BOTH:
        sess = pkg.session(graphs[pkg], **SMALL, slots=2)
        cfg = pkg.gw.GatewayConfig(target_chunk_s=10.0,
                                   autotune_candidates=(2, 4, 8))
        with sess.gateway(config=cfg) as gw:
            assert gw.autotune_report is not None
            assert gw.autotune_report.chosen == 8
            sch = gw._schedulers["default"]
            assert sch.slots == 8
            r = gw.submit(None, tol=1e-6).result(timeout=120)
            assert gw.stats()["autotune"]["chosen"] == 8
        assert r.converged
        # explicit slots override beats autotune
        with sess.gateway(config=cfg, slots=3) as gw2:
            assert gw2.autotune_report is None
            assert gw2._schedulers["default"].slots == 3
        out[pkg] = [r]
    _same(out[PORT], out[REF])


# --------------------------------------------------------- weighted fair
def test_share_proportions():
    seqs = {}
    for pkg in BOTH:
        fair = pkg.gw.WeightedFair({"a": 3.0, "b": 1.0})
        seqs[pkg] = [fair.pick(["a", "b"]) for _ in range(400)]
        picks = collections.Counter(seqs[pkg])
        assert picks["a"] == 300 and picks["b"] == 100
    assert seqs[PORT] == seqs[REF]


def test_rejoin_without_banked_credit():
    seqs = {}
    for pkg in BOTH:
        fair = pkg.gw.WeightedFair({"a": 1.0, "b": 1.0})
        for _ in range(50):
            fair.pick(["a"])              # b idle throughout
        seqs[pkg] = [fair.pick(["a", "b"]) for _ in range(40)]
        # b rejoins at a's pass, not 50 turns in arrears
        assert collections.Counter(seqs[pkg])["b"] <= 21
    assert seqs[PORT] == seqs[REF]


def test_rejects_nonpositive_share():
    messages = {}
    for pkg in BOTH:
        with pytest.raises(ValueError, match="share") as err:
            pkg.gw.WeightedFair({"a": 0.0})
        with pytest.raises(ValueError, match="eligible"):
            pkg.gw.WeightedFair({"a": 1.0}).pick([])
        messages[pkg] = str(err.value)
    assert messages[PORT] == messages[REF]


# ---------------------------------------------------------- registry QoS
def test_weighted_drain_and_gateway(graphs):
    out = {}
    for pkg in BOTH:
        g = graphs[pkg]
        g2 = pkg.gen.rmat(8, 8, seed=2)
        reg = pkg.registry(slots=2)
        reg.add("one", g, share=2.0)
        reg.add("two", g2, share=1.0)
        reg.submit("one", _seed(g), tol=1e-5, max_iters=200)
        reg.submit("two", _seed(g2), tol=1e-5, max_iters=200)
        drained = reg.run_until_drained()
        assert len(drained["one"]) == 1 and len(drained["two"]) == 1
        assert all(r.converged for rs in drained.values() for r in rs)
        with reg.gateway() as gw:
            r1 = gw.submit(_seed(g), graph="one",
                           tol=1e-5).result(timeout=120)
            r2 = gw.submit(_seed(g2), graph="two",
                           tol=1e-5).result(timeout=120)
            with pytest.raises(ValueError, match="graph="):
                gw.submit(None)           # ambiguous without a name
            with pytest.raises(KeyError, match="unknown graph"):
                gw.submit(None, graph="three")
        assert r1.converged and r2.converged
        out[pkg] = [drained["one"][0], drained["two"][0], r1, r2]
    _same(out[PORT], out[REF])


def test_weighted_drain_interleaves_by_share(graphs):
    """The registry's drain steps graphs in ``WeightedFair`` order: with
    shares 2:1 and both busy, "one" gets two chunks to each of "two"'s —
    the pick sequence of the reference's drain, chunk for chunk."""
    order = {}
    for pkg in BOTH:
        g = graphs[pkg]
        reg = pkg.registry(slots=1, route="stepper")
        reg.add("one", g, share=2.0)
        reg.add("two", pkg.gen.rmat(8, 8, seed=2), share=1.0)
        for name in ("one", "two"):
            reg.submit(name, tol=0.0, max_iters=24)
        steps = []
        for name in ("one", "two"):
            sch = reg.get(name)
            real = sch.step
            sch.step = (lambda real=real, name=name:
                        (steps.append(name), real())[1])
        reg.run_until_drained()
        order[pkg] = steps
    assert order[PORT] == order[REF]
    assert order[PORT][:6] == ["one", "two", "one", "one", "two", "one"]


def test_budget_evicts_lru_idle_never_busy(graphs):
    for pkg in BOTH:
        g = graphs[pkg]
        g2 = pkg.gen.rmat(8, 8, seed=2)
        g3 = pkg.gen.rmat(8, 8, seed=3)
        probe = pkg.registry(slots=1)
        per = pkg.plan_nbytes(probe.add("probe", g).engine.plan)
        reg = pkg.registry(memory_budget_bytes=int(2.5 * per), slots=1)
        reg.add("a", g)
        reg.add("b", g2)
        # occupy 'a' with an in-flight query (admitted, not drained)
        reg.submit("a", _seed(g), tol=0.0, max_iters=400)
        reg.get("a").step()
        assert reg.get("a").active_slots == 1
        reg.add("c", g3)                  # over budget -> evict ONE
        assert reg.evictions == 1
        assert "b" not in reg             # LRU idle victim
        assert "a" in reg and "c" in reg  # busy + newest survive
        drained = reg.run_until_drained()  # in-flight query unharmed
        assert len(drained["a"]) == 1 and drained["a"][0].error is None


def test_budget_defers_when_all_busy(graphs):
    for pkg in BOTH:
        g = graphs[pkg]
        g2 = pkg.gen.rmat(8, 8, seed=2)
        probe = pkg.registry(slots=1)
        per = pkg.plan_nbytes(probe.add("probe", g).engine.plan)
        reg = pkg.registry(memory_budget_bytes=int(1.5 * per), slots=1)
        reg.add("a", g)
        reg.submit("a", _seed(g), tol=0.0, max_iters=400)
        reg.get("a").step()
        reg.add("b", g2)                  # over budget, 'a' is busy
        assert "a" in reg and "b" in reg  # deferred, not dropped
        assert reg.total_plan_bytes > reg.memory_budget_bytes
        assert reg.evictions == 0


def test_explicit_evict_refuses_busy(graphs):
    for pkg in BOTH:
        g = graphs[pkg]
        reg = pkg.registry(slots=1)
        reg.add("a", g)
        reg.submit("a", _seed(g), tol=0.0, max_iters=400)
        with pytest.raises(ValueError, match="drain"):
            reg.evict("a")
        reg.run_until_drained()
        reg.evict("a")
        assert "a" not in reg and reg.evictions == 1


# ------------------------------------------------------- failures stay loud
def test_device_thread_failure_fails_the_futures(graphs):
    """An exception on the device thread (here a control op's) does not
    strand anyone: a failing ``apply_delta`` resolves its future with the
    error and leaves the old plan serving, and a loop that dies fails
    every unresolved future and makes ``close`` raise."""
    g = graphs[PORT]
    sch = PORT.scheduler(g, slots=2, route="stepper")
    bad = GraphDelta.insert(np.array([[0, g.num_nodes + 1]], np.int32))
    gw = port_gateway.Gateway(sch)
    with pytest.raises(ValueError, match="out of range"):
        gw.apply_delta(bad).result(timeout=60)
    assert sch.rebind_count == 0
    assert gw.submit(None, tol=1e-6).result(timeout=60).converged

    def broken_step():
        raise RuntimeError("device lost")

    sch.step = broken_step
    fut = gw.submit(_seed(g), tol=1e-6, use_cache=False)
    with pytest.raises(RuntimeError, match="device lost"):
        fut.result(timeout=60)
    with pytest.raises(RuntimeError, match="device loop failed"):
        gw.close()


# ------------------------------------------- lazy device uploads, one each
def _counting_uploads(monkeypatch, delay_s=0.0, gate=None):
    """Count ``pack_blocked`` and ``tile_schedule`` calls (the lazy
    fills of a ``pcpm_pallas`` plan's runtime cache that build: the
    blocked streams of d > 1, the gather order of d = 1), each slowed by
    ``delay_s``; with ``gate`` = (layout, Event), the call for that
    layout (the blocked PNG or the PNG) waits for the event."""
    import repro_torch.kernels.pcpm_spmv as b1_pkg
    counts = collections.Counter()
    for name in ("pack_blocked", "tile_schedule"):
        real = getattr(b1_pkg, name)

        def counted(layout, *args, _real=real, _name=name, **kw):
            counts[_name] += 1
            if gate is not None and layout is gate[0]:
                assert gate[1].wait(timeout=60)
            time.sleep(delay_s)
            return _real(layout, *args, **kw)

        monkeypatch.setattr(b1_pkg, name, counted)
    return counts


def test_one_upload_per_plan_under_racing_threads(monkeypatch):
    """The gateway's device thread and two push workers reach a plan's
    first use together: each lazy fill runs once, and every thread gets
    the same closure over it."""
    from repro_torch.core import backends
    from repro_torch.core.plan import release_device
    g = generators.rmat(7, 8, seed=61)             # fresh to this test
    sch = SlotScheduler(g, method="pcpm_pallas", part_size=64, chunk=4,
                        slots=2, push_mode="device", device="cpu")
    plan = sch.engine.plan
    release_device(plan)                           # a fresh first use
    counts = _counting_uploads(monkeypatch, delay_s=0.05)
    barrier = threading.Barrier(3)
    fns = []
    x = torch.ones((g.num_nodes, 2))

    def first_use():
        barrier.wait(timeout=60)
        fn = backends.spmv_fn(plan, sch.device)
        fn(x)                                      # d > 1: the blocked fill
        fns.append(fn)

    ts = [threading.Thread(target=first_use) for _ in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert counts == {"pack_blocked": 1, "tile_schedule": 1}
    assert len(fns) == 3 and fns[0] is fns[1] is fns[2]
    # through the gateway: two push workers and the stepper on a plan
    # whose uploads were released
    release_device(plan)
    counts.clear()
    cfg = port_gateway.GatewayConfig(push_workers=2, cache_entries=0)
    with port_gateway.Gateway(sch, config=cfg) as gw:
        futs = [gw.submit(_seed(g, at=i), top_k=5, tol=1e-2)
                for i in range(4)]
        futs.append(gw.submit(None, tol=1e-6))
        res = [f.result(timeout=120) for f in futs]
    assert all(r.converged and r.error is None for r in res)
    assert sch.metrics.counters["push_served"] == 4
    assert counts == {"pack_blocked": 1, "tile_schedule": 1}


def test_upload_lock_does_not_deadlock_a_rebind(monkeypatch):
    """A push stuck in the old plan's first upload (holding the plan's
    lock) blocks neither the stepper nor a rebind that takes the
    scheduler's ``_step_lock``: the rebind commits, its release of the
    old plan's uploads waits for the push's upload to finish, and
    everything completes."""
    from repro_torch.core.plan import release_device
    g = generators.rmat(7, 8, seed=62)             # fresh to this test
    sch = SlotScheduler(g, method="pcpm_pallas", part_size=64, chunk=4,
                        slots=2, push_mode="device", device="cpu")
    old = sch.engine.plan
    # the stepper's closure makes its d > 1 layout at its first chunk
    sch.submit(None, tol=1e-6, route="stepper")
    sch.run_until_drained()
    release_device(old)
    go = threading.Event()
    counts = _counting_uploads(monkeypatch, gate=(old.png, go))
    pushed = []
    push = threading.Thread(target=lambda: pushed.append(sch.submit(
        _seed(g), top_k=5, tol=1e-2)))
    push.start()
    deadline = time.monotonic() + 60
    while counts["tile_schedule"] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert counts["tile_schedule"] == 1 and not go.is_set()
    # the stepper runs on its own closure while the upload waits
    u_step = sch.submit(None, tol=1e-6, route="stepper")
    stepper = threading.Thread(target=sch.run_until_drained)
    stepper.start()
    stepper.join(timeout=60)
    assert not stepper.is_alive()
    # the rebind commits under _step_lock and _lock, then waits for the
    # old plan's lock to release its uploads
    rebind = threading.Thread(target=sch.apply_delta,
                              args=(_delta(PORT, g, rng_seed=3),))
    rebind.start()
    while sch.rebind_count < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sch.rebind_count == 1 and rebind.is_alive()
    assert sch._step_lock.acquire(timeout=10)      # released after commit
    sch._step_lock.release()
    go.set()
    for t in (push, rebind):
        t.join(timeout=60)
    assert not push.is_alive() and not rebind.is_alive()
    assert old._device == {}                       # released after it
    done = {r.uid: r for r in sch.completed}
    assert done[pushed[0]].converged and done[u_step].converged
    u = sch.submit(_seed(g, at=5), tol=1e-6, route="stepper")
    sch.run_until_drained()
    assert {r.uid: r for r in sch.completed}[u].converged
