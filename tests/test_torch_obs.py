"""Port vs reference: the observability layer on CPU tensors.

Every case of the JAX package's ``tests/test_obs.py`` runs here on the
port and on the reference, side by side on the same inputs — the metrics
registry (Prometheus text byte for byte), the tracer and flight recorder
(record names, parents, statuses, attributes, the JSONL header), comm
accounting (``measure_plan`` and ``vs_model`` dicts exactly equal for
pcpm, pdpr and bvgas; ``pcpm_pallas`` refused by both), ``ServeMetrics``
reconciliation, plan events, ``Session.observe`` and the observed storms
— except the qps-overhead bound, a timing test, which runs on the card
(``tests/test_torch_cuda.py``). The trace-format parity case drives one
fixed query sequence through both packages' schedulers on a fake clock
and compares their JSONL dumps record for record.

The port's own spans (``obs.PORT_SPANS``: a solve's stages, host
preprocessing's stages, device layouts, kernel loads), which the
reference lacks, are taken out of the port's records where the two are
compared, and checked on the port alone (``test_port_spans_*``).
"""
import importlib
import json
import threading
import weakref
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro_torch import obs as port_obs
from repro_torch.core import plan as port_plan
from repro_torch.graphs import generators
from repro_torch.obs import comm as port_comm
from repro_torch.reliability import (FaultInjector, FaultPlan, FaultSpec,
                                     ResilienceConfig)
from repro_torch.reliability import snapshot as port_snapshot
from repro_torch.serve import SlotScheduler
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.stream import GraphDelta

from test_torch_reference import load_reference

ref_stream = load_reference("stream")
ref_obs = load_reference("obs")
ref_comm = load_reference("obs.comm")
ref_plan = load_reference("core.plan")
ref_gen = load_reference("graphs.generators")
ref_rel = load_reference("reliability")
ref_snapshot = load_reference("reliability.snapshot")
ref_serve = load_reference("serve")
ref_metrics = load_reference("serve.metrics")
ref_api = load_reference("api")

SMALL = dict(method="pcpm", part_size=64, chunk=4)


class Pkg:
    """One package's names, so each case's body runs on both."""

    def __init__(self, port: bool):
        if port:
            self.obs, self.comm, self.plan = port_obs, port_comm, port_plan
            self.gen, self.snapshot = generators, port_snapshot
            self.SlotScheduler, self.ServeMetrics = SlotScheduler, ServeMetrics
            self.FaultInjector, self.FaultPlan, self.FaultSpec = (
                FaultInjector, FaultPlan, FaultSpec)
            self.ResilienceConfig, self.GraphDelta = (ResilienceConfig,
                                                      GraphDelta)
            self.open, self.EngineConfig = (repro_torch.open,
                                            repro_torch.EngineConfig)
            self.cpu = dict(device="cpu")
        else:
            self.obs, self.comm, self.plan = ref_obs, ref_comm, ref_plan
            self.gen, self.snapshot = ref_gen, ref_snapshot
            self.SlotScheduler = ref_serve.SlotScheduler
            self.ServeMetrics = ref_metrics.ServeMetrics
            self.FaultInjector, self.FaultPlan, self.FaultSpec = (
                ref_rel.FaultInjector, ref_rel.FaultPlan, ref_rel.FaultSpec)
            self.ResilienceConfig = ref_rel.ResilienceConfig
            self.GraphDelta = ref_stream.GraphDelta
            self.open, self.EngineConfig = ref_api.open, ref_api.EngineConfig
            self.cpu = {}

    def scheduler(self, g, **kw):
        return self.SlotScheduler(g, **{**SMALL, **self.cpu, **kw})

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
    s[at % g.num_nodes] = 1.0
    s[(at * 7 + 1) % g.num_nodes] = 1.0
    return s


def _reference_records(pkg, recs):
    """The records of the reference's schema: the port's own spans
    (``obs.PORT_SPANS``, which ``test_port_spans_*`` check) taken out of
    the port's records; the reference's are all kept."""
    if pkg is not PORT:
        return recs
    return [r for r in recs if r.name not in port_obs.PORT_SPANS]


def _shape(recs):
    """Records with their ids and times taken out: (name, the index of
    the parent's record or None, trace label, status, attribute keys)."""
    index = {r.span_id: i for i, r in enumerate(recs)}
    traces = {}
    out = []
    for r in recs:
        trace = (r.trace if isinstance(r.trace, str) or r.trace is None
                 else traces.setdefault(r.trace, f"uid{len(traces)}"))
        parent = (None if r.parent_id is None
                  else index.get(r.parent_id, "open"))
        out.append((r.name, parent, trace, r.status,
                    tuple(sorted(r.attrs))))
    return out


# ------------------------------------------------------- metrics registry
def test_counter_monotone():
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        c = reg.counter("x_total", "help", kind="a")
        c.inc()
        c.inc(3)
        assert reg.counter_value("x_total", kind="a") == 4
        with pytest.raises(ValueError, match="monotone"):
            c.inc(-1)
        assert c.value == 4


def test_labels_are_order_insensitive():
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        reg.counter("t", a="1", b="2").inc()
        reg.counter("t", b="2", a="1").inc()
        assert reg.counter_value("t", a="1", b="2") == 2
        assert len(reg.family_items("t")) == 1


def test_kind_conflict_raises():
    messages = []
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered") as err:
            reg.gauge("x")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_unknown_reads_as_zero():
    for pkg in BOTH:
        assert pkg.obs.MetricsRegistry().counter_value("nope") == 0.0
        assert pkg.obs.MetricsRegistry().family_items("nope") == []


def test_gauge_levels():
    for pkg in BOTH:
        ga = pkg.obs.MetricsRegistry().gauge("depth")
        ga.set(5)
        ga.inc()
        ga.dec(3)
        assert ga.value == 3


def test_histogram_le_inclusive_exact():
    """A value equal to an upper bound lands in that bucket (Prometheus
    ``le``) and exposed counts are cumulative."""
    snaps = []
    for pkg in BOTH:
        h = pkg.obs.MetricsRegistry().histogram("lat",
                                                buckets=(0.1, 1.0, 10.0))
        for v in (0.1, 0.1, 0.5, 1.0, 7.0, 11.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["buckets"] == [(0.1, 2), (1.0, 4), (10.0, 5),
                                   ("+Inf", 6)]
        assert snap["count"] == 6
        assert snap["sum"] == pytest.approx(19.7)
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_histogram_rejects_unsorted_bounds():
    for pkg in BOTH:
        with pytest.raises(ValueError, match="ascending"):
            pkg.obs.MetricsRegistry().histogram("h", buckets=(1.0, 0.5))


def test_prometheus_text_exact():
    texts = []
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        reg.counter("ev_total", "events", event="a").inc(2)
        reg.gauge("depth", "queue depth").set(3)
        h = reg.histogram("lat_seconds", "latency", buckets=(0.5, 2.0))
        h.observe(0.5)
        h.observe(1.0)
        text = reg.prometheus_text()
        assert "# HELP ev_total events\n# TYPE ev_total counter\n" \
               'ev_total{event="a"} 2\n' in text
        assert "depth 3\n" in text
        assert 'lat_seconds_bucket{le="0.5"} 1' in text
        assert 'lat_seconds_bucket{le="2"} 2' in text
        assert 'lat_seconds_bucket{le="+Inf"} 2' in text
        assert "lat_seconds_sum 1.5" in text
        assert "lat_seconds_count 2" in text
        texts.append((text, json.dumps(reg.to_json(), sort_keys=True)))
    assert texts[0] == texts[1]


def test_render_merges_with_extra_labels():
    texts = []
    for pkg in BOTH:
        r1, r2 = pkg.obs.MetricsRegistry(), pkg.obs.MetricsRegistry()
        r1.counter("q_total").inc(1)
        r2.counter("q_total").inc(5)
        text = pkg.obs.render_prometheus([(r1, {"graph": "a"}),
                                          (r2, {"graph": "b"}),
                                          (r1, {"graph": "dup"})])
        assert 'q_total{graph="a"} 1' in text
        assert 'q_total{graph="b"} 5' in text
        assert "dup" not in text
        texts.append(text)
    assert texts[0] == texts[1]


def test_label_escaping():
    texts = []
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        reg.counter("e_total", event='say "hi"\n').inc()
        text = reg.prometheus_text()
        assert r'event="say \"hi\"\n"' in text
        texts.append(text)
    assert texts[0] == texts[1]


# -------------------------------------------------- tracer, flight recorder
def test_explicit_parent_nesting():
    shapes = []
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(16))
        root = tr.start("query", trace=7)
        child = root.child("slot", slot=2)
        child.end(iterations=5)
        root.end()
        recs = tr.recorder.snapshot()
        assert [r.name for r in recs] == ["slot", "query"]  # end order
        slot, query = recs
        assert slot.parent_id == query.span_id
        assert slot.trace == query.trace == 7
        assert slot.attrs == {"slot": 2, "iterations": 5}
        assert query.t_start <= slot.t_start <= slot.t_end <= query.t_end
        shapes.append(_shape(recs))
    assert shapes[0] == shapes[1]


def test_end_exactly_once():
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(16))
        sp = tr.start("x")
        sp.end()
        sp.end()
        sp.end(status="error")
        assert len(tr.recorder) == 1
        assert tr.double_ends == 2
        assert sp.ended


def test_ring_bounded_with_drop_accounting():
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(4))
        for i in range(10):
            tr.event("e", i=i)
        recs = tr.recorder.snapshot()
        assert len(recs) == 4
        assert [r.attrs["i"] for r in recs] == [6, 7, 8, 9]  # oldest out
        assert tr.recorder.recorded == 10
        assert tr.recorder.dropped == 6
        with pytest.raises(ValueError, match="capacity"):
            pkg.obs.FlightRecorder(0)


def test_span_contextmanager_error_status():
    attrs = []
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(16))
        with pytest.raises(RuntimeError):
            with tr.span("risky"):
                raise RuntimeError("boom")
        (rec,) = tr.recorder.snapshot()
        assert rec.status == "error"
        assert "boom" in rec.attrs["error"]
        attrs.append(rec.attrs)
    assert attrs[0] == attrs[1]


def test_jsonl_dump_format(tmp_path):
    dumps = []
    for pkg in BOTH:
        clock = iter(float(t) for t in range(100)).__next__
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(8), clock=clock)
        tr.event("a", k=1)
        with tr.span("b", trace=3):
            pass
        path = tr.recorder.dump(str(tmp_path / "f.jsonl"))
        lines = open(path).read().splitlines()
        header = json.loads(lines[0])
        assert header == {"schema": 1, "recorded": 2, "dropped": 0,
                          "capacity": 8, "held": 2}
        rows = [json.loads(ln) for ln in lines[1:]]
        assert [r["name"] for r in rows] == ["a", "b"]
        assert rows[0]["t0"] == rows[0]["t1"]          # event
        assert rows[1]["trace"] == 3
        assert set(rows[0]) == {"name", "span", "parent", "trace",
                                "t0", "t1", "status", "attrs"}
        for r in rows:
            r.pop("span")
        dumps.append((header, rows))
    assert dumps[0] == dumps[1]
    assert port_obs.TRACE_SCHEMA_VERSION == ref_obs.TRACE_SCHEMA_VERSION


def test_query_spans_retry_and_terminal():
    shapes = []
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(32))
        qs = pkg.obs.QuerySpans(tr, tr.start("query"))
        qs.bind(42)
        qs.start_child("slot", slot=0)
        qs.start_child("slot", slot=1)     # re-admit: closes the first
        qs.finish(iterations=9)
        recs = tr.recorder.snapshot()
        by = {}
        for r in recs:
            by.setdefault(r.name, []).append(r)
        assert [r.status for r in by["slot"]] == ["retry", "ok"]
        assert len(by["terminal"]) == 1
        assert all(r.trace == 42 for r in recs)
        assert by["query"][0].status == "ok"           # root recorded
        assert qs.terminals == 1
        shapes.append(_shape(recs))
    assert shapes[0] == shapes[1]


def test_gateway_owned_root_ends_at_resolve():
    shapes = []
    for pkg in BOTH:
        tr = pkg.obs.Tracer(pkg.obs.FlightRecorder(32))
        qs = pkg.obs.QuerySpans(tr, tr.start("query"), gateway_owned=True)
        qs.bind(1)
        qs.finish()                        # terminal, root still open
        assert "query" not in {r.name for r in tr.recorder.snapshot()}
        qs.resolve()
        names = [r.name for r in tr.recorder.snapshot()]
        assert names.count("query") == 1 and "resolve" in names
        qs.resolve()                       # idempotent
        assert [r.name for r in tr.recorder.snapshot()
                ].count("query") == 1
        shapes.append(_shape(tr.recorder.snapshot()))
    assert shapes[0] == shapes[1]


# ----------------------------------------------------------- comm accounting
def test_pcpm_measured_within_2x_of_model():
    """Acceptance bound: at scale 16 the DRAM-stream bytes measured off
    the real plan geometry land within 2x of eq. 5, and the measurement
    and the comparison are the reference's, key for key."""
    dicts = []
    for pkg in BOTH:
        g = pkg.gen.rmat(16, 16, seed=3)
        plan = pkg.plan.build_plan(g, pkg.plan.PlanConfig(method="pcpm",
                                                          part_size=4096))
        cmp_ = pkg.comm.vs_model(plan)
        assert cmp_["method"] == "pcpm"
        assert 0.5 <= cmp_["ratio"] <= 2.0, cmp_
        meas = pkg.comm.measure_plan(plan)
        assert sum(meas.dram.values()) == meas.dram_bytes
        assert meas.dram_bytes == cmp_["measured_bytes_per_iter"]
        dicts.append((cmp_, meas.to_dict()))
    assert dicts[0] == dicts[1]


@pytest.mark.parametrize("method", ["pcpm", "pdpr", "bvgas"])
def test_all_methods_measurable(method):
    dicts = []
    for pkg in BOTH:
        g = pkg.gen.rmat(10, 8, seed=2)
        plan = pkg.plan.build_plan(g, pkg.plan.PlanConfig(method=method,
                                                          part_size=256))
        cmp_ = pkg.comm.vs_model(plan, ncols=4)
        assert cmp_["measured_bytes_per_iter"] > 0
        assert cmp_["model_bytes_per_iter"] > 0
        assert np.isfinite(cmp_["ratio"])
        dicts.append((cmp_, pkg.comm.measure_plan(plan, ncols=4).to_dict(),
                      pkg.comm.model_params(plan)))
    assert dicts[0][:2] == dicts[1][:2]
    assert dicts[0][2].__dict__ == dicts[1][2].__dict__


def test_pcpm_pallas_is_not_measured():
    """Neither package accounts a ``pcpm_pallas`` plan: ``measure_plan``
    refuses it with the same message and the accountant skips it."""
    messages = []
    for pkg in BOTH:
        g = pkg.gen.rmat(8, 8, seed=1)
        plan = pkg.plan.build_plan(g, pkg.plan.PlanConfig(
            method="pcpm_pallas", part_size=64))
        with pytest.raises(ValueError, match="cannot measure") as err:
            pkg.comm.measure_plan(plan)
        messages.append(str(err.value))
        reg = pkg.obs.MetricsRegistry()
        acc = pkg.comm.CommAccountant(registry=reg)
        acc.record_solve(plan, 10)
        assert acc.summary() == {}
        assert reg.counter_value("comm_passes_total",
                                 method="pcpm_pallas") == 0
    assert messages[0] == messages[1]


def test_multi_vector_amortizes_index_streams():
    """ncols multiplies only the value streams; the index streams are
    read once per pass, so bytes per column strictly decrease."""
    sizes = []
    for pkg in BOTH:
        g = pkg.gen.rmat(10, 8, seed=2)
        plan = pkg.plan.build_plan(g, pkg.plan.PlanConfig(method="pcpm",
                                                          part_size=256))
        b1 = pkg.comm.measure_plan(plan, ncols=1).dram_bytes
        b8 = pkg.comm.measure_plan(plan, ncols=8).dram_bytes
        assert b1 < b8 < 8 * b1
        sizes.append((b1, b8))
    assert sizes[0] == sizes[1]


def test_accountant_accumulates_and_skips_empty(graphs):
    summaries = []
    for pkg in BOTH:
        plan = pkg.plan.build_plan(graphs[pkg], pkg.plan.PlanConfig(
            method="pcpm", part_size=64))
        reg = pkg.obs.MetricsRegistry()
        acc = pkg.comm.CommAccountant(registry=reg)
        acc.record_pass(plan, iters=0)          # no-op
        acc.record_solve(plan, 10)
        acc.record_pass(plan, iters=5)
        s = acc.summary()["pcpm"]
        assert s["passes"] == 15
        assert s["dram_bytes"] == 15 * s["bytes_per_pass"]
        assert s["ratio_vs_model"] == pytest.approx(
            s["dram_bytes"] / s["model_dram_bytes"])
        assert reg.counter_value("comm_passes_total", method="pcpm") == 15
        summaries.append((acc.summary(), reg.prometheus_text()))
    assert summaries[0] == summaries[1]


# --------------------------------------------- ServeMetrics reconciliation
def test_duplicate_terminal_raises():
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        m.submitted(1)
        m.completed(1, iterations=3, converged=True)
        with pytest.raises(RuntimeError, match="duplicate terminal"):
            m.completed(1, iterations=3, converged=True)


def test_counters_is_derived_view():
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        m.incr("rejected", 2)
        assert m.counters["rejected"] == 2
        assert m.counters["never_bumped"] == 0
        assert m.registry.counter_value("serve_events_total",
                                        event="rejected") == 2


def test_reconcile_catches_drift():
    """A counter bumped without its terminal must be named by
    ``reconcile()``."""
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        m.submitted(1)
        m.incr("rejected")
        m.completed(1, iterations=0, converged=False,
                    error="rejected: queue full")
        m.reconcile()                       # consistent: passes
        m.incr("rejected")                  # drift: counter w/o trace
        with pytest.raises(AssertionError, match="rejected"):
            m.reconcile()


def test_reconcile_routes():
    outs = []
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        for uid, route, ev in ((1, "push", "push_served"),
                               (2, "cached", "cache_hits")):
            m.submitted(uid)
            m.incr(ev)
            m.completed(uid, iterations=1, converged=True, route=route)
        out = m.reconcile()
        assert out["push_served"] == 1 and out["cache_hits_served"] == 1
        outs.append(out)
    assert outs[0] == outs[1]


# ------------------------------------------------ plan events, observing
def test_build_and_cache_hit_events(graphs):
    names = []
    for pkg in BOTH:
        pkg.plan.clear_plan_cache()
        obs = pkg.obs.Observability(capacity=64)
        try:
            cfg = pkg.plan.PlanConfig(method="pcpm", part_size=64)
            pkg.plan.build_plan(graphs[pkg], cfg)
            pkg.plan.build_plan(graphs[pkg], cfg)    # cache hit
            recs = obs.recorder.snapshot()
            assert "plan_build" in {r.name for r in recs}
            assert "plan_cache_hit" in {r.name for r in recs}
            assert obs.registry.counter_value(
                "plan_events_total", event="plan_build") == 1
            assert obs.registry.counter_value(
                "plan_events_total", event="plan_cache_hit") == 1
            names.append(_shape(_reference_records(pkg, recs)))
        finally:
            obs.close()
    assert names[0] == names[1]


def test_closed_bundle_detaches(graphs):
    for pkg in BOTH:
        pkg.plan.clear_plan_cache()
        obs = pkg.obs.Observability(capacity=64)
        obs.close()
        pkg.plan.build_plan(graphs[pkg], pkg.plan.PlanConfig(
            method="pcpm", part_size=64))
        assert "plan_build" not in {r.name
                                    for r in obs.recorder.snapshot()}


def test_observer_errors_are_swallowed_and_only_those(graphs):
    """A failing observer never fails a build (the one place errors are
    swallowed); a failing build still raises through the observers."""
    class Broken:
        def plan_event(self, name, **attrs):
            raise RuntimeError("observer down")

    for pkg in BOTH:
        pkg.plan.clear_plan_cache()
        broken = Broken()
        pkg.plan.add_plan_observer(broken)
        try:
            plan = pkg.plan.build_plan(graphs[pkg], pkg.plan.PlanConfig(
                method="pcpm", part_size=64))
            assert plan.num_nodes == graphs[pkg].num_nodes
            with pytest.raises(ValueError, match="unknown method"):
                pkg.plan.build_plan(graphs[pkg], pkg.plan.PlanConfig(
                    method="nope", part_size=64))
        finally:
            pkg.plan.remove_plan_observer(broken)


def test_patch_emits_plan_patch_event(graphs):
    shapes = []
    for pkg in BOTH:
        g = graphs[pkg]
        sess = pkg.session(g, **SMALL, observe=True)
        rng = np.random.default_rng(0)
        delta = pkg.GraphDelta.insert(
            np.stack([rng.integers(0, g.num_nodes, 8),
                      rng.integers(0, g.num_nodes, 8)], axis=1))
        n0 = len(sess.obs.recorder)
        sess.apply_delta(delta)
        recs = sess.obs.recorder.snapshot()
        names = [r.name for r in recs]
        assert "plan_patch" in names and "session_delta" in names
        shapes.append(_shape(_reference_records(pkg, recs[n0:])))
        sess.obs.close()
    assert shapes[0] == shapes[1]


def test_observe_idempotent_and_stats(graphs):
    stats = []
    for pkg in BOTH:
        sess = pkg.session(graphs[pkg], **SMALL)
        assert sess.obs is None
        obs = sess.observe()
        assert sess.observe() is obs
        res = sess.pagerank(num_iterations=5)
        st = sess.stats()
        assert st["plan_cache"]["plan_builds"] >= 1
        assert st["obs"]["comm"]["pcpm"]["passes"] == res.iterations
        assert st["obs"]["flight_recorder"]["recorded"] >= 1
        assert "solve" in [r.name for r in obs.recorder.snapshot()]
        stats.append(st["obs"]["comm"])
        obs.close()
    assert stats[0] == stats[1]


def test_config_observe_traces_build_and_solve():
    for pkg in BOTH:
        pkg.plan.clear_plan_cache()
        g2 = pkg.gen.rmat(8, 8, seed=9)
        sess = pkg.session(g2, **SMALL, observe=True)
        sess.pagerank(num_iterations=3)
        names = [r.name for r in sess.obs.recorder.snapshot()]
        # the bundle attaches before the plan builds, so the session's
        # own preprocessing is on the record
        assert "plan_build" in names and "solve" in names
        sess.obs.close()


def test_crash_dump_on_quarantine(graphs, tmp_path):
    """A poisoned slot that exhausts its retries leaves a flight-recorder
    file behind."""
    for pkg in BOTH:
        where = tmp_path / ("port" if pkg is PORT else "ref")
        obs = pkg.obs.Observability(capacity=256, dump_dir=str(where))
        try:
            inj = pkg.FaultInjector(pkg.FaultPlan.of(
                [pkg.FaultSpec("nan_slot", step=2, slot=0)]))
            sch = pkg.scheduler(
                graphs[pkg], slots=1, fault_injector=inj, obs=obs,
                resilience=pkg.ResilienceConfig(max_retries=0))
            sch.submit(_seed(graphs[pkg]), tol=1e-6, max_iters=300)
            sch.run_until_drained()
            assert sch.metrics.counters["quarantined"] == 1
            dumps = list(where.glob("flight-*.jsonl"))
            assert len(dumps) == 1
            lines = dumps[0].read_text().splitlines()
            assert json.loads(lines[0])["schema"] == 1
            assert any(json.loads(ln)["name"] == "crash_dump"
                       for ln in lines[1:])
            assert obs.registry.counter_value("crash_dumps_total") == 1
        finally:
            obs.close()


def test_snapshot_parks_trace_beside_state(graphs, tmp_path):
    for pkg in BOTH:
        obs = pkg.obs.Observability(capacity=256)
        try:
            sch = pkg.scheduler(graphs[pkg], slots=1, obs=obs)
            sch.submit(_seed(graphs[pkg]), tol=1e-6, max_iters=300)
            sch.step()
            path = str(tmp_path / f"state-{pkg is PORT}.npz")
            pkg.snapshot.snapshot_scheduler(sch, path)
            trace = tmp_path / f"state-{pkg is PORT}.npz.trace.jsonl"
            assert trace.exists()
            rows = [json.loads(ln)
                    for ln in trace.read_text().splitlines()[1:]]
            snap = [r for r in rows if r["name"] == "snapshot"]
            assert len(snap) == 1
            assert snap[0]["attrs"]["in_flight"] == 1
            assert snap[0]["attrs"]["queued"] == 0
        finally:
            obs.close()


# ------------------------------------------------------- the observed storm
def _storm(sch, *, threads=6, per=20):
    """Mixed push/stepper storm against a free-running device thread.
    Returns the uids."""
    uids, lock, done = [], threading.Lock(), threading.Event()
    errors = []
    g = sch.g

    def submitter(i):
        mine = []
        for j in range(per):
            if (i + j) % 2:
                mine.append(sch.submit(_seed(g, at=i * 7 + j), top_k=8,
                                       tol=1e-2, max_iters=300))
            else:
                mine.append(sch.submit(_seed(g, at=i * 5 + j), tol=1e-5,
                                       max_iters=300))
        with lock:
            uids.extend(mine)

    def device_loop():
        try:
            while not done.is_set() or sch.queued or sch.active_slots:
                sch.step()
        except Exception as exc:   # noqa: BLE001
            errors.append(exc)

    dev = threading.Thread(target=device_loop)
    dev.start()
    ts = [threading.Thread(target=submitter, args=(i,))
          for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    done.set()
    dev.join(timeout=300)
    assert not dev.is_alive() and not errors
    assert not any(t.is_alive() for t in ts)
    return uids


def test_storm_span_trees_complete_and_well_nested(graphs):
    """Every query in a concurrent mixed storm gets a complete span tree:
    one root, exactly one terminal event, every child closed and nested
    inside the root interval — and the stepper built once."""
    for pkg in BOTH:
        obs = pkg.obs.Observability(capacity=65536)
        try:
            sch = pkg.scheduler(graphs[pkg], slots=4, obs=obs)
            uids = _storm(sch)
            assert len(uids) == 120
            sch.metrics.reconcile()
            by_trace = {}
            for r in obs.recorder.snapshot():
                by_trace.setdefault(r.trace, []).append(r)
            assert obs.recorder.dropped == 0
            for uid in uids:
                recs = by_trace[uid]
                roots = [r for r in recs if r.name == "query"]
                terms = [r for r in recs if r.name == "terminal"]
                assert len(roots) == 1, (uid, [r.name for r in recs])
                assert len(terms) == 1, (uid, [r.name for r in recs])
                root = roots[0]
                for r in recs:
                    if r.span_id == root.span_id:
                        continue
                    assert root.t_start <= r.t_start
                    assert r.t_end <= root.t_end, (uid, r.name)
                    assert r.parent_id is not None
                names = {r.name for r in recs}
                assert ("push" in names) != ("slot" in names), names
            assert sch.trace_count == 1
            assert sch.admit_trace_count == 1
        finally:
            obs.close()


def test_gateway_roots_cover_resolution(graphs):
    """Gateway-owned roots end at future resolution: every uid's root
    contains its terminal event, and the three routes (stepper, cache,
    push) each leave exactly one terminal."""
    shapes = []
    for pkg in BOTH:
        sess = pkg.session(graphs[pkg], **SMALL, observe=True)
        obs = sess.obs
        gw = sess.gateway(autotune=False, slots=2)
        with gw:
            r1 = gw.submit(tol=1e-3, max_iters=300, top_k=5).result(
                timeout=120)
            r2 = gw.submit(tol=1e-3, max_iters=300, top_k=5).result(
                timeout=120)                                  # cached
            r3 = gw.submit(_seed(graphs[pkg]), tol=1e-2, max_iters=300,
                           top_k=5).result(timeout=120)       # push
        assert r1.converged and r2.error is None and r3.error is None
        assert r2.cached
        by = {}
        for r in obs.recorder.snapshot():
            by.setdefault(r.trace, []).append(r)
        for uid in (r1.uid, r2.uid, r3.uid):
            recs = by[uid]
            roots = [r for r in recs if r.name == "query"]
            terms = [r for r in recs if r.name == "terminal"]
            resolves = [r for r in recs if r.name == "resolve"]
            assert len(roots) == len(terms) == len(resolves) == 1
            assert roots[0].t_start <= terms[0].t_start <= roots[0].t_end
        sch = next(iter(gw._schedulers.values()))
        rec = sch.metrics.reconcile()
        assert rec["cache_hits_served"] == 1
        assert rec["push_served"] == 1
        shapes.append(sorted((r.name, r.status, tuple(sorted(r.attrs)))
                             for uid in (r1.uid, r2.uid, r3.uid)
                             for r in by[uid]))
        obs.close()
    assert shapes[0] == shapes[1]


def test_metrics_endpoint_scrape(graphs):
    texts = []
    for pkg in BOTH:
        sess = pkg.session(graphs[pkg], **SMALL, observe=True)
        gw = sess.gateway(autotune=False, slots=2)
        with gw:
            gw.submit(tol=1e-3, max_iters=300, top_k=5).result(timeout=120)
            text = gw.metrics_endpoint()
        assert "# TYPE serve_terminals_total counter" in text
        assert 'serve_terminals_total{graph="default"} 1' in text
        assert "gateway_cache_entries" in text
        assert "comm_passes_total" in text      # obs registry merged
        assert "trace_count" in text
        # the families and label sets are the reference's (the values
        # of timing histograms and byte counters are each run's own)
        texts.append(sorted({ln.split(" ")[0] for ln in text.splitlines()
                             if ln and not ln.startswith("#")}))
        sess.obs.close()
    assert texts[0] == texts[1]


# ------------------------------------------------------ the port's own spans
def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def _children(recs, parent):
    return sorted((r for r in recs if r.parent_id == parent.span_id),
                  key=lambda r: r.t_start)


def _observed_solve(method, seed):
    """A fresh graph's observed session (its plan built, not found) and
    one 4-iteration solve; returns the session and its records."""
    port_plan.clear_plan_cache()
    g = generators.rmat(8, 8, seed=seed)
    sess = repro_torch.open(g, repro_torch.EngineConfig(
        method=method, part_size=64, observe=True), device="cpu")
    sess.pagerank(num_iterations=4)
    return sess, sess.obs.recorder.snapshot()


@pytest.mark.parametrize("method,path", [("pcpm_pallas", "tile"),
                                         ("pcpm", None)])
def test_port_spans_of_a_solve_nest_in_order(method, path):
    sess, recs = _observed_solve(method, seed=31)
    try:
        solve, = _by_name(recs, "solve")
        assert solve.attrs["b1_path"] == path
        kids = _children(recs, solve)
        assert [r.name for r in kids] == ["solve_start", "solve_launch",
                                          "solve_readback"]
        assert all(r.status == "ok" and r.trace == "plan" for r in kids)
        assert solve.t_start <= kids[0].t_start
        for a, b in zip(kids, kids[1:]):
            assert a.t_end <= b.t_start
        assert kids[-1].t_end <= solve.t_end
        launch = kids[1]
        assert launch.attrs == {"iterations": 4, "b1_path": path,
                                "graph": "eager"}
        assert sess.obs.recorder.dropped == 0
    finally:
        sess.obs.close()


@pytest.mark.parametrize("tol", [0.0, 1e-6])
def test_port_spans_graph_attr_is_eager_on_the_cpu(tol):
    """On the CPU no solve is captured into a CUDA graph, at any
    ``tol``: every ``solve_launch`` says ``graph="eager"`` and the graph
    counters stay where they were."""
    port_pagerank = importlib.import_module("repro_torch.core.pagerank")
    before = port_pagerank.graph_captures, port_pagerank.graph_replays
    port_plan.clear_plan_cache()
    sess = repro_torch.open(generators.rmat(8, 8, seed=33),
                            repro_torch.EngineConfig(
                                method="pcpm_pallas", part_size=64,
                                tol=tol, observe=True), device="cpu")
    try:
        for _ in range(3):
            sess.pagerank(num_iterations=4)
        launches = _by_name(sess.obs.recorder.snapshot(), "solve_launch")
        assert [r.attrs["graph"] for r in launches] == ["eager"] * 3
        assert (port_pagerank.graph_captures,
                port_pagerank.graph_replays) == before
    finally:
        sess.obs.close()


def test_port_spans_of_host_preprocessing():
    """The plan build's stages under ``plan_make``, the layouts of the
    first solve; a second session on the graph finds the plan, the
    fingerprint and the layouts made."""
    sess, recs = _observed_solve("pcpm_pallas", seed=32)
    try:
        make, = _by_name(recs, "plan_make")
        png = sess.plan.png
        assert make.attrs == {
            "method": "pcpm_pallas", "n": sess.plan.num_nodes,
            "m": sess.plan.num_edges, "hit": False,
            "updates": png.num_updates, "r": png.compression_ratio,
            "max_part_share": np.diff(png.edge_offsets).max()
            / png.num_edges}
        stages = _children(recs, make)
        assert [r.name for r in stages] == ["plan_stage"] * 3
        assert [r.attrs["stage"] for r in stages] == [
            "validate", "fingerprint", "png"]
        assert all(make.t_start <= r.t_start and r.t_end <= make.t_end
                   for r in stages)
        # the d = 1 solve: the PNG's own updates and gather order, no
        # blocked form
        layouts = {r.attrs["name"]: r for r in _by_name(recs,
                                                        "device_layout")}
        assert set(layouts) == {"spmv", "updates", "tile_schedule"}
        assert not [r for r in stages if r.attrs["stage"] == "blocked"]
        outer = layouts["spmv"]
        for name in ("updates", "tile_schedule"):
            assert layouts[name].parent_id == outer.span_id
        assert outer.parent_id is None and make.parent_id is None
        again = repro_torch.open(sess.graph, sess.config, device="cpu")
        again.pagerank(num_iterations=2)
        recs2 = sess.obs.recorder.snapshot()[len(recs):]
        make2, = _by_name(recs2, "plan_make")
        assert make2.attrs["hit"] is True
        assert [r.attrs["stage"] for r in _children(recs2, make2)] == [
            "validate"]
        assert not _by_name(recs2, "device_layout")
    finally:
        sess.obs.close()


@pytest.mark.parametrize("found", [False, True], ids=["built", "found"])
def test_port_spans_kernel_load(tmp_path, monkeypatch, found):
    """``kernel_load`` over ``_build.build`` with ``nvcc`` stubbed: built
    true with its compile seconds on an empty build directory, false
    with 0.0 where the library is there; a library this process already
    loaded records nothing."""
    from repro_torch.kernels import _build

    class FakeNvcc:
        def __init__(self, argv, **kw):
            self.out = Path(argv[argv.index("-o") + 1])

        def wait(self):
            self.out.write_bytes(b"\x7fELF")
            return 0

    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "subprocess", SimpleNamespace(
        Popen=FakeNvcc, STDOUT=None))
    if found:
        _build.BUILD_DIR.mkdir()
        _build.library_path(source).write_bytes(b"\x7fELF")
    obs = port_obs.Observability(capacity=64)
    try:
        built, = _build.build(source)
        _build.build(source)
        rec, = obs.recorder.snapshot()
        assert (rec.name, rec.trace, rec.status) == ("kernel_load", "plan",
                                                     "ok")
        assert rec.attrs["source"] == "k.cu"
        assert rec.attrs["built"] is (not found)
        assert rec.attrs["compile_s"] == built.seconds
        assert (built.seconds > 0.0) is (not found)
        assert built.path.exists()
    finally:
        obs.close()


def test_port_spans_cost_nothing_without_a_bundle(monkeypatch):
    """With no bundle attached a build, the layouts and a solve make no
    ``Span`` at all."""
    def refuse(*args, **kwargs):
        raise AssertionError("a Span was made with no bundle attached")

    monkeypatch.setattr(port_plan, "_PLAN_OBSERVERS", weakref.WeakSet())
    monkeypatch.setattr(port_obs.Span, "__init__", refuse)
    port_plan.clear_plan_cache()
    g = generators.rmat(8, 8, seed=33)
    sess = repro_torch.open(g, method="pcpm_pallas", part_size=64,
                            device="cpu")
    assert sess.pagerank(num_iterations=3).iterations == 3


def test_port_spans_share_the_profiler_clock():
    """Under an active CPU ``torch.profiler`` each span is also a
    ``repro_torch::<name>`` event, one for each record, and its interval
    encloses the aten ops run inside it: every scatter (``index_select``)
    lies in a ``solve_launch``, each ``solve_readback`` holds the slice of
    the residuals it reads, every stage lies in its ``solve`` or
    ``plan_make``."""
    from torch.profiler import ProfilerActivity, profile
    port_plan.clear_plan_cache()
    g = generators.rmat(8, 8, seed=34)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess = repro_torch.open(g, repro_torch.EngineConfig(
            method="pcpm_pallas", part_size=64, observe=True),
            device="cpu")
        for _ in range(2):
            sess.pagerank(num_iterations=3)
    try:
        recs = sess.obs.recorder.snapshot()
        events = {}
        for e in prof.profiler.kineto_results.events():
            t0 = e.start_ns()
            events.setdefault(e.name(), []).append(
                (t0, t0 + e.duration_ns()))
        for name in port_obs.PORT_SPANS - {"kernel_load"} | {"solve"}:
            assert len(events.get("repro_torch::" + name, [])) == len(
                _by_name(recs, name)) > 0, name

        def inside(inner, outer):
            return all(any(a <= i0 and i1 <= b for a, b in
                           events["repro_torch::" + outer])
                       for i0, i1 in events[inner])

        assert len(events["aten::index_select"]) >= 6    # 2 x 3 scatters
        assert inside("aten::index_select", "solve_launch")
        assert all(any(a <= i0 and i1 <= b for i0, i1 in
                       events["aten::slice"])
                   for a, b in events["repro_torch::solve_readback"])
        names = ("solve_start", "solve_launch", "solve_readback")
        for stage in names:
            assert inside("repro_torch::" + stage, "solve")
        # each range closes when its span ends, before the next opens
        ranges = sorted((t0, t1, name) for name in names
                        for t0, t1 in events["repro_torch::" + name])
        assert [r[2] for r in ranges] == list(names) * 2
        assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
        assert inside("repro_torch::plan_stage", "plan_make")
    finally:
        sess.obs.close()


# ------------------------------------------------ trace-format parity
def _fixed_sequence(pkg, g, tmp_path):
    """One fixed query sequence through an observing scheduler on a fake
    clock (rmat(8, 8, seed=1), pcpm, part_size 64, chunk 4): a uniform
    full-vector query, a seeded top-k push, a seeded stepper query, a
    drain, a delta rebind, a query on the new plan, a drain. Returns the
    flight recorder's JSONL dump, read back."""
    pkg.plan.clear_plan_cache()
    ticks = iter(range(1, 1 << 20))
    obs = pkg.obs.Observability(capacity=4096,
                                clock=lambda: float(next(ticks)))
    try:
        sch = pkg.scheduler(g, slots=2, obs=obs)
        sch.submit(None, tol=1e-6, max_iters=200)
        sch.submit(_seed(g, at=5), top_k=8, tol=1e-2, max_iters=300)
        sch.submit(_seed(g, at=9), top_k=4, tol=1e-6, max_iters=300,
                   route="stepper")
        sch.run_until_drained()
        rng = np.random.default_rng(4)
        sch.apply_delta(pkg.GraphDelta.insert(
            np.stack([rng.integers(0, g.num_nodes, 12),
                      rng.integers(0, g.num_nodes, 12)], axis=1)))
        sch.submit(_seed(g, at=11), tol=1e-6, max_iters=300)
        sch.run_until_drained()
        path = tmp_path / f"trace-{pkg is PORT}.jsonl"
        obs.dump(str(path))
        lines = path.read_text().splitlines()
        return json.loads(lines[0]), [json.loads(ln) for ln in lines[1:]]
    finally:
        obs.close()


def test_trace_dumps_have_the_reference_format(graphs, tmp_path):
    """Both packages' dumps of the same sequence: the same header, and
    record for record the same span and event names, parent structure,
    trace labels, statuses and attribute keys (times and ids differ)."""
    dumps = {pkg: _fixed_sequence(pkg, graphs[pkg], tmp_path)
             for pkg in BOTH}

    def shape(rows):
        index = {r["span"]: i for i, r in enumerate(rows)}
        traces = {}
        out = []
        for r in rows:
            t = r["trace"]
            if isinstance(t, int):
                t = traces.setdefault(t, f"uid{len(traces)}")
            parent = (None if r["parent"] is None
                      else index.get(r["parent"], "open"))
            out.append((r["name"], parent, t, r["status"],
                        tuple(sorted(r["attrs"]))))
        return out

    (h_port, rows_port), (h_ref, rows_ref) = dumps[PORT], dumps[REF]
    port_only = [r for r in rows_port if r["name"] in port_obs.PORT_SPANS]
    rows_port = [r for r in rows_port
                 if r["name"] not in port_obs.PORT_SPANS]
    assert {"plan_make", "device_layout"} <= {r["name"] for r in port_only}
    assert {k: v for k, v in h_port.items()
            if k not in ("recorded", "held")} == {
        k: v for k, v in h_ref.items() if k not in ("recorded", "held")}
    assert h_port["recorded"] - len(port_only) == h_ref["recorded"]
    assert h_port["held"] - len(port_only) == h_ref["held"]
    assert shape(rows_port) == shape(rows_ref)
    names = {r["name"] for r in rows_port}
    assert {"png_build", "plan_build", "xla_compile", "query", "queue",
            "slot", "push", "chunk", "topk", "readback", "terminal",
            "rebind", "plan_patch"} <= names
    assert set(rows_port[0]) == set(rows_ref[0])


def test_same_registry_operations_give_the_same_prometheus_text():
    """The serving stack's registry operations, replayed on both packages'
    ``ServeMetrics`` and ``MetricsRegistry`` on one fake clock, render
    byte-identical Prometheus text, alone and merged."""
    texts = []
    for pkg in BOTH:
        t = [0.0]
        m = pkg.ServeMetrics()
        m.clock = lambda: t[0]
        for uid in range(6):
            m.submitted(uid)
            t[0] += 0.125
            m.admitted(uid)
            t[0] += 0.25 * (uid + 1)
            if uid == 4:
                m.incr("rejected")
                m.completed(uid, iterations=0, converged=False,
                            error="rejected: admission queue full (1)")
            elif uid == 5:
                m.incr("push_served")
                m.completed(uid, iterations=7, converged=True,
                            route="push")
            else:
                m.completed(uid, iterations=10 + uid, converged=True,
                            degraded=uid == 3)
        m.incr("quarantined", 2)
        reg = pkg.obs.MetricsRegistry()
        reg.gauge("gateway_pending", "backlog depth").set(3)
        reg.counter("plan_events_total", "plan build/hit/patch events",
                    event="plan_build").inc()
        texts.append((m.registry.prometheus_text(),
                      pkg.obs.render_prometheus(
                          [(reg, {}), (m.registry, {"graph": "g"})])))
    assert texts[0] == texts[1]
