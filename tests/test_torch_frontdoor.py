"""Port vs reference: front-door validation on CPU tensors.

Every case of the JAX package's ``tests/test_frontdoor.py`` runs here on
the port and on the reference, side by side: malformed graphs, deltas and
queries fail with the same ``ValueError`` at the boundary (the messages
are compared word for word), a failed ``SlotScheduler.apply_delta``
leaves the old plan serving, and ``ServeMetrics`` gives the same
summaries on its edge cases.
"""
import numpy as np
import pytest

import repro_torch
from repro_torch.core.plan import PlanConfig, build_plan
from repro_torch.graphs import generators
from repro_torch.graphs.formats import Graph, from_edge_list, validate_graph
from repro_torch.serve import ServeMetrics, SlotScheduler
from repro_torch.stream.delta import GraphDelta

from test_torch_reference import load_reference

ref_stream = load_reference("stream")
ref_formats = load_reference("graphs.formats")
ref_gen = load_reference("graphs.generators")
ref_plan = load_reference("core.plan")
ref_serve = load_reference("serve")
ref_api = load_reference("api")


class Pkg:
    def __init__(self, port: bool):
        if port:
            self.Graph, self.from_edge_list = Graph, from_edge_list
            self.validate_graph, self.gen = validate_graph, generators
            self.build_plan, self.PlanConfig = build_plan, PlanConfig
            self.GraphDelta, self.ServeMetrics = GraphDelta, ServeMetrics
            self.SlotScheduler, self.open = SlotScheduler, repro_torch.open
            self.cpu = dict(device="cpu")
        else:
            self.Graph = ref_formats.Graph
            self.from_edge_list = ref_formats.from_edge_list
            self.validate_graph, self.gen = ref_formats.validate_graph, ref_gen
            self.build_plan = ref_plan.build_plan
            self.PlanConfig = ref_plan.PlanConfig
            self.GraphDelta = ref_stream.GraphDelta
            self.ServeMetrics = ref_serve.ServeMetrics
            self.SlotScheduler, self.open = (ref_serve.SlotScheduler,
                                             ref_api.open)
            self.cpu = {}


BOTH = (Pkg(True), Pkg(False))


def _edges(*pairs):
    e = np.array(pairs, np.int32)
    return e[:, 0], e[:, 1]


def _same_error(call, match):
    """``call(pkg)`` raises ``ValueError`` matching ``match`` in both
    packages, with the same message."""
    messages = []
    for pkg in BOTH:
        with pytest.raises(ValueError, match=match) as err:
            call(pkg)
        messages.append(str(err.value))
    assert messages[0] == messages[1], messages


# ------------------------------------------------------- graph construction
def test_rejects_float_arrays():
    _same_error(lambda p: p.Graph(2, np.array([0.0, 1.0]),
                                  np.array([1.0, 0.0])), "int32")


def test_rejects_wrong_dims():
    s, d = _edges((0, 1))
    _same_error(lambda p: p.Graph(2, s.reshape(1, 1), d.reshape(1, 1)),
                "1-D")


def test_rejects_length_mismatch():
    _same_error(lambda p: p.Graph(2, np.array([0, 1], np.int32),
                                  np.array([1], np.int32)), "length")


def test_rejects_nonpositive_num_nodes():
    s, d = _edges((0, 0))
    _same_error(lambda p: p.Graph(0, s, d), "num_nodes")


def test_from_edge_list_rejects_floats():
    _same_error(lambda p: p.from_edge_list(2, np.array([[0.5, 1.0]])),
                "integer")


def test_from_edge_list_rejects_bad_shape():
    _same_error(lambda p: p.from_edge_list(
        3, np.array([[0, 1, 2]], np.int32)), r"\(m, 2\)")


# --------------------------------------------------------- range validation
def test_out_of_range_ids():
    s, d = _edges((0, 5))       # dst 5 >= num_nodes 3
    _same_error(lambda p: p.validate_graph(p.Graph(3, s, d)), "outside")


def test_negative_ids():
    s, d = _edges((-1, 1))
    _same_error(lambda p: p.validate_graph(p.Graph(3, s, d)), "outside")


def test_build_plan_validates():
    s, d = _edges((0, 9))
    _same_error(lambda p: p.build_plan(p.Graph(4, s, d), p.PlanConfig(
        method="pcpm", part_size=64)), "outside")


def test_session_validates():
    s, d = _edges((0, 9))
    _same_error(lambda p: p.open(p.Graph(4, s, d), method="pcpm",
                                 part_size=64, **p.cpu), "outside")


def test_validation_memoized():
    for pkg in BOTH:
        g = pkg.gen.rmat(6, 4, seed=0)
        pkg.validate_graph(g)
        assert g.__dict__.get("_validated")
        pkg.validate_graph(g)           # second call is O(1)


# --------------------------------------------------------- delta validation
def test_rejects_float_edges():
    _same_error(lambda p: p.GraphDelta.insert(np.array([[0.5, 1.5]])),
                "integer")


def test_rejects_bad_shape():
    _same_error(lambda p: p.GraphDelta.insert(
        np.array([[0, 1, 2]], np.int32)), r"\(m, 2\)")


def test_validate_out_of_range():
    def bad(p):
        g = p.gen.rmat(6, 4, seed=0)
        p.GraphDelta.insert(np.array([[0, g.num_nodes + 3]],
                                     np.int32)).validate(g)

    def neg(p):
        g = p.gen.rmat(6, 4, seed=0)
        p.GraphDelta.insert(np.array([[-2, 0]], np.int32)).validate(g)

    _same_error(bad, "out of range")
    _same_error(neg, "out of range")


def test_scheduler_apply_delta_validates():
    """A rejected delta is counted and leaves the old plan serving: the
    next query converges, to the reference's answer."""
    results = []
    for pkg in BOTH:
        g = pkg.gen.rmat(6, 4, seed=0)
        sch = pkg.SlotScheduler(g, slots=2, method="pcpm", part_size=64,
                                chunk=4, **pkg.cpu)
        plan = sch.engine.plan
        bad = pkg.GraphDelta.insert(
            np.array([[0, g.num_nodes + 1]], np.int32))
        with pytest.raises(ValueError, match="out of range"):
            sch.apply_delta(bad)
        assert sch.metrics.counters["delta_failures"] == 1
        assert sch.engine.plan is plan and sch.rebind_count == 0
        sch.submit(tol=1e-4, max_iters=100)
        out = sch.run_until_drained()
        assert all(r.converged for r in out)
        results.append(out[0])
    port, ref = results
    assert port.iterations == ref.iterations
    assert np.abs(port.ranks - np.asarray(ref.ranks)).max() <= 1e-6


# ----------------------------------------------------- ServeMetrics edges
def test_empty_recorder():
    summaries = []
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        assert m.percentile(50.0) is None
        assert m.percentile(99.0, of="queue") is None
        s = m.summary()
        assert s["count"] == 0 and s["served_count"] == 0
        assert s["p50_ms"] is None and s["qps"] is None
        summaries.append(s)
    assert summaries[0] == summaries[1]


def _clocked(pkg):
    t = [0.0]
    m = pkg.ServeMetrics()
    m.clock = lambda: t[0]
    return m, t


def test_error_completions_excluded_from_latency():
    summaries = []
    for pkg in BOTH:
        m, t = _clocked(pkg)
        m.submitted(1)
        m.submitted(2)
        m.admitted(1)
        m.admitted(2)
        t[0] = 1.0
        m.completed(1, iterations=10, converged=True)
        m.completed(2, iterations=0, converged=False,
                    error="rejected: queue full")
        s = m.summary()
        assert s["count"] == 2
        assert s["served_count"] == 1 and s["error_count"] == 1
        assert s["mean_iterations"] == 10.0
        assert s["converged_frac"] == 1.0   # over served only
        summaries.append(s)
    assert summaries[0] == summaries[1]


def test_degraded_counted():
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        m.submitted(1)
        m.admitted(1)
        m.completed(1, iterations=5, converged=True, degraded=True)
        assert m.summary()["degraded_count"] == 1


def test_counters():
    for pkg in BOTH:
        m = pkg.ServeMetrics()
        m.incr("rejected")
        m.incr("rejected")
        m.incr("quarantined")
        assert m.summary()["counters"] == {"rejected": 2, "quarantined": 1}


def test_single_completion_qps_not_inf():
    """One completion: a zero span; qps must be None, not inf."""
    summaries = []
    for pkg in BOTH:
        m, t = _clocked(pkg)
        m.submitted(1)
        m.admitted(1)
        m.completed(1, iterations=3, converged=True)
        assert m.summary()["qps"] is None
        summaries.append(m.summary())
    assert summaries[0] == summaries[1]
