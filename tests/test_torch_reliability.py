"""Port vs reference: the serving resilience layer on CPU tensors.

Every case of the JAX package's chaos suite (``tests/test_reliability.py``)
runs here on the port and on the reference, side by side on the same
inputs: fault plans (``FaultSpec``, ``FaultPlan``, ``FaultInjector``,
``corrupt_plan_arrays``), the scheduler's hooks (poisoned columns,
injected stepper failures, failing and corrupted deltas), overload,
scheduler snapshot/restore and rank checkpoints. Slot choices and
counters are equal, ranks within 1e-6 L∞ and iteration counts equal.
Snapshots and checkpoints written by one package load in the other.
``test_sharded_quarantine`` runs on a group of eight gloo ranks in
``tests/test_torch_distributed.py``.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro_torch
from repro_torch.core.pagerank import StepperFailure
from repro_torch.core.plan import PlanConfig, build_plan
from repro_torch.graphs import generators
from repro_torch.reliability import (FaultInjector, FaultPlan, FaultSpec,
                                     ResilienceConfig,
                                     check_plan_integrity,
                                     corrupt_plan_arrays,
                                     load_rank_checkpoint, restore_scheduler,
                                     save_rank_checkpoint,
                                     snapshot_scheduler)
from repro_torch.reliability import faults as faults_mod
from repro_torch.serve import SlotScheduler
from repro_torch.stream.delta import apply_delta as apply_edges
from repro_torch.stream.patch import patch_plan

from test_torch_reference import load_reference

ref_stream = load_reference("stream")
ref_gen = load_reference("graphs.generators")
ref_rel = load_reference("reliability")
ref_faults = load_reference("reliability.faults")
ref_sched = load_reference("serve.scheduler")
ref_plan = load_reference("core.plan")
ref_api = load_reference("api")

SMALL = dict(method="pcpm", part_size=64, chunk=4)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def graphs():
    g, r = generators.rmat(8, 8, seed=1), ref_gen.rmat(8, 8, seed=1)
    assert np.array_equal(g.src, r.src) and np.array_equal(g.dst, r.dst)
    return g, r


def _seeds(g, k, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        s = np.zeros(g.num_nodes, np.float32)
        s[rng.integers(0, g.num_nodes, size=2)] = 1.0
        out.append(s)
    return out


def _port(g, **kw):
    return SlotScheduler(g, **{**SMALL, **CPU, **kw})


def _ref(r, **kw):
    return ref_sched.SlotScheduler(r, **{**SMALL, **kw})


def _drain(sch, seeds, **kw):
    """Submit ``seeds`` (tol 1e-6, 300 iterations), drain, and return
    the results in submit order."""
    uids = [sch.submit(s, tol=1e-6, max_iters=300, **kw) for s in seeds]
    sch.run_until_drained()
    done = {q.uid: q for q in sch.completed}
    return [done[u] for u in uids]


# Submit indices of the 6-query mix whose stop lies one iteration apart
# between the packages: query 0 stops at 55 iterations on the port
# (residual 9.754e-7) and at 56 on the reference, whose residual at 55 is
# just above 1e-6. The L1 residual sums 256 float32 differences of ~4e-9
# between ranks of ~4e-3, each rounded to ~10% of itself in a different
# summation order (torch's and XLA's prefix sums of the blocked gather),
# so which side of 1e-6 it falls on is rounding, not the algorithm (the
# same finding as ROUNDING_STOPS in test_torch_serve_pagerank.py). Port
# against port, every count is equal.
ROUNDING_STOPS = frozenset({0})


def _same_results(a, b, *, iterations=True, rounding=frozenset()):
    """Two runs' results, in submit order: the same terminal states,
    ranks within 1e-6 and (by default) equal iteration counts, one apart
    at most for the submit indices in ``rounding``."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert (x.error is None) == (y.error is None), (x.error, y.error)
        assert x.converged == y.converged
        if iterations and i in rounding:
            assert abs(x.iterations - y.iterations) <= 1
        elif iterations:
            assert x.iterations == y.iterations
        if x.ranks is not None or y.ranks is not None:
            assert np.abs(np.asarray(x.ranks)
                          - np.asarray(y.ranks)).max() <= 1e-6


@pytest.fixture(scope="module")
def fault_free(graphs):
    """Submit-order results of the fault-free run, port and reference."""
    g, r = graphs
    port = _drain(_port(g, slots=3), _seeds(g, 6))
    ref = _drain(_ref(r, slots=3), _seeds(g, 6))
    _same_results(port, ref, rounding=ROUNDING_STOPS)
    return port


def _injectors(specs, seed=0):
    return (FaultInjector(FaultPlan.of(specs, seed=seed)),
            ref_faults.FaultInjector(ref_faults.FaultPlan.of(
                [ref_faults.FaultSpec(s.kind, s.step, s.slot)
                 for s in specs], seed=seed)))


# -------------------------------------------------------------- fault plan
class TestFaultPlan:
    def test_spec_validation(self):
        for mod in (faults_mod, ref_faults):
            with pytest.raises(ValueError, match="unknown fault kind"):
                mod.FaultSpec("not_a_kind", step=1)
            with pytest.raises(ValueError, match="step must be >= 1"):
                mod.FaultSpec("nan_slot", step=0)
        assert faults_mod.KINDS == ref_faults.KINDS

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_deterministic_slot_choice(self, seed):
        """Unpinned poisons pick ``default_rng(seed + step).choice``: the
        reference's slot, every time."""
        for step in (1, 3, 9):
            for live in ([0, 1, 2], [2, 5, 6, 11], [4]):
                specs = [FaultSpec("nan_slot", step=step),
                         FaultSpec("inf_slot", step=step)]
                picks = [_injectors(specs, seed)[0].poisons(step, live)
                         for _ in range(3)]
                want = _injectors(specs, seed)[1].poisons(step, live)
                assert picks[0] == picks[1] == picks[2] == want
        # a spec with no eligible slot stays pending
        inj, rinj = _injectors([FaultSpec("nan_slot", step=2)], seed)
        assert inj.poisons(2, []) == rinj.poisons(2, []) == []
        assert not inj.exhausted and inj.poisons(2, [4]) == [(4, "nan_slot")]

    def test_exhausted(self):
        for mod in (faults_mod, ref_faults):
            inj = mod.FaultInjector(mod.FaultPlan.of(
                [mod.FaultSpec("step_error", step=1)]))
            with pytest.raises(mod.InjectedFault):
                inj.check_step(1)
            assert inj.exhausted and len(inj.fired) == 1
            inj.check_step(1)          # fires once, then inert

    def test_delta_hooks_fire_once(self):
        for mod in (faults_mod, ref_faults):
            inj = mod.FaultInjector(mod.FaultPlan.of(
                [mod.FaultSpec("delta_error", step=2),
                 mod.FaultSpec("corrupt_plan", step=3)]))
            inj.check_delta(1)
            with pytest.raises(mod.InjectedFault, match="delta 2"):
                inj.check_delta(2)
            inj.check_delta(2)
            assert not inj.wants_corrupt(2)
            assert inj.wants_corrupt(3) and not inj.wants_corrupt(3)
            assert inj.exhausted


# -------------------------------------------------------------- quarantine
class TestQuarantine:
    @pytest.mark.parametrize("kind", ["nan_slot", "inf_slot"])
    def test_poisoned_slot_requeued_clean(self, graphs, fault_free, kind):
        """A non-finite column freezes on the device, is detected at the
        host and re-admitted from its clean seed; its neighbours reach
        the fault-free answers, as in the reference."""
        g, r = graphs
        inj, rinj = _injectors([FaultSpec(kind, step=2, slot=0)])
        res = ResilienceConfig(max_retries=1)
        port = _port(g, slots=3, fault_injector=inj, resilience=res)
        ref = _ref(r, slots=3, fault_injector=rinj,
                   resilience=ref_rel.ResilienceConfig(max_retries=1))
        out = _drain(port, _seeds(g, 6))
        _same_results(out, _drain(ref, _seeds(g, 6)),
                      rounding=ROUNDING_STOPS)
        assert port.metrics.counters["quarantined"] == 1
        assert port.metrics.counters["requeued"] == 1
        assert dict(port.metrics.counters) == dict(ref.metrics.counters)
        assert port.trace_count == 1 and inj.exhausted
        _same_results(out, fault_free, iterations=False)
        for q in out:
            assert q.error is None and q.converged

    def test_no_retry_fails_explicitly(self, graphs, fault_free):
        g, r = graphs
        inj, rinj = _injectors([FaultSpec("nan_slot", step=2, slot=0)])
        port = _port(g, slots=3, fault_injector=inj,
                     resilience=ResilienceConfig(max_retries=0))
        ref = _ref(r, slots=3, fault_injector=rinj,
                   resilience=ref_rel.ResilienceConfig(max_retries=0))
        out = _drain(port, _seeds(g, 6))
        _same_results(out, _drain(ref, _seeds(g, 6)),
                      rounding=ROUNDING_STOPS)
        failed = [q for q in out if q.error]
        assert len(failed) == 1 and "quarantined" in failed[0].error
        assert not failed[0].converged and failed[0].ranks is None
        for q, want in zip(out, fault_free):
            if q.error is None:
                assert np.abs(want.ranks - q.ranks).max() <= 1e-6

    def test_unpinned_poison_lands_where_the_reference_does(self, graphs):
        g, r = graphs
        specs = [FaultSpec("inf_slot", step=2), FaultSpec("nan_slot", step=3)]
        inj, rinj = _injectors(specs, seed=5)
        res = ResilienceConfig(max_retries=0)
        port = _port(g, slots=3, fault_injector=inj, resilience=res)
        ref = _ref(r, slots=3, fault_injector=rinj,
                   resilience=ref_rel.ResilienceConfig(max_retries=0))
        out = _drain(port, _seeds(g, 6))
        _same_results(out, _drain(ref, _seeds(g, 6)),
                      rounding=ROUNDING_STOPS)
        assert sum(q.error is not None for q in out) == 2
        assert inj.fired == specs


# ------------------------------------------------------------ step failure
class TestStepFailure:
    def test_transient_retry(self, graphs, fault_free):
        g, r = graphs
        inj, rinj = _injectors([FaultSpec("step_error", step=2)])
        port = _port(g, slots=3, fault_injector=inj,
                     resilience=ResilienceConfig(max_step_retries=1))
        ref = _ref(r, slots=3, fault_injector=rinj,
                   resilience=ref_rel.ResilienceConfig(max_step_retries=1))
        out = _drain(port, _seeds(g, 6))
        _same_results(out, _drain(ref, _seeds(g, 6)),
                      rounding=ROUNDING_STOPS)
        assert port.metrics.counters["stepper_failures"] == 1
        _same_results(out, fault_free)
        assert all(q.converged and q.error is None for q in out)

    def test_hard_failure_fails_inflight_keeps_serving(self, graphs):
        """Past the retry budget the in-flight queries fail explicitly,
        the pool is rebuilt, and the queued queries are served."""
        g, r = graphs
        inj, rinj = _injectors([FaultSpec("step_error", step=2)])
        port = _port(g, slots=3, fault_injector=inj,
                     resilience=ResilienceConfig(max_step_retries=0))
        ref = _ref(r, slots=3, fault_injector=rinj,
                   resilience=ref_rel.ResilienceConfig(max_step_retries=0))
        out = _drain(port, _seeds(g, 6))
        _same_results(out, _drain(ref, _seeds(g, 6)),
                      rounding=ROUNDING_STOPS)
        errs = [q for q in out if q.error]
        assert len(errs) == 3 and all("stepper failure" in q.error
                                      for q in errs)
        assert [q.error is None for q in out] == [False] * 3 + [True] * 3
        assert all(q.converged for q in out if q.error is None)

    @pytest.mark.parametrize("failure", ["injected", "unwritten", "written"])
    def test_injected_fault_retries_and_a_written_pool_is_lost(
            self, graphs, fault_free, failure):
        """The repair of the port's recovery: an injected ``step_error``
        is raised in place of the stepper call, so it reaches the
        recovery as "pool unwritten" and is retried (as the reference
        retries it); a stepper that failed before its first write is
        retried too; a stepper that failed after writing the pool in
        place still fails the in-flight queries, retries left or not."""
        g, _ = graphs
        res = ResilienceConfig(max_step_retries=1)
        if failure == "injected":
            inj = FaultInjector(FaultPlan.of([FaultSpec("step_error",
                                                        step=2)]))
            sch = _port(g, slots=3, fault_injector=inj, resilience=res)
        else:
            sch = _port(g, slots=3, resilience=res)
            real, calls = sch._step_c, [0]

            def flaky(*a):
                calls[0] += 1
                if calls[0] == 2:
                    raise StepperFailure(RuntimeError("boom"),
                                         pool_written=failure == "written")
                return real(*a)

            sch._step_c = flaky
        out = _drain(sch, _seeds(g, 6))
        assert sch.metrics.counters["stepper_failures"] == 1
        if failure == "written":
            assert [("stepper failure" in (q.error or "")) for q in out] \
                == [True] * 3 + [False] * 3
        else:
            _same_results(out, fault_free)
        sch.metrics.reconcile()


# ------------------------------------------------------------- plan faults
class TestPlanFaults:
    def test_delta_failure_leaves_scheduler_intact(self, graphs):
        g, r = graphs
        inj, rinj = _injectors([FaultSpec("delta_error", step=1)])
        for sch, mod, delta in (
                (_port(g, slots=2, fault_injector=inj), faults_mod,
                 repro_torch.GraphDelta.insert(np.array([[1, 2]], np.int32))),
                (_ref(r, slots=2, fault_injector=rinj), ref_faults,
                 ref_stream.GraphDelta.insert(np.array([[1, 2]], np.int32)))):
            sch.submit(tol=1e-6, max_iters=300)
            with pytest.raises(mod.InjectedFault):
                sch.apply_delta(delta)
            assert sch.metrics.counters["delta_failures"] == 1
            assert sch.rebind_count == 0
            assert all(q.converged for q in sch.run_until_drained())

    def test_corrupt_plan_rejected_old_plan_serves(self, graphs):
        """A corrupted patched plan is caught by the integrity check
        before it is installed; the delta fails explicitly and the old
        plan (and its uploads) keep serving."""
        g, r = graphs
        inj, rinj = _injectors([FaultSpec("corrupt_plan", step=1)])
        edges = np.array([[1, 2], [3, 4]], np.int32)
        port = _port(g, slots=2, fault_injector=inj)
        ref = _ref(r, slots=2, fault_injector=rinj)
        port.submit(tol=1e-6, max_iters=300)
        port.step()
        plan, uploads = port.engine.plan, dict(port.engine.plan._device)
        for sch, delta in ((port, repro_torch.GraphDelta.insert(edges)),
                           (ref, ref_stream.GraphDelta.insert(edges))):
            sch.submit(tol=1e-6, max_iters=300)
            with pytest.raises(ValueError, match="plan integrity"):
                sch.apply_delta(delta)
            assert sch.metrics.counters["delta_failures"] == 1
            assert sch.rebind_count == 0
            assert all(q.converged for q in sch.run_until_drained())
        assert port.engine.plan is plan and inj.exhausted
        assert plan._device.keys() == uploads.keys()
        assert all(plan._device[k] is v for k, v in uploads.items())

    @pytest.mark.parametrize("method", ["pdpr", "bvgas", "pcpm",
                                        "pcpm_pallas"])
    def test_integrity_accepts_real_plans(self, method):
        """No false positives: fresh and patched plans of every backend
        pass the integrity check, and a corrupted copy of each — the
        reference's corrupted arrays exactly, with an empty runtime cache
        — fails it."""
        g, r = generators.rmat(9, 8, seed=3), ref_gen.rmat(9, 8, seed=3)
        edges = np.array([[1, 2], [300, 7], [8, 450]], np.int32)
        plan = build_plan(g, PlanConfig(method=method, part_size=64))
        check_plan_integrity(plan)
        delta = repro_torch.GraphDelta.insert(edges)
        check_plan_integrity(patch_plan(plan, delta, apply_edges(g, delta)))
        plan._device[("probe", "cpu")] = object()
        bad = corrupt_plan_arrays(plan)
        assert bad._device == {} and ("probe", "cpu") in plan._device
        with pytest.raises(ValueError, match="plan integrity"):
            check_plan_integrity(bad)
        rplan = ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                           part_size=64))
        rbad = ref_faults.corrupt_plan_arrays(rplan)
        for field in ("csc_src", "bv_src"):
            a, b = getattr(bad, field), getattr(rbad, field)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a, b)
        if plan.png is not None:
            assert np.array_equal(bad.png.update_src, rbad.png.update_src)
            assert not np.array_equal(plan.png.update_src,
                                      bad.png.update_src)

    def test_corrupting_a_plan_without_arrays_raises(self, graphs):
        g, _ = graphs
        plan = build_plan(g, PlanConfig(method="pdpr", part_size=64))
        empty = dataclasses.replace(plan, csc_src=None)
        with pytest.raises(ValueError, match="no index arrays"):
            corrupt_plan_arrays(empty)


# ---------------------------------------------------------------- overload
class TestOverload:
    def test_burst_bounded_queue_explicit_rejections(self, graphs):
        g, r = graphs
        port = _port(g, slots=2, resilience=ResilienceConfig(
            max_queue=4, default_deadline_s=30.0))
        ref = _ref(r, slots=2, resilience=ref_rel.ResilienceConfig(
            max_queue=4, default_deadline_s=30.0))
        for sch in (port, ref):
            uids = [sch.submit(s, tol=1e-6, max_iters=300)
                    for s in _seeds(g, 12)]
            assert sch.queued <= 4
            sch.run_until_drained()
            done = {q.uid: q for q in sch.completed}
            out = [done[u] for u in uids]
            assert len(out) == 12
            assert sum(bool(q.error and "rejected" in q.error)
                       for q in out) == 8
            assert sch.metrics.counters["rejected"] == 8
            assert all(q.converged for q in out if not q.error)
            p99 = sch.metrics.percentile(99.0)
            assert p99 is not None and p99 <= 30.0

    def test_deadline_expires_in_queue(self, graphs):
        g, r = graphs
        for sch in (_port(g, slots=1,
                          resilience=ResilienceConfig(max_queue=8)),
                    _ref(r, slots=1,
                         resilience=ref_rel.ResilienceConfig(max_queue=8))):
            t = [0.0]
            sch.metrics.clock = lambda: t[0]
            sch.clock = sch.metrics.clock
            u1 = sch.submit(_seeds(g, 1)[0], tol=1e-6, max_iters=300)
            u2 = sch.submit(_seeds(g, 1)[0], tol=1e-6, max_iters=300,
                            deadline_s=0.5)
            t[0] = 1.0
            sch.run_until_drained()
            done = {q.uid: q for q in sch.completed}
            assert "deadline" in done[u2].error
            assert done[u1].converged
            assert sch.metrics.counters["expired"] == 1

    def test_degrades_before_dropping(self, graphs):
        g, r = graphs
        for sch in (_port(g, slots=2,
                          resilience=ResilienceConfig(degrade_tol=1e-3)),
                    _ref(r, slots=2, resilience=ref_rel.ResilienceConfig(
                        degrade_tol=1e-3))):
            sch._iter_s = 0.05
            sch._query_iters = 60.0
            u = sch.submit(_seeds(g, 1)[0], tol=1e-8, max_iters=300,
                           deadline_s=1.0)
            sch.run_until_drained()
            done = {q.uid: q for q in sch.completed}
            assert done[u].degraded and done[u].error is None
            assert sch.metrics.counters["degraded"] == 1

    def test_priority_order(self, graphs):
        g, r = graphs
        for sch in (_port(g, slots=1), _ref(r, slots=1)):
            sch.submit(_seeds(g, 1)[0], tol=1e-6, max_iters=300)
            sch.step()
            a = sch.submit(_seeds(g, 2)[1], tol=1e-6, max_iters=300,
                           priority=0)
            b = sch.submit(_seeds(g, 3)[2], tol=1e-6, max_iters=300,
                           priority=5)
            order = [q.uid for q in sch.run_until_drained()]
            assert order.index(b) < order.index(a)


# ------------------------------------------------------- snapshot / restore
def _snapshot_after(sch, g, path, chunks=3):
    uids = [sch.submit(s, tol=1e-6, max_iters=300) for s in _seeds(g, 6)]
    for _ in range(chunks):
        sch.step()
    assert sch.active_slots == 3 and sch.queued == 3
    (snapshot_scheduler if isinstance(sch, SlotScheduler)
     else ref_rel.snapshot_scheduler)(sch, path)
    return uids


def _drained(sch, uids):
    sch.run_until_drained()
    done = {q.uid: q for q in sch.completed}
    return [done[u] for u in uids]


class TestSnapshotRestore:
    def test_roundtrip_matches_uninterrupted(self, graphs, fault_free,
                                             tmp_path):
        """snapshot -> (process death) -> restore resumes the in-flight
        queries to the same iteration counts and answers as the
        uninterrupted run."""
        g, _ = graphs
        path = str(tmp_path / "sched.npz")
        uids = _snapshot_after(_port(g, slots=3), g, path)
        restored = restore_scheduler(path, g, slots=3, **SMALL, **CPU)
        assert restored.trace_count == 1
        _same_results(_drained(restored, uids), fault_free)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_snapshot_cross_loads(self, graphs, fault_free, tmp_path,
                                  writer):
        """A snapshot written by either package restores in the other
        and drains to the uninterrupted answers; both packages write the
        same file for the same serving state."""
        g, r = graphs
        path, other = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        if writer == "port":
            uids = _snapshot_after(_port(g, slots=3), g, path)
            _snapshot_after(_ref(r, slots=3), g, other)
            restored = ref_rel.restore_scheduler(path, r, slots=3, **SMALL)
        else:
            uids = _snapshot_after(_ref(r, slots=3), g, path)
            _snapshot_after(_port(g, slots=3), g, other)
            restored = restore_scheduler(path, g, slots=3, **SMALL, **CPU)
        _same_results(_drained(restored, uids), fault_free,
                      rounding=ROUNDING_STOPS)
        a, b = np.load(path), np.load(other)
        assert sorted(a.files) == sorted(b.files)
        ma, mb = (json.loads(str(z["__meta__"]))
                  for z in (a, b))
        assert ma.keys() == mb.keys() and ma["graph_fp"] == mb["graph_fp"]
        assert (ma["n_pad"], ma["reorder"]) == (mb["n_pad"], mb["reorder"])
        for key in a.files:
            if key in ("__meta__", "q_uid", "q_deadline_rem"):
                continue
            if key == "cols":
                assert np.abs(a[key] - b[key]).max() <= 1e-6
            else:
                assert np.array_equal(a[key], b[key]), key

    def test_restore_rejects_wrong_graph(self, graphs, tmp_path):
        g, _ = graphs
        sch = _port(g, slots=2)
        sch.submit(tol=1e-6, max_iters=300)
        sch.step()
        path = str(tmp_path / "sched.npz")
        snapshot_scheduler(sch, path)
        other = generators.rmat(8, 8, seed=99)
        with pytest.raises(ValueError, match="fingerprint"):
            restore_scheduler(path, other, slots=2, **SMALL, **CPU)
        with pytest.raises(ValueError, match="damping"):
            restore_scheduler(path, g, slots=2, damping=0.5, **SMALL, **CPU)

    def test_uid_floor_survives_restart(self, graphs, tmp_path):
        g, _ = graphs
        sch = _port(g, slots=2)
        uid = sch.submit(tol=1e-6, max_iters=300)
        sch.step()
        path = str(tmp_path / "sched.npz")
        snapshot_scheduler(sch, path)
        restored = restore_scheduler(path, g, slots=2, **SMALL, **CPU)
        assert restored._slot_query[0].uid == uid
        assert restored.submit(tol=1e-6, max_iters=10) > uid

    def test_overflow_goes_back_to_the_queue(self, graphs, fault_free,
                                             tmp_path):
        """Fewer slots on restore: the overflow re-enters the queue from
        its seed (losing its progress, never the query)."""
        g, _ = graphs
        path = str(tmp_path / "sched.npz")
        uids = _snapshot_after(_port(g, slots=3), g, path)
        restored = restore_scheduler(path, g, slots=2, **SMALL, **CPU)
        assert restored.active_slots == 2 and restored.queued == 4
        out = _drained(restored, uids)
        _same_results(out, fault_free, iterations=False)
        assert [q.iterations for q in out[:2]] == \
            [q.iterations for q in fault_free[:2]]


# ----------------------------------------------------------- checkpoints
def _open(g, **kw):
    return repro_torch.open(g, method="pcpm", part_size=64, tol=1e-6,
                            num_iterations=200, **CPU, **kw)


def _ref_open(r):
    return ref_api.open(r, method="pcpm", part_size=64, tol=1e-6,
                        num_iterations=200)


class TestRankCheckpoint:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_file_roundtrip(self, graphs, tmp_path, writer):
        g, r = graphs
        ranks = np.random.default_rng(0).random(g.num_nodes,
                                                ).astype(np.float32)
        path = str(tmp_path / "ck.npz")
        save = (save_rank_checkpoint if writer == "port"
                else ref_rel.save_rank_checkpoint)
        save(path, g if writer == "port" else r, ranks, residual=1e-7,
             damping=0.85, dangling="none")
        for load in (load_rank_checkpoint, ref_rel.load_rank_checkpoint):
            ck = load(path)
            assert np.array_equal(ck.ranks, ranks)
            assert ck.residual == pytest.approx(1e-7)
            assert ck.damping == 0.85 and ck.dangling == "none"
            assert ck.graph_fp == ref_plan.graph_fingerprint(r)

    def test_session_warm_restart(self, graphs, tmp_path):
        g, r = graphs
        sess = _open(g)
        cold = sess.pagerank()
        path = str(tmp_path / "ck.npz")
        sess.save_checkpoint(path)
        fresh = _open(g)
        assert fresh.load_checkpoint(path) is fresh
        assert fresh._solved_ranks.device.type == "cpu"
        warm = fresh.pagerank(warm=True)
        assert len(warm.residuals) < len(cold.residuals)
        assert np.abs(warm.ranks.numpy() - cold.ranks.numpy()).max() <= 1e-6
        # the reference, from the same file
        rfresh = _ref_open(r)
        rfresh.load_checkpoint(path)
        rwarm = rfresh.pagerank(warm=True)
        assert len(rwarm.residuals) == len(warm.residuals)
        assert np.abs(np.asarray(rwarm.ranks)
                      - warm.ranks.numpy()).max() <= 1e-6

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_session_restart_across_delta_chain(self, graphs, tmp_path,
                                                writer):
        """Checkpoint on g, restart after g + delta: the fingerprint
        lineage is checked and the warm solve runs the residual push
        instead of a cold solve; the checkpoint may come from either
        package."""
        g, r = graphs
        edges = np.array([[3, 9], [100, 4]], np.int32)
        delta = repro_torch.GraphDelta.insert(edges)
        path = str(tmp_path / "ck.npz")
        first = _open(g) if writer == "port" else _ref_open(r)
        first.pagerank()
        first.save_checkpoint(path)
        restarted = _open(g)
        restarted.apply_delta(delta)
        restarted.load_checkpoint(path, g_old=g, delta=delta)
        warm = restarted.pagerank(warm=True)
        cold = _open(restarted.graph).pagerank()
        assert len(warm.residuals) < len(cold.residuals)
        assert np.abs(warm.ranks.numpy() - cold.ranks.numpy()).max() <= 1e-6
        rdelta = ref_stream.GraphDelta.insert(edges)
        rre = _ref_open(r)
        rre.apply_delta(rdelta)
        rre.load_checkpoint(path, g_old=r, delta=rdelta)
        rwarm = rre.pagerank(warm=True)
        assert len(rwarm.residuals) == len(warm.residuals)
        assert np.abs(np.asarray(rwarm.ranks)
                      - warm.ranks.numpy()).max() <= 1e-6

    def test_checkpoint_rejects_wrong_lineage(self, graphs, tmp_path):
        g, _ = graphs
        sess = _open(g)
        sess.pagerank()
        path = str(tmp_path / "ck.npz")
        sess.save_checkpoint(path)
        other = generators.rmat(8, 8, seed=99)
        s2 = repro_torch.open(other, method="pcpm", part_size=64, **CPU)
        with pytest.raises(ValueError, match="different graph"):
            s2.load_checkpoint(path)
        with pytest.raises(ValueError, match="delta chain"):
            s2.load_checkpoint(path, g_old=g, delta=repro_torch.GraphDelta
                               .insert(np.array([[1, 1]], np.int32)))
        with pytest.raises(ValueError, match="g_old does not hash"):
            s2.load_checkpoint(path, g_old=other,
                               delta=repro_torch.GraphDelta())
        with pytest.raises(ValueError, match="nothing to checkpoint"):
            _open(g).save_checkpoint(path)


def test_reliability_exports_the_reference_names():
    assert repro_torch.reliability.__all__ == ref_rel.__all__
    for name in ref_rel.__all__:
        assert hasattr(repro_torch.reliability, name)
