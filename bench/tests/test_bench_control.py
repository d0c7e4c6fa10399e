"""The check fails what it must: the control (the plain reference put
in the program's place in bfloat16), and a run whose timed path is
broken underneath, with the look for a chip skipped (CPU, tiny sizes).
The exchange between chips has no fault here: every cell is one card."""
import importlib

import pytest
import torch

from bench import checks, control
from bench import spec as specs
from bench.tests.conftest import TINY, spec_root


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails(cell, seed):
    config, traffic = TINY[cell]
    root = spec_root(cell)
    numbers = control.control(cell, seed, "cpu", root=root,
                              config_overrides=config,
                              traffic_overrides=traffic)
    w = specs.find_cell(specs.load_spec(root), cell)
    limits = specs.load_traffic(w["traffic"])["limits"]
    ok, _ = checks.verdict(numbers, limits)
    assert not ok, numbers


def test_sound_runs_pass(tiny):
    for cell in sorted(TINY):
        result, _ = tiny(cell)
        assert result["correct"] is True, (cell, result)


def _unchanged_solve(monkeypatch):
    """A solve whose iterations leave the start vector as it is."""
    pr_mod = importlib.import_module("repro_torch.core.pagerank")

    def broken(engine, *, num_iterations=20, **kw):
        def run(pr, inv_deg, base):
            res = torch.full((max(num_iterations, 1),), -1.0)
            return pr, num_iterations, res
        return run
    monkeypatch.setattr(pr_mod, "fused_power_iteration", broken)


def _unchanged_chunk(monkeypatch):
    """A stepper chunk that returns its pool as it got it and stops
    every column."""
    from repro_torch.serve import scheduler

    def broken(engine, **kw):
        def step(pr, base, active, tol_col, budget, inv_deg):
            took = active.to(torch.int32)
            res = torch.zeros(pr.shape[1], dtype=torch.float32)
            return pr, torch.zeros_like(active), took, res
        return step
    monkeypatch.setattr(scheduler, "masked_chunk_stepper", broken)


def _half_left_out(monkeypatch):
    """Every SpMV reads half of the sources and doubles what it sums:
    the mean over the rest in place of the whole."""
    from repro_torch.core.spmv import SpMVEngine
    original = SpMVEngine.spmv_fn

    def spmv_fn(self):
        fn = original(self)

        def half(x):
            keep = torch.zeros_like(x)
            keep[::2] = x[::2]
            return fn(keep) * 2.0
        return half
    monkeypatch.setattr(SpMVEngine, "spmv_fn", spmv_fn)


def _altered_ranks(monkeypatch):
    """The solve's answer with its two largest ranks swapped."""
    pr_mod = importlib.import_module("repro_torch.core.pagerank")
    original = pr_mod._run_fused

    def run(*a, **kw):
        res = original(*a, **kw)
        top = torch.topk(res.ranks, 2).indices
        res.ranks = res.ranks.clone()
        res.ranks[top] = res.ranks[top.flip(0)]
        return res
    monkeypatch.setattr(pr_mod, "_run_fused", run)


def _altered_topk(monkeypatch):
    """Each served top-k answer with its first id replaced by the id of
    its last place's neighbour."""
    from repro_torch.serve import scheduler
    original = scheduler.make_slot_topk

    def make(num_nodes):
        fn = original(num_nodes)

        def topk(pr, col, k):
            ids, scores = fn(pr, col, k)
            ids = ids.clone()
            ids[0] = (ids[-1] + 1) % num_nodes
            return ids, scores
        return topk
    monkeypatch.setattr(scheduler, "make_slot_topk", make)


FAULTS = {
    "kron-solve": [_unchanged_solve, _half_left_out, _altered_ranks],
    "urand-solve": [_unchanged_solve, _half_left_out, _altered_ranks],
    "kron-serve": [_unchanged_chunk, _half_left_out, _altered_topk],
}


@pytest.mark.parametrize("cell,fault", [
    (cell, f) for cell, fs in sorted(FAULTS.items()) for f in fs],
    ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(monkeypatch, tiny, cell, fault):
    fault(monkeypatch)
    result, compared = tiny(cell)
    assert result["correct"] is False, compared
