"""The plain reference and the comparisons on hand-checked tiny graphs."""
import math

import numpy as np
import pytest
import torch

from bench import checks
from bench.reference import pagerank as reference

# 0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0: out-degrees 2, 1, 1
SRC = torch.tensor([0, 0, 1, 2])
DST = torch.tensor([1, 2, 2, 0])


def test_one_iteration_by_hand():
    """From 1/3 each: node 0 gets node 2's 1/3, node 1 half of node 0's,
    node 2 the other half and node 1's; then 0.05 + 0.85 y."""
    pr = reference.pagerank(SRC, DST, 3, damping=0.85, iterations=1)
    want = [0.05 + 0.85 / 3, 0.05 + 0.85 / 6, 0.05 + 0.85 / 2]
    assert pr.tolist() == pytest.approx(want, abs=1e-15)


def test_dangling_mass_is_dropped():
    """Node 2 has no out-arc: its rank reaches nobody."""
    pr = reference.pagerank(torch.tensor([0, 1]), torch.tensor([2, 2]), 3,
                            damping=0.85, iterations=1)
    assert pr.tolist() == pytest.approx(
        [0.05, 0.05, 0.05 + 0.85 * 2 / 3], abs=1e-15)


def test_personalized_fixed_point():
    """Against the closed form x = (1-d) (I - d A^T D^-1)^-1 v, with v
    uniform over seed nodes {1} and {0, 2}."""
    a = np.zeros((3, 3))
    for s, d in zip(SRC.tolist(), DST.tolist()):
        a[d, s] += 1.0 / [2, 1, 1][s]
    seeds = torch.tensor([[1, 1], [0, 2]])
    x, steps = reference.personalized(SRC, DST, 3, seeds, damping=0.85,
                                      tol=1e-14, max_iters=1000)
    for j, nodes in enumerate(([1], [0, 2])):
        v = np.zeros(3)
        v[nodes] = 1.0 / len(nodes)
        want = 0.15 * np.linalg.solve(np.eye(3) - 0.85 * a, v)
        assert x[:, j].numpy() == pytest.approx(want, abs=1e-12)
    assert bool((steps < 1000).all())


def test_personalized_stops_at_tol():
    x, steps = reference.personalized(SRC, DST, 3, torch.tensor([[1]]),
                                      damping=0.85, tol=1e-3, max_iters=50)
    assert 1 < int(steps[0]) < 50


def test_topk_gap():
    ref = torch.tensor([0.1, 0.5, 0.3, 0.3, 0.05], dtype=torch.float64)
    ids, scores = reference.top_k(ref, 3)
    assert ids.tolist() == [1, 2, 3]                 # ties: lower id first
    assert checks.topk_gap(ids, scores, ref, 3) == 0.0
    # a wrong id, reported with its true score: it lies 0.2 below the
    # third largest, over the top rank 0.5
    assert checks.topk_gap([1, 2, 0], [0.5, 0.3, 0.1], ref, 3) == \
        pytest.approx(0.4)
    # a right id with a wrong score
    assert checks.topk_gap([1, 2, 3], [0.5, 0.3, 0.35], ref, 3) == \
        pytest.approx(0.1)
    assert checks.topk_gap([1, 1, 2], [0.5, 0.5, 0.3], ref, 3) == math.inf
    assert checks.topk_gap([1, 2], [0.5, 0.3], ref, 3) == math.inf


def test_ranks_gaps_and_verdict():
    ref = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float64)
    assert checks.ranks_gaps(ref.float(), ref) == {"ranks_l1_rel": 0.0,
                                                   "ranks_max_rel": 0.0}
    g = checks.ranks_gaps(torch.tensor([0.25, 0.4, 0.35]), ref)
    assert g["ranks_l1_rel"] == pytest.approx(0.2, rel=1e-6)
    assert g["ranks_max_rel"] == pytest.approx(0.2, rel=1e-6)
    ok, out = checks.verdict({"a": 1.0, "b": math.nan}, {"a": 1.0, "b": 1.0})
    assert not ok and out["a"] == {"value": 1.0, "limit": 1.0}
