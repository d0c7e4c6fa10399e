"""The frozen generators give fixed arrays and statistics for a seed
(on the CPU's generator; the card's stream differs)."""
import hashlib

import numpy as np
import pytest
import torch

from bench.gen import kron, urand

KRON = {"scale": 8, "edge_factor": 4, "a": 0.57, "b": 0.19, "c": 0.19}
URAND = {"scale": 8, "degree": 4}


def digest(src, dst):
    return hashlib.sha256(src.numpy().tobytes()
                          + dst.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("seed,want,m,max_out", [
    (5, "3b4f24f132e791a1", 1480, 88),
    (2 ** 31 + 12345, "317b923c4da524fe", 1442, 98),
])
def test_kron_fixed_for_a_seed(seed, want, m, max_out):
    n, src, dst = kron.make(KRON, seed, "cpu")
    assert n == 256 and src.dtype == dst.dtype == torch.int32
    assert src.shape == dst.shape == (m,)
    assert digest(src, dst) == want
    assert int(np.bincount(src.numpy(), minlength=n).max()) == max_out
    s, d = src.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    assert not (s == d).any()                          # no self-loops
    keys = s * n + d
    assert len(np.unique(keys)) == len(keys)           # no repeats
    assert np.array_equal(np.sort(keys), np.sort(d * n + s))   # both ways
    assert m < 2 * n * KRON["edge_factor"]
    n2, src2, dst2 = kron.make(KRON, seed, "cpu")
    assert torch.equal(src, src2) and torch.equal(dst, dst2)


def test_kron_skew():
    """R-MAT's quadrant rule: the busiest quarter of the nodes holds
    most of the arcs' sources."""
    n, src, _ = kron.make(dict(KRON, scale=12, edge_factor=8), 3, "cpu")
    deg = np.sort(np.bincount(src.numpy(), minlength=n))[::-1]
    assert deg[: n // 4].sum() > 0.6 * deg.sum()


@pytest.mark.parametrize("seed,want,m", [
    (5, "f1c10900e27ec535", 2006),
    (2 ** 31 + 12345, "3b48e87fae7f654e", 2002),
])
def test_urand_fixed_for_a_seed(seed, want, m):
    n, src, dst = urand.make(URAND, seed, "cpu")
    assert n == 256 and src.shape == (m,) and digest(src, dst) == want
    s, d = src.numpy().astype(np.int64), dst.numpy().astype(np.int64)
    assert not (s == d).any()                          # no self-loops
    keys = s * n + d
    assert len(np.unique(keys)) == len(keys)           # no repeats
    assert np.array_equal(np.sort(keys), np.sort(d * n + s))   # both ways
    assert m <= 2 * n * URAND["degree"]
