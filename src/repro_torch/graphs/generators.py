"""Synthetic graph generators.

``rmat`` mirrors the Graph500 Kronecker generator used for the paper's
*kron* dataset (scale 25, edge factor ~31). All generators are
deterministic given ``seed`` and draw from numpy's ``default_rng``, so a
seed gives the same edges as the JAX package's generators.
"""
from __future__ import annotations

import numpy as np

from .formats import Graph, from_edge_list


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         dedup: bool = False) -> Graph:
    """R-MAT / Graph500 Kronecker graph: 2**scale nodes."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        # quadrant choice per Graph500 reference
        go_right = r >= ab            # column bit set
        go_down = ((r >= a) & (r < ab)) | (r >= abc)  # row bit set
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    # permute vertex labels so degree is not correlated with ID
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    if dedup:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return Graph(n, src.astype(np.int32), dst.astype(np.int32))


def uniform_random(num_nodes: int, num_edges: int, *, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    return Graph(num_nodes, src.astype(np.int32), dst.astype(np.int32))


def power_law(num_nodes: int, avg_degree: int, *, exponent: float = 2.1,
              seed: int = 0) -> Graph:
    """Chung-Lu style power-law graph (degree ~ pareto)."""
    rng = np.random.default_rng(seed)
    w = rng.pareto(exponent - 1.0, num_nodes) + 1.0
    p = w / w.sum()
    m = num_nodes * avg_degree
    src = rng.choice(num_nodes, size=m, p=p).astype(np.int32)
    dst = rng.choice(num_nodes, size=m, p=p).astype(np.int32)
    return Graph(num_nodes, src, dst)


def grid_2d(rows: int, cols: int) -> Graph:
    """4-neighbor grid, both directions (high locality — the paper's
    *web*-like regime when labeled row-major)."""
    idx = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:, 1:].ravel(), idx[:, :-1].ravel()], 1),
         np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
         np.stack([idx[1:, :].ravel(), idx[:-1, :].ravel()], 1)]
    return from_edge_list(rows * cols, np.concatenate(e, 0))
