"""Node relabeling for locality (paper §VI-D1, GOrder experiments).

GOrder itself (Wei et al., SIGMOD'16) optimizes a sliding-window score
and is out of scope; the locality knob the paper studies is provided by
cheaper orderings that move compression ratio r the same direction:

- ``degree_order``:   hub-first labeling (helps skewed graphs)
- ``bfs_order``:      BFS from max-degree seed (clusters neighborhoods)
- ``hybrid_order``:   BFS over a degree-bucketed queue — the GOrder
                      stand-in.
"""
from __future__ import annotations

import numpy as np

from .formats import Graph


def degree_order(g: Graph) -> np.ndarray:
    """perm[old_id] = new_id, descending total degree."""
    rank = np.argsort(-(g.out_degree + g.in_degree), kind="stable")
    perm = np.empty(g.num_nodes, dtype=np.int32)
    perm[rank] = np.arange(g.num_nodes, dtype=np.int32)
    return perm


def bfs_order(g: Graph) -> np.ndarray:
    """BFS labeling over the undirected view, restarting at the
    highest-degree unvisited node (handles disconnected graphs)."""
    n = g.num_nodes
    offsets, indices = _undirected_csr(g)
    visited = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int32)
    order_seed = np.argsort(-(g.out_degree + g.in_degree), kind="stable")
    label = 0
    for seed in order_seed:
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            next_queue = []
            for u in queue:
                perm[u] = label
                label += 1
                nbrs = indices[offsets[u]:offsets[u + 1]]
                fresh = np.unique(nbrs[~visited[nbrs]])  # dedupe multi-edges
                visited[fresh] = True
                next_queue.extend(fresh.tolist())
            queue = next_queue
    return perm


def hybrid_order(g: Graph) -> np.ndarray:
    """Degree-bucketed BFS: BFS traversal, but each frontier is visited
    hub-first so high-degree nodes land near their followers."""
    n = g.num_nodes
    offsets, indices = _undirected_csr(g)
    deg = (g.out_degree + g.in_degree).astype(np.int64)
    visited = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int32)
    label = 0
    for seed in np.argsort(-deg, kind="stable"):
        if visited[seed]:
            continue
        frontier = np.array([seed], dtype=np.int64)
        visited[seed] = True
        while frontier.size:
            frontier = frontier[np.argsort(-deg[frontier], kind="stable")]
            perm[frontier] = np.arange(label, label + frontier.size)
            label += frontier.size
            nxt = []
            for u in frontier:
                nbrs = indices[offsets[u]:offsets[u + 1]]
                fresh = np.unique(nbrs[~visited[nbrs]])  # dedupe multi-edges
                visited[fresh] = True
                nxt.append(fresh)
            frontier = (np.concatenate(nxt) if nxt
                        else np.array([], dtype=np.int64))
    return perm


# ---------------------------------------------------------------------------
# Registry — what PlanConfig(reorder=...) resolves through (core/plan.py)
# ---------------------------------------------------------------------------
ORDERINGS = {
    "degree": degree_order,
    "bfs": bfs_order,
    "hybrid": hybrid_order,
}


def available_orderings() -> tuple[str, ...]:
    """Every valid ``PlanConfig.reorder`` value (``"none"`` included)."""
    return ("none",) + tuple(sorted(ORDERINGS))


def reorder_permutation(g: Graph, name: str) -> np.ndarray:
    """The ``perm[old_id] = new_id`` permutation for ordering ``name``
    (memoized on the graph instance — a pcpm and a pcpm_pallas plan of
    the same reordered graph compute the BFS once)."""
    if name not in ORDERINGS:
        raise ValueError(f"unknown ordering {name!r}; valid: "
                         f"{available_orderings()}")
    key = f"_reorder_perm_{name}"
    perm = g.__dict__.get(key)
    if perm is None:
        perm = ORDERINGS[name](g).astype(np.int32)
        g.__dict__[key] = perm       # frozen-safe: dict write
    return perm


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv[new_id] = old_id`` — maps internal-space vectors/ids back
    to the original labeling (``x_orig = x_int[perm]``,
    ``id_orig = inv[id_int]``)."""
    inv = np.empty(len(perm), dtype=np.int32)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return inv


def _undirected_csr(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    order = np.argsort(src, kind="stable")
    offsets = np.zeros(g.num_nodes + 1, dtype=np.int64)
    np.add.at(offsets, src + 1, 1)
    np.cumsum(offsets, out=offsets)
    return offsets, dst[order]
