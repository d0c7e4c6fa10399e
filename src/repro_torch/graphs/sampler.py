"""Layered neighbor sampler (GraphSAGE-style) for the ``minibatch_lg``
shape regime: batch_nodes seeds, fanout per hop, fixed-size padded output
so the sampled subgraph has a static shape.

Host numpy, a copy of the JAX package's ``graphs/sampler.py`` with two
repairs. (1) The reference draws each hop's neighbours with
``rng.integers(0, max(deg, 1), size=(|F|, f))``: the bounds (|F|,) do not
broadcast against (|F|, f) unless |F| == f, and then bound column j by
node j's degree. Here each row takes its own node's bound ((|F|, 1)), so
every sampled edge is an edge of the graph. (2) A frontier node without
in-edges reads ``indices[offsets[v]]`` before its row is masked, past the
end when every later node has no in-edges too; the read is clamped into
the array (its value is never used). Where the reference's draw is right
(one node a hop, fanout 1) the two consume the ``np.random.Generator``
alike and give the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import Graph


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Static-shape padded subgraph.

    nodes:      (max_nodes,)  global node ids (pad = 0, masked)
    node_mask:  (max_nodes,)  validity
    edge_src/edge_dst: (max_edges,) LOCAL indices into `nodes`
    edge_mask:  (max_edges,)
    seed_count: number of seed (layer-0 output) nodes == batch_nodes
    """
    nodes: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seed_count: int


def sample_neighbors(g: Graph, seeds: np.ndarray, fanouts: tuple[int, ...],
                     *, rng: np.random.Generator) -> SampledSubgraph:
    """In-neighbor sampling: hop h samples ``fanouts[h]`` in-neighbors of
    the current frontier.  Output sizes are the deterministic maxima
    implied by (len(seeds), fanouts), independent of the draw."""
    offsets, indices = g.csc  # in-neighbors
    layers = [np.asarray(seeds, dtype=np.int64)]
    edge_chunks = []  # (src_global, dst_global) per hop
    frontier = layers[0]
    for f in fanouts:
        deg = offsets[frontier + 1] - offsets[frontier]
        # sample f in-neighbors (with replacement where deg>0), each row
        # bounded by its own node's in-degree
        draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(len(frontier), f))
        pos = offsets[frontier, None] + draw
        src = indices[np.minimum(pos, max(len(indices) - 1, 0))]  # (|F|, f)
        valid = (deg > 0)[:, None] & np.ones_like(draw, dtype=bool)
        dst = np.broadcast_to(frontier[:, None], src.shape)
        edge_chunks.append((src[valid], dst[valid], len(frontier) * f))
        frontier = np.unique(src[valid])
        layers.append(frontier)

    max_nodes = _max_nodes(len(seeds), fanouts)
    max_edges = sum(c[2] for c in edge_chunks)

    all_src = np.concatenate([c[0] for c in edge_chunks])
    all_dst = np.concatenate([c[1] for c in edge_chunks])
    nodes, inv = np.unique(np.concatenate([layers[0], all_src, all_dst]),
                           return_inverse=True)
    # remap seeds to the front so layer-0 outputs are nodes[:seed_count]
    seed_local = inv[:len(seeds)]
    perm = np.full(len(nodes), -1, dtype=np.int64)
    perm[seed_local] = np.arange(len(seeds))
    rest = np.where(perm < 0)[0]
    perm[rest] = len(seeds) + np.arange(len(rest))
    nodes_out = np.zeros(max_nodes, dtype=np.int32)
    node_mask = np.zeros(max_nodes, dtype=bool)
    nodes_out[perm] = nodes
    node_mask[:len(nodes)] = True

    e_src = np.zeros(max_edges, dtype=np.int32)
    e_dst = np.zeros(max_edges, dtype=np.int32)
    e_mask = np.zeros(max_edges, dtype=bool)
    ne = len(all_src)
    e_src[:ne] = perm[inv[len(seeds):len(seeds) + ne]]
    e_dst[:ne] = perm[inv[len(seeds) + ne:]]
    e_mask[:ne] = True
    return SampledSubgraph(nodes_out, node_mask, e_src, e_dst, e_mask,
                           len(seeds))


def _max_nodes(n_seeds: int, fanouts: tuple[int, ...]) -> int:
    total, frontier = n_seeds, n_seeds
    for f in fanouts:
        frontier *= f
        total += frontier
    return total


def minibatch_stream(g: Graph, batch_nodes: int, fanouts: tuple[int, ...],
                     *, seed: int = 0):
    """Infinite deterministic stream of sampled minibatches."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    while True:
        seeds = rng.choice(n, size=batch_nodes, replace=False)
        yield sample_neighbors(g, seeds, fanouts, rng=rng)
