"""Graph data for the GNN shape regimes (``configs.GNN_SHAPES``): a
synthetic stand-in graph with a shape's node and edge counts, and a
``GraphBatch`` for a shape. The counterpart of the JAX package's
``data/graphdata.py``: the same draws from the same seed, so the arrays
are equal."""
from __future__ import annotations

import numpy as np

from ..configs.base import ShapeSpec
from ..graphs import generators
from ..graphs.sampler import _max_nodes
from ..models.gnn import GraphBatch, random_graph_batch


def graph_for_shape(shape: ShapeSpec, *, seed: int = 0):
    """A synthetic stand-in graph with the shape's node/edge counts."""
    return generators.uniform_random(shape.n_nodes, shape.n_edges,
                                     seed=seed)


def batch_for_shape(shape: ShapeSpec, *, seed: int = 0,
                    d_feat: int | None = None, n_classes: int = 16,
                    device=None) -> GraphBatch:
    """A random ``GraphBatch`` of the shape's regime on ``device``
    (default ``"cuda"``): ``batched_graphs`` as ``global_batch``
    disjoint graphs, ``minibatch`` at the sampler's padded sizes, else
    the whole graph."""
    rng = np.random.default_rng(seed)
    d = d_feat or shape.d_feat
    if shape.kind == "batched_graphs":
        return random_graph_batch(
            rng, shape.n_nodes * shape.global_batch,
            shape.n_edges * shape.global_batch, d,
            n_graphs=shape.global_batch, n_classes=n_classes, device=device)
    if shape.kind == "minibatch":
        n = _max_nodes(shape.batch_nodes, shape.fanout)
        e = sum(shape.batch_nodes * int(np.prod(shape.fanout[:i + 1]))
                for i in range(len(shape.fanout)))
        return random_graph_batch(rng, n, e, d, n_classes=n_classes,
                                  device=device)
    return random_graph_batch(rng, shape.n_nodes, shape.n_edges, d,
                              n_classes=n_classes, device=device)
