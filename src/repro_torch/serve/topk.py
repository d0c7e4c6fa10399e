"""Top-k rank extraction on the device and on the host.

A "top 100 of graph X" query should ship 100 ids and 100 scores to the
host, not the full n-vector. ``make_slot_topk`` (alias ``slot_topk``, the
JAX package's name) takes one column of the (n_pad, B) slot pool (the
column index is data) and ranks it on its device; only the (k,) results
cross to the host. The pad rows of a sharded pool are masked out: only
the first ``num_nodes`` rows are ranked.

Ties break as ``jax.lax.top_k`` breaks them in the JAX package: equal
scores order by lower id. ``torch.topk`` promises no order among equal
values, so the device path sorts with ``torch.sort(stable=True)``, which
keeps equal scores in id order.
"""
from __future__ import annotations

import numpy as np
import torch


def topk_ranks(pr: torch.Tensor, k: int):
    """``(ids, scores)`` of the ``k`` highest values of an (n,) rank
    vector on its device: score descending, then lowest id. ``ids`` are
    int32."""
    scores, ids = torch.sort(pr, descending=True, stable=True)
    return ids[:k].to(torch.int32), scores[:k]


def make_slot_topk(num_nodes: int):
    """``topk(pr, col, k) -> (ids, scores)`` for an (n_pad, B) slot pool
    whose first ``num_nodes`` rows are the vertices (the rest are the
    pad rows of a sharded pool)."""

    def topk(pr: torch.Tensor, col: int, k: int):
        if pr.shape[0] < num_nodes:
            raise ValueError(f"slot pool has {pr.shape[0]} rows; expected "
                             f"at least {num_nodes}")
        return topk_ranks(pr[:num_nodes, col], k)

    return topk


slot_topk = make_slot_topk


def host_topk(ranks: np.ndarray, k: int):
    """Host-side top-k over an (n,) numpy estimate: the push query
    path's twin of ``make_slot_topk`` (push answers live on the host).
    Ties break like the device path: equal scores order by lower id."""
    ranks = np.asarray(ranks)
    n = ranks.shape[0]
    k = min(int(k), n)
    if k == n:
        idx = np.arange(n)
    else:
        # argpartition picks an arbitrary member of a score tie on the
        # k-th boundary; the device path takes the lowest id. Repair
        # only when a tie crosses the boundary.
        idx = np.argpartition(ranks, n - k)[n - k:]
        sel = ranks[idx]
        kth = sel.min()
        if (np.count_nonzero(ranks == kth)
                > np.count_nonzero(sel == kth)):
            strict = idx[sel > kth]
            ties = np.nonzero(ranks == kth)[0]  # ascending id order
            idx = np.concatenate([strict, ties[:k - strict.size]])
    order = np.lexsort((idx, -ranks[idx]))
    ids = idx[order].astype(np.int32)
    return ids, ranks[ids].astype(np.float32)
