"""Power iteration over the arcs, in any floating type.

The semantics are the paper's (and the port's): ranks start uniform,
each iteration is ``x' = damping * A^T (x / out_degree) + (1 - damping)
* v`` with ``v`` the teleport distribution, and the rank mass of nodes
without out-arcs is dropped. ``A^T y`` is one ``index_add_`` of
``y[src]`` into ``dst``, over blocks of arcs so that the gathered rows
stay near ``EDGE_BLOCK_BYTES``.
"""
from __future__ import annotations

import torch

EDGE_BLOCK_BYTES = 1 << 30


def inverse_out_degree(src: torch.Tensor, n: int,
                       dtype: torch.dtype) -> torch.Tensor:
    deg = torch.bincount(src, minlength=n).to(torch.float64)
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg)).to(dtype)


def gather_add(src: torch.Tensor, dst: torch.Tensor, y: torch.Tensor,
               n: int) -> torch.Tensor:
    """``A^T y``: out[dst[e]] += y[src[e]] for every arc e."""
    out = torch.zeros((n,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    row_bytes = y[:1].numel() * y.element_size()
    block = max(1, EDGE_BLOCK_BYTES // row_bytes)
    for lo in range(0, src.shape[0], block):
        out.index_add_(0, dst[lo:lo + block],
                       y.index_select(0, src[lo:lo + block]))
    return out


def pagerank(src: torch.Tensor, dst: torch.Tensor, n: int, *,
             damping: float, iterations: int,
             dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Global PageRank after ``iterations`` steps from uniform ranks,
    computed in ``dtype``."""
    src, dst = src.long(), dst.long()
    inv = inverse_out_degree(src, n, dtype)
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    base = (1.0 - damping) / n
    for _ in range(iterations):
        x = gather_add(src, dst, x * inv, n).mul_(damping).add_(base)
    return x


def teleport(seeds: torch.Tensor, n: int, dtype: torch.dtype
             ) -> torch.Tensor:
    """(n, q) teleport columns: column j is uniform over the distinct
    nodes of ``seeds[j]``."""
    q = seeds.shape[0]
    v = torch.zeros((n, q), dtype=torch.float64, device=seeds.device)
    cols = torch.arange(q, device=seeds.device)[:, None].expand_as(seeds)
    v[seeds.long().reshape(-1), cols.reshape(-1)] = 1.0
    return (v / v.sum(0, keepdim=True)).to(dtype)


def personalized(src: torch.Tensor, dst: torch.Tensor, n: int,
                 seeds: torch.Tensor, *, damping: float, tol: float,
                 max_iters: int, dtype: torch.dtype = torch.float64):
    """Personalized PageRank of each row of ``seeds`` (q, k) node ids:
    the iteration starts at the teleport column and a column stops once
    its L1 step change falls below ``tol`` or after ``max_iters``
    steps. Returns the (n, q) ranks and each column's step count."""
    src, dst = src.long(), dst.long()
    inv = inverse_out_degree(src, n, dtype)[:, None]
    v = teleport(seeds, n, dtype)
    x = v.clone()
    steps = torch.zeros(seeds.shape[0], dtype=torch.int64,
                        device=src.device)
    active = torch.ones(seeds.shape[0], dtype=torch.bool,
                        device=src.device)
    for _ in range(max_iters):
        nxt = gather_add(src, dst, x * inv, n).mul_(damping)
        nxt.add_(v * (1.0 - damping))
        step = (nxt - x).abs().sum(0).to(torch.float64)
        x = torch.where(active[None, :], nxt, x)
        steps += active.to(torch.int64)
        active &= step >= tol
        if not bool(active.any()):
            break
    return x, steps


def top_k(col: torch.Tensor, k: int):
    """(ids, scores) of the ``k`` largest entries: score descending,
    then lowest id."""
    scores, ids = torch.sort(col, descending=True, stable=True)
    return ids[:k], scores[:k]
