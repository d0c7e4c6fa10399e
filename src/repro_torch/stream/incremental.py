"""Residual-push incremental PageRank (the JAX package's
``stream/incremental.py``; DESIGN.md §9).

PageRank is the solution of the linear system

    pr = base + d · Op(pr),       Op(x) = Aᵀ D⁻¹ x  (+ sink term)

so a converged vector for the OLD graph is an excellent approximation
for the NEW one: define the residual

    r₀ = F_new(pr_old) − pr_old = d · (Op_new − Op_old)(pr_old)

and the exact new solution is  pr_old + Σ_k (d·Op_new)ᵏ r₀ .

- **Sparse seed.** (Op_new − Op_old) is non-zero only in the operator
  columns of sources whose out-edge set changed, so r₀ is computed on
  the host from the CSR rows of the touched sources — O(changed
  degree), never O(M) (but see ``seed_residual``: the old graph's CSR
  is built on its first use).
- **Geometric push.** ‖d·Op(r)‖₁ ≤ d‖r‖₁, so pushing the WHOLE residual
  each sweep — one SpMV on the residual vector — contracts ‖r‖₁ by ≥ d
  per sweep and the sweep count is log(tol/‖r₀‖₁)/log(d), independent
  of graph size.

Stopping at ‖r‖₁ < tol leaves at most tol·d/(1−d) L1 error in the final
ranks, the same per-step L1-change rule as the fused cold driver, so
``tol`` means the same thing warm and cold.

The push runs ``core/push.py::residual_push_loop`` over the plan's SpMV
on its device (on a pcpm_pallas plan on the card, one launch of kernel
B1's "tile" path a sweep). The JAX package also keeps a bucketed pcpm
push (``_pcpm_push_streams``) so that one compiled XLA loop serves
patched plans; nothing is compiled here, so the plan's own SpMV serves.
When the seed is too heavy, ``update_ranks`` falls back to the fused
power iteration itself, warm-started at ``prev_pr``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backends import reorder_device
from ..core.pagerank import (PageRankResult, _inv_degree,
                             fused_power_iteration)
from ..core.plan import internal_graph, reorder_inverse, validate_plan
from ..core.push import MAX_PUSH_BUF, residual_push_loop  # noqa: F401
from ..core.spmv import SpMVEngine
from ..device import resolve_device
from ..graphs.formats import Graph
from .delta import GraphDelta, apply_delta, gather_ranges

# Seeds heavier than this (L1) go to the dense fused warm start: the
# push still converges, but at ~0.1 of total rank mass displaced the
# sweep count approaches a full power iteration's and the fused loop's
# tighter body wins.
DENSE_FALLBACK_L1 = 0.1


def seed_residual(g_old: Graph, g_new: Graph, delta: GraphDelta,
                  prev_pr: np.ndarray, *, damping: float = 0.85,
                  dangling: str = "none") -> np.ndarray:
    """r₀ = d·(Op_new − Op_old)(prev), computed sparsely.

    Only the operator columns of the delta's touched sources differ,
    and the new out-neighbour multiset of a touched u is
    ``N_old(u) − rem(u) + add(u)``, so with per-source weights
    ``w = d·prev[u]/deg[u]``:

        r₀ = Σ_{N_old(u)} (w_new − w_old)   over touched sources' CSR
           + w_new at every added edge's destination
           − w_new at every removed edge's destination

    which needs the OLD graph's CSR only (``g_old.csr``, built and
    memoized on the graph at its first use: one sort of its M edges).
    ``delta`` may be a plain concatenation of several batches: a
    removal matching an earlier insertion cancels term-for-term.
    Accumulated float64 on the host, returned float32.
    """
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    n = g_new.num_nodes
    prev = np.asarray(prev_pr, dtype=np.float64).reshape(n)
    r = np.zeros(n, dtype=np.float64)
    touched = np.asarray(delta.touched_sources(), dtype=np.int64)
    if touched.size == 0:
        return r.astype(np.float32)
    deg_old = g_old.out_degree[touched]
    deg_new = g_new.out_degree[touched]
    pv = damping * prev[touched]
    w_old = np.where(deg_old > 0, pv / np.maximum(deg_old, 1), 0.0)
    w_new = np.where(deg_new > 0, pv / np.maximum(deg_new, 1), 0.0)
    # over the old neighbour lists: weight change of surviving edges
    offs, idx = g_old.csr
    cnt = (offs[touched + 1] - offs[touched]).astype(np.int64)
    targets = idx[gather_ranges(offs[touched], cnt)]
    np.add.at(r, targets, np.repeat(w_new - w_old, cnt))
    # inserted / removed edges carry the NEW weight of their source
    # (touched is sorted-unique, so searchsorted is an exact lookup)
    if delta.num_added:
        pos = np.searchsorted(touched, delta.add_src)
        np.add.at(r, delta.add_dst, w_new[pos])
    if delta.num_removed:
        pos = np.searchsorted(touched, delta.rem_src)
        np.add.at(r, delta.rem_dst, -w_new[pos])
    if dangling == "redistribute":
        sink_shift = damping * (
            prev[touched[(deg_new == 0) & (deg_old > 0)]].sum()
            - prev[touched[(deg_old == 0) & (deg_new > 0)]].sum())
        if sink_shift != 0.0:
            r += sink_shift / n
    return r.astype(np.float32)


def update_ranks(plan, delta: GraphDelta, prev_pr, *,
                 g_old: Graph, g_new: Graph | None = None,
                 damping: float = 0.85, dangling: str = "none",
                 tol: float = 1e-8, max_push: int = 200,
                 dense_threshold: float = DENSE_FALLBACK_L1,
                 device=None) -> PageRankResult:
    """Patch ``prev_pr`` (converged ranks of ``g_old``: a tensor or an
    array) into the ranks of ``g_new`` = ``g_old`` + ``delta``, on
    ``device`` (default ``"cuda"``).

    ``plan`` must already be the NEW graph's plan (see
    ``stream.patch.patch_plan`` / ``Session.apply_delta``); ``delta``
    may be a concatenation of several batches relative to ``g_old``
    (``GraphDelta.__add__``). ``tol`` is the L1 stopping residual — the
    same per-step L1-change rule the fused cold driver uses, so equal
    tolerances mean equal stopping accuracy warm and cold (final L1
    distance to the fixed point ≤ tol·d/(1−d) either way).
    """
    dev = resolve_device(device)
    if g_new is None:
        g_new = apply_delta(g_old, delta)
    validate_plan(g_new, plan)

    # one host fetch serves both the float64 seed accumulation and the
    # fresh float32 device copy (the push updates its ranks in place)
    if isinstance(prev_pr, torch.Tensor):
        prev_pr = prev_pr.detach().cpu().numpy()
    prev_host = np.array(prev_pr, dtype=np.float32)
    r0 = seed_residual(g_old, g_new, delta, prev_host,
                       damping=damping, dangling=dangling)
    r1 = float(np.abs(r0, dtype=np.float64).sum())
    # locality-reordered plans: the plan's streams index the RELABELED
    # graph, so the push/fused loops iterate in internal space. The
    # graphs and the residual seed stay original — only the VECTORS
    # permute in, and the ranks gather back once at the end.
    perm = plan.reorder_perm
    if perm is not None:
        inv = reorder_inverse(plan)
        prev_host, r0 = prev_host[inv], r0[inv]
        g_iter = internal_graph(g_new, plan)
    else:
        g_iter = g_new

    def _out(ranks):
        if perm is None:
            return ranks
        return ranks.index_select(0, reorder_device(plan, dev)[0])

    prev = torch.from_numpy(prev_host).to(dev)
    if r1 < tol:
        # already inside the stopping rule; still fold the first-order
        # correction in (free accuracy, one vector add)
        ranks = prev + torch.from_numpy(r0).to(dev) if r1 > 0.0 else prev
        return PageRankResult(_out(ranks), 0, [r1])

    if r1 > dense_threshold:
        # delta too heavy for the geometric-push argument — run the
        # fused driver, still warm-started at the previous ranks
        eng = SpMVEngine(g_new, plan=plan, device=dev)
        run = fused_power_iteration(eng, damping=damping,
                                    num_iterations=max_push, tol=tol,
                                    check_every=1, dangling=dangling)
        n = g_new.num_nodes
        base = torch.full((n,), (1.0 - damping) / n, dtype=torch.float32,
                          device=dev)
        pr, it, res = run(prev, _inv_degree(g_iter, dev), base)
        res_host = res[:it].cpu().numpy()
        return PageRankResult(_out(pr), int(it),
                              [float(x) for x in res_host if x >= 0.0])

    run = residual_push_loop(plan, damping=damping, dangling=dangling,
                             device=dev)
    pr, r_dev = prev, torch.from_numpy(r0).to(dev)
    inv_deg = _inv_degree(g_iter, dev)
    sweeps, remaining, res_list = 0, max_push, []
    while True:
        # the loop holds a MAX_PUSH_BUF residual ring; larger budgets
        # re-invoke it with the carried residual vector, so max_push
        # means exactly what num_iterations means cold
        pr, it, res, r_dev = run(pr, r_dev, inv_deg, tol,
                                 min(remaining, MAX_PUSH_BUF))
        sweeps += it
        remaining -= it
        res_list += [float(x) for x in res[:it].cpu().numpy() if x >= 0.0]
        final = float(r_dev.abs().sum())
        if final < tol or remaining <= 0 or it == 0:
            break
    # append the post-push norm so residuals[-1] reads like the cold
    # driver's: < tol iff converged (not merely budget-exhausted)
    return PageRankResult(_out(pr), sweeps, res_list + [final])
