"""The residual-push loop — shared home of the delta push (the streaming
slice) and the query push (serve/push.py).

The query push seeds ``pr0 = seed`` and ``r0 = x1 - x0``, the first
power-iteration step from the seed, so the push iterates are exactly
the masked chunk stepper's iterates for the same query (same x0, same
operator), and its stopping rule ``‖r‖₁ < tol`` is the stepper's
per-step L1-change rule: equal tolerances mean equal stopping accuracy
(final L1 distance to the fixed point ≤ tol·d/(1−d) either way).

The loop runs over the plan's ``spmv_fn`` on its device, for every
method (on pcpm_pallas plans an (n,) push runs kernel B1's "tile" path
at d = 1). ``tol`` and ``max_push`` are data. Torch has no traced
``while_loop``: the stopping test is one host read of ``‖r‖₁`` per
sweep. The JAX package runs pcpm plans through a separate loop that
takes the streams as arguments, padded into shape buckets so one
compiled loop serves patched plans; nothing is compiled here, so the
plan's own SpMV serves.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .backends import fused_loop_cache, spmv_fn
from .plan import GraphPlan

# residuals ring size; ``max_push`` is data clamped to this
MAX_PUSH_BUF = 400


def _push_while(pr, r, inv_deg, tol, max_push, spmv, *, num_nodes: int,
                damping: float, dangling: str):
    """The push loop body — single home of the stopping rule, the
    residual ring and the dangling handling. ``pr`` is updated in place
    (the JAX package donates it) and returned with the sweep count, the
    (MAX_PUSH_BUF,) ring of pre-push ‖r‖₁ (-1.0 in unused slots) and the
    remaining residual vector."""
    if dangling == "redistribute":
        dang = (inv_deg == 0).to(pr.dtype)
    residuals = torch.full((MAX_PUSH_BUF,), -1.0, dtype=torch.float32,
                           device=pr.device)
    tol32 = float(np.float32(tol))        # compared in float32, as there
    limit = min(int(max_push), MAX_PUSH_BUF)
    work = torch.empty_like(r)
    it = 0
    while it < limit:
        rn = r.abs().sum()
        if float(rn) < tol32:             # the one host read per sweep
            break
        residuals[it] = rn
        pr.add_(r)
        r_next = spmv(torch.mul(r, inv_deg, out=work)).mul_(damping)
        if dangling == "redistribute":
            r_next.add_((r * dang).sum() * (damping / num_nodes))
        r = r_next
        it += 1
    return pr, it, residuals, r


def residual_push_loop(plan: GraphPlan, *, damping: float = 0.85,
                       dangling: str = "none", device=None):
    """The plan's push loop on ``device`` (default ``"cuda"``):
    ``run(pr, r, inv_deg, tol, max_push) -> (pr, sweeps, residuals,
    r_out)`` with ``pr`` updated in place; ``residuals`` is a
    (MAX_PUSH_BUF,) device tensor of the per-sweep pre-push ‖r‖₁ (-1.0
    in unused slots) and ``r_out`` the remaining residual vector (its
    norm is < tol iff the loop converged). Cached on the plan."""
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    dev = resolve_device(device)
    key = ("push", str(dev), damping, dangling)
    cache = fused_loop_cache(plan)
    cached = cache.get(key)
    if cached is not None:
        return cached

    n = plan.num_nodes
    spmv = spmv_fn(plan, dev)

    def run(pr, r, inv_deg, tol, max_push):
        return _push_while(pr, r, inv_deg, tol, max_push, spmv,
                           num_nodes=n, damping=damping, dangling=dangling)

    cache[key] = run
    return run


def seed_query_state(plan: GraphPlan, *, damping: float = 0.85,
                     dangling: str = "none", device=None):
    """The plan's query seeding on ``device``: ``init(seed, inv_deg) ->
    (pr0, r0)`` with ``pr0 = seed`` (the same tensor: hand it a buffer
    the push loop may update) and ``r0 = x1 − x0``, the first
    power-iteration step from the seed, so ``residual_push_loop`` walks
    the chunk stepper's iterates for the same query. Cached on the
    plan."""
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    dev = resolve_device(device)
    key = ("push_seed", str(dev), damping, dangling)
    cache = fused_loop_cache(plan)
    cached = cache.get(key)
    if cached is not None:
        return cached

    spmv = spmv_fn(plan, dev)
    n = plan.num_nodes

    def init(seed, inv_deg):
        x1 = spmv(seed * inv_deg).mul_(damping).add_((1.0 - damping) * seed)
        if dangling == "redistribute":
            dang = (inv_deg == 0).to(seed.dtype)
            x1.add_((seed * dang).sum() * (damping / n))
        return seed, x1.sub_(seed)

    cache[key] = init
    return init
