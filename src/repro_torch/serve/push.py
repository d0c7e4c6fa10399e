"""Forward-push personalized-query backend.

The masked chunk stepper answers every personalized query with a full
(n, B) power iteration. For a single-seed top-k query that is the wrong
unit of work: forward push (Zhang et al., arXiv:2302.03245) propagates
only the query's residual. ``SlotScheduler.submit`` routes
loose-tolerance top-k personalized queries here
(``core.backends.Backend.supports_push_query``) with an honest fallback
to the stepper. A port of the JAX package's ``serve/push.py``.

**Seeding.** The stepper starts a personalized query at ``x0 = seed``
and iterates ``x_{k+1} = base + d·Op(x_k)`` with ``base = (1−d)·seed``,
stopping on the per-step L1 change ``‖x_{k+1} − x_k‖₁ < tol``. Seeding
the push at ``pr0 = x0 = seed``, ``r0 = x1 − x0`` makes the push
residuals exactly the stepper's per-step changes, and equal tolerances
mean equal stopping accuracy: final L1 distance to the fixed point
≤ tol·d/(1−d) either way.

**Host path** (``mode="host"``; what ``"auto"`` picks without an engine
or with one on the CPU). The same
iteration runs on the host on a damped scipy CSR over the core subgraph
(nodes with out-edges): under ``dangling="none"`` a dangling node
absorbs mass and emits nothing, so its exact rank is reconstructed after
convergence in one matvec, ``x*_d = (1−d)·seed_d + W_dc @ x*_c``. The
core stop test ``‖r_c‖₁·(1+d) < tol`` covers the stepper's full-vector
rule (the dangling rows' step change is ≤ d·‖r_c‖₁). Near the target a
certified Aitken step extrapolates along the dominant eigendirection:
for this linear iteration the extrapolated residual
``(1+γ)·(W_cc r) − γ·r`` is the exact residual of the extrapolated
iterate, so the cheaper of (plain, extrapolated) is taken by comparing
true residual norms.

**Device path** (``mode="device"``; what ``"auto"`` picks for an engine
on the card): the plan's residual-push loop (core/push.py) on the
engine's device, re-seeded per query into a state buffer the engine
allocates once. The JAX package's ``"auto"`` picks the host whenever
scipy imports; here the push runs where the plan lives, since a host
sweep over a card-sized graph is a one-core matvec over every edge.

``PushResult.work_nnz`` reports edges touched (matvecs × nnz). A query
whose push exits above its bound is not served from the estimate: the
scheduler re-admits it to the stepper warm-started at the estimate,
carrying the consumed sweeps against its budget
(``metrics.counters["push_fallbacks"]``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from ..core.pagerank import _inv_degree
from ..core.push import (MAX_PUSH_BUF, residual_push_loop,
                         seed_query_state)
from ..graphs.formats import Graph, validate_graph
from .topk import host_topk

PUSH_MODES = ("auto", "host", "device")


def _csr_matvec_into(A):
    """``mv(x, out) -> out`` computing ``A @ x`` into a caller-owned
    buffer.  The serving fast path answers thousands of queries/sec,
    each a handful of tiny matvecs — scipy's ``__matmul__`` dispatch
    (type checks, shape plumbing, fresh output allocation) costs more
    than the kernel at that size, so bind the raw sparsetools kernel
    when available and fall back to the operator when not."""
    try:
        from scipy.sparse import _sparsetools
        kernel = _sparsetools.csr_matvec
        m, n = A.shape
        indptr, indices, data = A.indptr, A.indices, A.data

        def mv(x, out):
            out.fill(0.0)                 # kernel accumulates into out
            kernel(m, n, indptr, indices, data, x, out)
            return out
    except (ImportError, AttributeError):  # pragma: no cover - pinned
        def mv(x, out):
            out[:] = A @ x
            return out
    return mv


@dataclasses.dataclass
class PushResult:
    """One answered push query.  ``residual`` is the stepper-comparable
    stopping bound (an upper bound on the equivalent per-step L1
    change), so ``converged`` means what the stepper's flag means."""
    estimate: np.ndarray                     # (n,) personalized ranks
    sweeps: int
    residual: float
    converged: bool
    mode: str                                # "host" | "device"
    work_nnz: int                            # edges touched (cost model)
    top_ids: Optional[np.ndarray] = None     # (k,) int32 when top_k set
    top_scores: Optional[np.ndarray] = None  # (k,) float32


class PushQueryEngine:
    """Per-graph forward-push query answerer.

    ``mode="host"`` runs the core-subgraph scipy loop (the serving fast
    path), ``mode="device"`` re-seeds the plan's push loop
    (core/push.py) per query on the engine's device, the right path once
    per-sweep O(m) work outgrows the per-sweep launch and read cost.
    ``mode="auto"`` picks device for an engine on a CUDA device, host
    otherwise (no engine, or an engine on the CPU).

    Only ``dangling="none"`` is supported: the exact dangling
    reconstruction (and the stepper-iterate equivalence above) relies
    on sinks absorbing mass.  The scheduler routes ``redistribute``
    configurations to the stepper.
    """

    def __init__(self, g: Graph, engine=None, *, damping: float = 0.85,
                 dangling: str = "none", mode: str = "auto",
                 aitken_factor: float = 100.0):
        if dangling != "none":
            raise ValueError(
                "push query backend requires dangling='none' (sink "
                f"reconstruction is exact only there); got {dangling!r}")
        if mode not in PUSH_MODES:
            raise ValueError(f"mode must be one of {PUSH_MODES}; "
                             f"got {mode!r}")
        if engine is not None and mode != "host" \
                and not engine.backend.supports_push_query:
            raise ValueError(
                f"backend {engine.method!r} does not support push "
                "queries (supports_push_query=False)")
        validate_graph(g)
        self.g = g
        self.n = g.num_nodes
        self.damping = float(damping)
        self.dangling = dangling
        self.engine = engine
        self.aitken_factor = float(aitken_factor)
        if mode == "auto":
            on_card = engine is not None and engine.device.type == "cuda"
            mode = "device" if on_card else "host"
        if mode == "device" and engine is None:
            raise ValueError("mode='device' needs an SpMVEngine (the "
                             "push loop runs over its plan)")
        self.mode = mode
        self._host = None                 # (Wcc, Wdc, core_ids, dang_ids)
        self._dev = None                  # (init, run, inv_deg)

    # ------------------------------------------------------------- host
    def _host_state(self):
        if self._host is None:
            import scipy.sparse as sp
            g, d, n = self.g, self.damping, self.n
            deg = np.asarray(g.out_degree)
            core = deg > 0
            core_ids = np.nonzero(core)[0].astype(np.int64)
            dang_ids = np.nonzero(~core)[0].astype(np.int64)
            # position of each node inside its class (valid where the
            # class mask holds)
            core_pos = np.cumsum(core) - 1
            dang_pos = np.cumsum(~core) - 1
            nc, nd = len(core_ids), len(dang_ids)
            w = (d / np.maximum(deg, 1)).astype(np.float32)[g.src]
            to_core = core[g.dst]         # every src is core by def.
            Wcc = sp.csr_matrix(
                (w[to_core], (core_pos[g.dst[to_core]],
                              core_pos[g.src[to_core]])),
                shape=(nc, nc), dtype=np.float32)
            Wdc = sp.csr_matrix(
                (w[~to_core], (dang_pos[g.dst[~to_core]],
                               core_pos[g.src[~to_core]])),
                shape=(nd, nc), dtype=np.float32)
            # R0 = Wcc − d·I seeds the residual in ONE kernel call:
            # rc0 = (Wcc − d·I) @ sc = x1_c − x0_c
            R0 = (Wcc - sp.identity(nc, np.float32, format="csr")
                  * np.float32(d)).tocsr()
            bufs = tuple(np.empty(nc, np.float32) for _ in range(5)) \
                + (np.empty(nd, np.float32),)
            try:                           # BLAS hot-loop primitives:
                # sasum = L1 norm without the |x| temp, saxpy = fused
                # scaled accumulate — one C call each
                from scipy.linalg.blas import sasum, saxpy
            except ImportError:            # pragma: no cover - pinned
                def sasum(x):
                    return float(np.abs(x).sum())

                def saxpy(x, y, a=1.0):
                    y += np.float32(a) * x
                    return y
            self._host = (Wcc, Wdc, core_ids, dang_ids,
                          _csr_matvec_into(Wcc), _csr_matvec_into(Wdc),
                          _csr_matvec_into(R0), bufs, sasum, saxpy)
        return self._host

    def _query_host(self, seed: np.ndarray, *, tol: float,
                    max_sweeps: int):
        (Wcc, Wdc, core_ids, dang_ids, mv_cc, mv_dc, mv_r0,
         bufs, sasum, saxpy) = self._host_state()
        d = self.damping
        # preallocated per-engine scratch — queries are answered one at
        # a time on the serving thread, thousands/sec, so per-query
        # allocations and numpy dispatch are the actual cost here
        sc, xc, rc, y, ext, xd = bufs
        np.take(seed, core_ids, out=sc)
        xc[:] = sc
        # r0 restricted to the core: x1_c − x0_c = (Wcc − d·I)·sc (the
        # damping factor is baked into Wcc's values)
        mv_r0(sc, rc)
        rsum = sasum(rc)
        prev_rsum = None
        sweeps, matvecs = 0, 1
        near = self.aitken_factor * tol
        while rsum * (1.0 + d) >= tol and sweeps < max_sweeps:
            mv_cc(rc, y)
            matvecs += 1
            ay = sasum(y)
            took_ext = False
            if prev_rsum is not None and rsum < near and prev_rsum > 0:
                rho = rsum / prev_rsum
                if 0.05 < rho < 0.95:
                    gam = rho / (1.0 - rho)
                    # ext = (1+gam)·y − gam·rc: the EXACT residual of
                    # the extrapolated iterate (linearity), so picking
                    # the smaller true norm keeps the stop certified
                    np.multiply(rc, np.float32(-gam), out=ext)
                    saxpy(y, ext, a=1.0 + gam)
                    aext = sasum(ext)
                    if aext < ay:
                        saxpy(rc, xc, a=1.0 + gam)
                        prev_rsum, rsum = rsum, aext
                        rc, ext = ext, rc     # ext becomes scratch
                        took_ext = True
            if not took_ext:
                xc += rc
                prev_rsum, rsum = rsum, ay
                rc, y = y, rc                 # swap, no allocation
            sweeps += 1
        xc += rc                          # fold the final residual in
        est = np.zeros(self.n, np.float32)
        est[core_ids] = xc
        if dang_ids.size:
            # exact sink reconstruction — one matvec, never iterated
            mv_dc(xc, xd)
            xd += np.float32(1.0 - d) * seed[dang_ids]
            est[dang_ids] = xd
            matvecs += 1
        bound = rsum * (1.0 + d)
        work = matvecs * int(Wcc.nnz + Wdc.nnz)
        return est, sweeps, bound, bound < tol, work

    # ----------------------------------------------------------- device
    def _device_state(self):
        if self._dev is None:
            plan, dev = self.engine.plan, self.engine.device
            init = seed_query_state(plan, damping=self.damping,
                                    dangling=self.dangling, device=dev)
            run = residual_push_loop(plan, damping=self.damping,
                                     dangling=self.dangling, device=dev)
            # the (n,) state every query is re-seeded into: allocated
            # once per engine, updated in place by the push loop
            state = torch.empty(self.n, dtype=torch.float32, device=dev)
            self._dev = (init, run, _inv_degree(self.g, dev), state)
        return self._dev

    def _query_device(self, seed: np.ndarray, *, tol: float,
                      max_sweeps: int):
        init, run, inv_deg, state = self._device_state()
        state.copy_(torch.from_numpy(seed))
        pr, r = init(state, inv_deg)
        sweeps, remaining = 0, max_sweeps
        while True:
            pr, it, _, r = run(pr, r, inv_deg, tol,
                               min(remaining, MAX_PUSH_BUF))
            sweeps += it
            remaining -= it
            final = float(r.abs().sum())
            if final < tol or remaining <= 0 or it == 0:
                break
        # the full-vector push residual IS the stepper's per-step L1
        # change — no core/sink split, so no (1+d) slack needed
        est = (pr + r).cpu().numpy().astype(np.float32, copy=False)
        return (est, sweeps, final, final < tol,
                (sweeps + 1) * self.g.num_edges)

    # ------------------------------------------------------------ query
    def query(self, seed: np.ndarray, *, tol: float,
              max_sweeps: int = 100,
              top_k: int | None = None) -> PushResult:
        """Answer one personalized query.  ``seed`` is an (n,)
        normalized teleport distribution; ``tol``/``max_sweeps`` mean
        exactly what the stepper's ``tol``/``max_iters`` mean.  A
        result with ``converged=False`` (budget exhausted above the
        bound) should be treated as a warm start, not an answer —
        that is what the scheduler's fallback does."""
        if tol <= 0:
            raise ValueError("push queries need tol > 0 (tol=0 is the "
                             "stepper's fixed-budget mode)")
        seed = np.asarray(seed, dtype=np.float32).reshape(self.n)
        if self.mode == "host":
            est, sweeps, bound, conv, work = self._query_host(
                seed, tol=tol, max_sweeps=max_sweeps)
        else:
            est, sweeps, bound, conv, work = self._query_device(
                seed, tol=tol, max_sweeps=max_sweeps)
        ids = scores = None
        if top_k is not None and conv:
            ids, scores = host_topk(est, top_k)
        return PushResult(est, sweeps, bound, conv, self.mode, work,
                          top_ids=ids, top_scores=scores)
