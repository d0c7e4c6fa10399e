"""Measured communication accounting (a port of the JAX package's
``obs/comm.py``; DESIGN.md §14).

``core/comm_model.py`` carries the paper's §V napkin math (eqs. 3-10) — a
PREDICTION from (n, m, k, r). This module produces the matching
MEASUREMENT from a live plan: it enumerates the arrays one SpMV pass
streams, at their real, padded sizes, and multiplies by the pass counts
the solvers report. The byte counts are the JAX package's, array for
array: the port's host arrays are equal to its.

Accounting rules:

- ``dram`` streams count bytes the paper's model also counts: index
  streams once, value streams per vector column (``ncols`` — the
  multi-vector batch reuses every index stream across B columns).
- Measured sizes include padding the model ignores: the gather
  schedule's block-padded edge stream ``Mp >= M`` and padded piece
  table. Padding is traffic.
- ``onchip`` streams are expected to be cache-resident (per-partition
  bins during the blocked gather, piece bounds) and are reported
  separately rather than dropped or added.
- Random-access counters mirror eqs. (8)-(10): the element-granularity
  gathers/scatters the implementation issues.

A ``pcpm_pallas`` plan raises ``ValueError`` here as in the JAX package
(it carries the blocked layout, not the ``schedule`` this module
enumerates), and ``CommAccountant`` skips it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..core import comm_model

D_V = 4   # float32 rank values
D_I = 4   # int32 indices


@dataclasses.dataclass(frozen=True)
class CommBreakdown:
    """Bytes one SpMV pass moves, from actual plan array sizes."""

    method: str
    n: int
    m: int
    ncols: int
    dram: dict          # stream name -> bytes/pass (model-comparable)
    onchip: dict        # cache-expected traffic, reported not summed
    gather_ops: int     # element-granularity gathers issued per pass
    scatter_ops: int    # element-granularity scatter-adds per pass

    @property
    def dram_bytes(self) -> int:
        return sum(self.dram.values())

    @property
    def onchip_bytes(self) -> int:
        return sum(self.onchip.values())

    def to_dict(self) -> dict:
        return {"method": self.method, "n": self.n, "m": self.m,
                "ncols": self.ncols, "dram_bytes": self.dram_bytes,
                "onchip_bytes": self.onchip_bytes,
                "dram": dict(self.dram), "onchip": dict(self.onchip),
                "gather_ops": self.gather_ops,
                "scatter_ops": self.scatter_ops}


def measure_plan(plan, ncols: int = 1) -> CommBreakdown:
    """Enumerate the arrays one pass of ``plan``'s SpMV streams, from the
    same arrays ``plan_nbytes`` accounts, so a padded schedule shows up
    at its padded size."""
    n, m = plan.num_nodes, plan.num_edges
    method = plan.config.method
    c = ncols
    dram: dict = {}
    onchip: dict = {}

    if method == "pcpm" and plan.png is not None:
        png, sched = plan.png, plan.schedule
        U = int(len(png.update_src))
        if sched is not None:
            Mp = int(len(sched.edge_update_idx_padded))
            P0 = int(len(sched.piece_start))
        else:
            Mp = int(len(png.edge_update_idx))
            P0 = 0
        # scatter: read the update-source list, gather x, write one bin
        # per update; gather: stream the (padded) edge->update index
        # list and read each bin back once from DRAM — the expansion to
        # edge granularity hits the per-partition bin working set (the
        # paper's cache-residency argument)
        dram["update_src_read"] = U * D_I
        dram["x_gather"] = U * D_V * c
        dram["bins_write"] = U * D_V * c
        dram["bins_read"] = U * D_V * c
        dram["edge_stream_read"] = Mp * D_I
        dram["rank_rw"] = 2 * n * D_V * c
        onchip["bins_expand"] = Mp * D_V * c
        onchip["piece_table"] = 3 * P0 * D_I
        onchip["piece_partials"] = P0 * D_V * c
        gather_ops = U + Mp          # x[update_src] + bins[eui]
        scatter_ops = P0 + n         # piece segment-sum + final rows
    elif method == "pdpr" and plan.csc_src is not None:
        M = int(len(plan.csc_src))
        sched = plan.schedule
        Mp = int(len(sched.edge_update_idx_padded)) if sched is not None else M
        P0 = int(len(sched.piece_start)) if sched is not None else 0
        # pull: stream src ids, random-gather x per edge (best case one
        # value per access — the model's c_mr*l term is the worst case,
        # reported via vs_model), segment-sum into y
        dram["src_read"] = M * D_I
        dram["x_gather"] = Mp * D_V * c
        dram["rank_rw"] = 2 * n * D_V * c
        onchip["piece_table"] = 3 * P0 * D_I
        onchip["piece_partials"] = P0 * D_V * c
        gather_ops = Mp
        scatter_ops = P0 + n
    elif method == "bvgas" and plan.bv_src is not None:
        M = int(len(plan.bv_src))
        sched = plan.schedule
        Mp = int(len(sched.edge_update_idx_padded)) if sched is not None else M
        P0 = int(len(sched.piece_start)) if sched is not None else 0
        # scatter: stream src ids, gather x, write one bin per EDGE (no
        # compression — the r=1 baseline); gather: read every bin back
        # and segment-sum by destination
        dram["src_read"] = M * D_I
        dram["x_gather"] = M * D_V * c
        dram["bins_write"] = M * D_V * c
        dram["bins_read"] = M * D_V * c
        dram["edge_stream_read"] = Mp * D_I
        dram["rank_rw"] = 2 * n * D_V * c
        onchip["piece_table"] = 3 * P0 * D_I
        onchip["piece_partials"] = P0 * D_V * c
        gather_ops = M + Mp
        scatter_ops = P0 + n
    else:
        raise ValueError(
            f"cannot measure method {method!r}: plan carries none of "
            "png/csc/bv layouts (sharded plans account per-shard; "
            "measure the unsharded base plan)")
    return CommBreakdown(method=method, n=n, m=m, ncols=c, dram=dram,
                         onchip=onchip, gather_ops=gather_ops,
                         scatter_ops=scatter_ops)


def model_params(plan, c_mr: float = 1.0) -> comm_model.ModelParams:
    """Model inputs from the plan's MEASURED geometry — k from the actual
    partitioning, r from the built PNG — so prediction and measurement
    disagree only where the model idealizes."""
    part = plan.partitioning
    k = part.num_partitions if part is not None else 1
    r = float(plan.compression_ratio)
    return comm_model.ModelParams(n=plan.num_nodes, m=plan.num_edges,
                                  k=k, r=max(r, 1e-9), c_mr=c_mr)


_MODEL_FNS = {"pcpm": comm_model.pcpm_bytes,
              "pdpr": comm_model.pdpr_bytes,
              "bvgas": comm_model.bvgas_bytes}


def vs_model(plan, ncols: int = 1) -> dict:
    """Measured-vs-predicted bytes per iteration for one plan — the live
    Fig. 8 row. ``ratio`` is measured/model at ncols=1 (the model is
    single-vector); the pdpr model is also reported at its best case
    (c_mr = d_v/l) since eq. (3)'s default c_mr=1 is the all-miss worst
    case."""
    meas = measure_plan(plan, ncols=1)
    p = model_params(plan)
    key = meas.method
    model_b = float(_MODEL_FNS[key](p))
    out = {
        "method": meas.method,
        "n": meas.n, "m": meas.m, "k": p.k, "r": p.r,
        "measured_bytes_per_iter": meas.dram_bytes,
        "measured_onchip_bytes": meas.onchip_bytes,
        "model_bytes_per_iter": model_b,
        "ratio": meas.dram_bytes / model_b if model_b else float("inf"),
        "measured_gather_ops": meas.gather_ops,
        "measured_scatter_ops": meas.scatter_ops,
        "model_random_accesses": comm_model.random_accesses(p)[key],
    }
    if key == "pdpr":
        best = dataclasses.replace(p, c_mr=p.d_v / p.l)
        out["model_bytes_per_iter_best"] = float(comm_model.pdpr_bytes(best))
    if ncols != 1:
        out["measured_bytes_per_iter_ncols"] = measure_plan(
            plan, ncols=ncols).dram_bytes
        out["ncols"] = ncols
    return out


class CommAccountant:
    """Accumulates executed-pass counts against per-plan breakdowns.

    Solvers report ``record_solve(plan, iterations)`` (one pass per
    iteration) and the SlotScheduler reports ``record_pass`` per stepper
    chunk with the chunk's iteration count and the batch width B. Totals
    land in the shared registry under ``comm_*`` and in ``summary()``
    next to the model prediction. Plans ``measure_plan`` cannot account
    (``pcpm_pallas``) are skipped.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._registry = registry
        # (id(plan), ncols) -> CommBreakdown — plans are immutable and
        # identity-hashed, so id() is a stable key for a live plan
        self._breakdowns: dict = {}
        self._plans: dict = {}      # keep plans alive while accounted
        # the same key for a plan measure_plan refuses (pcpm_pallas),
        # kept alive too: a stepper chunk does not retry it
        self._skipped: dict = {}
        # method -> accumulated {passes, dram_bytes, gather, scatter}
        self._totals: dict = {}
        # (id(plan), ncols) -> (passes Counter, bytes Counter), resolved
        # once: record_pass runs once per stepper chunk
        self._counters: dict = {}

    def _breakdown(self, plan, ncols: int) -> Optional[CommBreakdown]:
        key = (id(plan), int(ncols))
        bd = self._breakdowns.get(key)
        if bd is None and key not in self._skipped:
            try:
                bd = measure_plan(plan, ncols=ncols)
            except ValueError:
                # a pcpm_pallas or pcpm_sharded plan: skip
                self._skipped[key] = plan
                return None
            self._breakdowns[key] = bd
            self._plans[key] = plan
            if self._registry is not None:
                self._counters[key] = (
                    self._registry.counter(
                        "comm_passes_total",
                        "executed SpMV passes", method=bd.method),
                    self._registry.counter(
                        "comm_dram_bytes_total",
                        "measured DRAM-model bytes moved",
                        method=bd.method))
        return bd

    def record_pass(self, plan, *, iters: int = 1,
                    ncols: int = 1) -> None:
        if iters <= 0:
            return
        key = (id(plan), int(ncols))
        with self._lock:
            bd = self._breakdown(plan, ncols)
            if bd is None:
                return
            t = self._totals.setdefault(
                bd.method, {"passes": 0, "dram_bytes": 0,
                            "gather_ops": 0, "scatter_ops": 0})
            t["passes"] += iters
            t["dram_bytes"] += iters * bd.dram_bytes
            t["gather_ops"] += iters * bd.gather_ops
            t["scatter_ops"] += iters * bd.scatter_ops
            handles = self._counters.get(key)
        if handles is not None:
            handles[0].inc(iters)
            handles[1].inc(iters * bd.dram_bytes)

    def record_solve(self, plan, iterations: int,
                     ncols: int = 1) -> None:
        self.record_pass(plan, iters=int(iterations), ncols=ncols)

    def summary(self) -> dict:
        """Accumulated measured traffic per method, each with the model
        prediction scaled by the same pass count."""
        with self._lock:
            totals = {k: dict(v) for k, v in self._totals.items()}
            plans = dict(self._plans)
        out = {}
        for method, t in totals.items():
            row = dict(t)
            plan = next((p for p in plans.values()
                         if p.config.method == method), None)
            if plan is not None and t["passes"]:
                cmp_ = vs_model(plan)
                row["model_dram_bytes"] = (cmp_["model_bytes_per_iter"]
                                           * t["passes"])
                row["bytes_per_pass"] = t["dram_bytes"] / t["passes"]
                row["ratio_vs_model"] = cmp_["ratio"]
            out[method] = row
        return out
