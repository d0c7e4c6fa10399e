"""Slot-pool size autotune: pick B from the measured stepper cost (a port
of the JAX package's ``gateway/autotune.py``).

A chunk costs roughly ``chunk * t_pass(B)``, where ``t_pass(B)`` is one
multi-vector SpMV pass over an (n, B) state — sublinear in B on wide
hardware (the PCPM batching property), so bigger pools amortize better
per query. But every query admitted into the pool waits a full chunk
between drain opportunities, so chunk latency is the serving latency
floor. The tuner measures ``t_pass`` at each candidate B and picks the
LARGEST pool whose predicted chunk time stays under ``target_chunk_s``.

The probe times ``engine.spmv_fn()`` — the closure the chunk stepper
calls at width B (on a ``pcpm_pallas`` plan on the card, kernel B1's
fused "warp" path) — so probing builds no throwaway stepper and the
scheduler's ``trace_count`` stays 1.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class AutotuneReport:
    """What the tuner measured and chose — attached to gateway stats and
    to ``Session.gateway()`` so the decision is auditable."""
    target_chunk_s: float
    chunk: int
    probes: dict[int, float]          # B -> min measured chunk seconds
    chosen: int

    def summary(self) -> dict:
        return {"target_chunk_s": self.target_chunk_s,
                "chunk": self.chunk, "chosen": self.chosen,
                "probes_ms": {str(b): t * 1e3
                              for b, t in self.probes.items()}}


def autotune_slots(engine, *, chunk: int,
                   target_chunk_s: float = 0.025,
                   candidates: tuple = (2, 4, 8, 16, 32, 64),
                   repeats: int = 3, default: int = 4) -> AutotuneReport:
    """Measure ``chunk`` * t_pass(B) for ascending candidate pool sizes
    and return the largest B under ``target_chunk_s``.

    Each candidate's (n, B) probe vector is uploaded once; one warm-up
    call (the kernel's first build and first touch) is excluded, then
    the minimum of ``repeats`` calls, each timed on the host clock
    between device synchronizations. Probing stops once a candidate
    exceeds the target — t_pass is monotone in B. Backends without
    multi-vector support keep ``default`` (nothing to amortize)."""
    if not engine.backend.multi_vector:
        return AutotuneReport(target_chunk_s, chunk, {}, default)
    import torch
    dev = engine.device
    n = engine.num_nodes
    fn = engine.spmv_fn()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    probes: dict[int, float] = {}
    for b in sorted(set(int(b) for b in candidates)):
        if b < 1 or b > n:
            continue
        x = torch.from_numpy(rng.random((n, b), dtype=np.float32)).to(dev)
        fn(x)                                     # warm-up
        sync()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(x)
            sync()
            best = min(best, time.perf_counter() - t0)
        probes[b] = best * chunk
        if probes[b] > target_chunk_s:
            break                                 # monotone — stop
    passing = [b for b, t in probes.items() if t <= target_chunk_s]
    chosen = (max(passing) if passing
              else min(probes) if probes else default)
    return AutotuneReport(target_chunk_s, chunk, probes, chosen)
