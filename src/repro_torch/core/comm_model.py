"""Analytic communication and random-access models — paper §V, eqs. 3-10.

The paper's own napkin-math models, copied from the JAX package's
``core/comm_model.py``: ``chip_smoke.py`` divides their per-iteration bytes
by the measured time of an iteration to give each engine's GB/s.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelParams:
    n: int            # |V|
    m: int            # |E|
    k: int            # |P| partitions
    r: float          # compression ratio |E|/|E'|
    c_mr: float = 1.0  # PDPR cache miss ratio for source reads
    l: int = 64       # cache line bytes
    d_v: int = 4      # rank value bytes
    d_i: int = 4      # index bytes


def pdpr_bytes(p: ModelParams) -> float:
    """Eq. (3): m(d_i + c_mr*l) + n(d_i + d_v)."""
    return p.m * (p.d_i + p.c_mr * p.l) + p.n * (p.d_i + p.d_v)


def bvgas_bytes(p: ModelParams) -> float:
    """Eq. (4): 2m(d_i + d_v) + n(d_i + 2 d_v)."""
    return 2 * p.m * (p.d_i + p.d_v) + p.n * (p.d_i + 2 * p.d_v)


def pcpm_bytes(p: ModelParams) -> float:
    """Eq. (5): m(d_i(1+1/r) + 2 d_v/r) + k^2 d_i + 2 n d_v."""
    return (p.m * (p.d_i * (1 + 1 / p.r) + 2 * p.d_v / p.r)
            + p.k * p.k * p.d_i + 2 * p.n * p.d_v)


def bvgas_wins_over_pdpr(p: ModelParams) -> bool:
    """Eq. (6): c_mr > (d_i + 2 d_v) / l."""
    return p.c_mr > (p.d_i + 2 * p.d_v) / p.l


def pcpm_wins_over_pdpr(p: ModelParams) -> bool:
    """Eq. (7): c_mr > (d_i + 2 d_v) / (r l)."""
    return p.c_mr > (p.d_i + 2 * p.d_v) / (p.r * p.l)


def random_accesses(p: ModelParams) -> dict:
    """Eqs. (8)-(10)."""
    return {
        "pdpr": p.m * p.c_mr,
        "bvgas": p.m * p.d_v / p.l + p.k,
        "pcpm": p.k * p.k + p.k,
    }
