"""The comparisons that decide ``correct``.

Each compared number is a worst case over the answers compared, beside
its limit from the traffic mix (``limits``). A run is correct when
every number is at or under its limit and no answer failed.
"""
from __future__ import annotations

import math

import torch


def ranks_gaps(ranks: torch.Tensor, ref: torch.Tensor) -> dict:
    """A solve's ranks against the reference's, both (n,): the L1 gap
    over the reference's L1 mass, and the widest single gap over the
    reference's largest rank."""
    p = ranks.to(ref.device, torch.float64)
    r = ref.to(torch.float64)
    diff = (p - r).abs()
    if not bool(torch.isfinite(p).all()):
        return {"ranks_l1_rel": math.inf, "ranks_max_rel": math.inf}
    return {"ranks_l1_rel": float(diff.sum() / r.abs().sum()),
            "ranks_max_rel": float(diff.max() / r.abs().max())}


def topk_gap(ids, scores, ref_col: torch.Tensor, k: int) -> float:
    """A served top-k answer (``ids``, ``scores``) against the
    reference's ranks of the same query, as a share of the reference's
    top rank: for each served id, the gap between its served score and
    its reference rank, plus how far its reference rank lies below the
    reference's k-th largest. 0 for the exact answer; inf for an answer
    that is not k distinct node ids or holds a non-finite score."""
    ids = torch.as_tensor(ids).to(ref_col.device, torch.int64).reshape(-1)
    scores = torch.as_tensor(scores).to(ref_col.device,
                                        torch.float64).reshape(-1)
    n = ref_col.shape[0]
    if (ids.numel() != k or scores.numel() != k
            or torch.unique(ids).numel() != k
            or bool(((ids < 0) | (ids >= n)).any())
            or not bool(torch.isfinite(scores).all())):
        return math.inf
    ref = ref_col.to(torch.float64)
    kth = torch.topk(ref, k).values[-1]
    at = ref[ids]
    gap = (scores - at).abs() + (kth - at).clamp(min=0.0)
    return float(gap.max() / ref.max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    out = {name: {"value": numbers[name], "limit": limits[name]}
           for name in sorted(numbers)}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out
