"""Host-side structural integrity checks over a ``GraphPlan`` (a copy
of the JAX package's ``reliability/guardrails.py``; DESIGN.md §10).

The plan's index arrays are what the device gather/scatter kernels
trust blindly — an out-of-range update pointer or destination id does
not crash a kernel, it silently reads/writes the wrong rank, which is the
worst possible failure mode for a serving system.  ``check_plan_
integrity`` re-derives the cheap bounds invariants every backend's
layout must satisfy (one O(M) vectorized min/max pass per stream, no
device work) so a corrupted plan — bad npz, bad patch splice, injected
fault — fails loudly at rebind/install time while the previous plan
keeps serving.
"""
from __future__ import annotations

import numpy as np


def _bounds(name: str, arr: np.ndarray, lo: int, hi: int) -> None:
    """Require every entry of ``arr`` in [lo, hi] (inclusive)."""
    if arr is None or arr.size == 0:
        return
    amin, amax = int(arr.min()), int(arr.max())
    if amin < lo or amax > hi:
        raise ValueError(
            f"plan integrity: {name} has entries in [{amin}, {amax}], "
            f"outside the valid range [{lo}, {hi}]")


def _offsets(name: str, off: np.ndarray, total: int) -> None:
    if off is None or off.size == 0:
        return
    if int(off[0]) != 0 or int(off[-1]) != total or (np.diff(off) < 0).any():
        raise ValueError(
            f"plan integrity: {name} is not a monotone offset array "
            f"starting at 0 and ending at {total}")


def _check_schedule(sched, *, pointer_hi: int, num_nodes: int) -> None:
    mp = len(sched.edge_update_idx_padded)
    _bounds("schedule.edge_update_idx_padded",
            sched.edge_update_idx_padded, 0, pointer_hi)
    _bounds("schedule.piece_dst", sched.piece_dst, 0, num_nodes)
    _bounds("schedule.piece_start", sched.piece_start, 0, max(mp - 1, 0))
    _bounds("schedule.piece_end", sched.piece_end, 0, max(mp - 1, 0))
    if sched.piece_start.size and \
            (sched.piece_end < sched.piece_start).any():
        raise ValueError("plan integrity: schedule has pieces with "
                         "end < start")


def check_plan_integrity(plan) -> "object":
    """Raise ``ValueError`` unless every populated index stream of
    ``plan`` satisfies its layout's bounds invariants; returns the
    plan unchanged otherwise.  Complements ``core.plan.validate_plan``
    (which checks the plan belongs to a graph, not that its arrays are
    internally sane)."""
    n = plan.num_nodes
    if n <= 0:
        raise ValueError(f"plan integrity: num_nodes={n} must be > 0")

    if plan.csc_src is not None:                      # pdpr
        _bounds("csc_src", plan.csc_src, 0, n - 1)
        _bounds("csc_dst", plan.csc_dst, 0, n - 1)
        if plan.schedule is not None:
            # the pointer stream is x itself: pointers are source ids
            _check_schedule(plan.schedule, pointer_hi=n - 1,
                            num_nodes=n)

    if plan.bv_src is not None:                       # bvgas
        _bounds("bv_src", plan.bv_src, 0, n - 1)
        _bounds("bv_dst", plan.bv_dst, 0, n - 1)
        if plan.schedule is not None:
            # pointers permute the per-edge bins (length M)
            m = len(plan.bv_src)
            _check_schedule(plan.schedule, pointer_hi=max(m - 1, 0),
                            num_nodes=n)

    if plan.png is not None:                          # pcpm / pallas
        png = plan.png
        u = png.num_updates
        _bounds("png.update_src", png.update_src, 0, n - 1)
        _bounds("png.edge_dst", png.edge_dst, 0, n - 1)
        _bounds("png.edge_update_idx", png.edge_update_idx, 0,
                max(u - 1, 0))
        _offsets("png.update_offsets", png.update_offsets, u)
        _offsets("png.edge_offsets", png.edge_offsets,
                 len(png.edge_update_idx))
        if plan.schedule is not None:
            # pointers index the scattered update bins (length U)
            _check_schedule(plan.schedule, pointer_hi=max(u - 1, 0),
                            num_nodes=n)

    if plan.blocked is not None:          # a pcpm_pallas plan file's
        blk = plan.blocked
        max_u = int(blk.update_src.shape[1])   # pad slot = max_u
        _bounds("blocked.update_src", blk.update_src, -1, n - 1)
        _bounds("blocked.edge_update_local", blk.edge_update_local,
                0, max_u)
        _bounds("blocked.edge_dst_local", blk.edge_dst_local,
                0, blk.part_size)

    if plan.sharded is not None:                      # pcpm_sharded
        sh = plan.sharded
        recv = sh.num_shards * sh.send_ids.shape[2]   # S*U zero slot
        _bounds("sharded.send_ids", sh.send_ids, -1, sh.shard_size - 1)
        _bounds("sharded.edge_upd", sh.edge_upd, 0, recv)
        _bounds("sharded.edge_dst", sh.edge_dst, 0, sh.shard_size)
        _bounds("sharded.eui_padded", sh.eui_padded, 0, recv)
        _bounds("sharded.piece_dst", sh.piece_dst, 0, sh.shard_size)
        if (sh.piece_end < sh.piece_start).any():
            raise ValueError("plan integrity: sharded schedule has "
                             "pieces with end < start")
    return plan
