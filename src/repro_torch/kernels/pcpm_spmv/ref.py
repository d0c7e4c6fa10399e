"""Plain PyTorch versions of the PCPM gather kernel's two paths and of
the "warp" path's fused form."""
from __future__ import annotations

import torch


def pcpm_gather_ref(bins: torch.Tensor, edge_upd: torch.Tensor,
                    edge_dst: torch.Tensor, *, part_size: int) -> torch.Tensor:
    """bins: (k, U, d); edge_upd/edge_dst: (k, n_eb, Eb) -> (k, P, d).

    Pad conventions identical to the kernel: an edge counts when
    0 <= edge_upd < U and 0 <= edge_dst < part_size; any other edge (the
    packed layout's pads are edge_upd == U, edge_dst == part_size) adds
    nothing. Sums in float32 and returns ``bins``' dtype, as the kernel
    does.
    """
    k, num_updates, d = bins.shape
    eu = edge_upd.reshape(k, -1)
    ed = edge_dst.reshape(k, -1)
    ok = (eu >= 0) & (eu < num_updates) & (ed >= 0) & (ed < part_size)
    eu = torch.where(ok, eu, num_updates)
    ed = torch.where(ok, ed, part_size)
    bins_z = torch.cat([bins.float(), bins.new_zeros((k, 1, d),
                                                     dtype=torch.float32)],
                       dim=1)
    # flat row of (partition, update) / (partition, dst) per edge
    rows_u = (torch.arange(k, device=bins.device)[:, None] * (num_updates + 1)
              + eu).reshape(-1)
    rows_d = (torch.arange(k, device=bins.device)[:, None] * (part_size + 1)
              + ed).reshape(-1)
    vals = bins_z.reshape(-1, d).index_select(0, rows_u)        # (k*E, d)
    out = bins_z.new_zeros((k * (part_size + 1), d))
    out.index_add_(0, rows_d, vals)
    out = out.view(k, part_size + 1, d)[:, :part_size, :]
    return out.to(bins.dtype).contiguous()


def pcpm_spmv_ref(x: torch.Tensor, update_src: torch.Tensor,
                  edge_upd: torch.Tensor, edge_dst: torch.Tensor, *,
                  part_size: int) -> torch.Tensor:
    """x: (n, d); update_src: (k, U); edge_upd/edge_dst: (k, n_eb, Eb) ->
    (k, P, d): ``pcpm_gather_ref`` on the bins ``x[update_src]``, the
    function of the "warp" path's fused form. An ``update_src`` entry
    outside [0, n) makes the edges that read it pads, as in the kernel.
    Sums in float32 and returns ``x``' dtype."""
    k, num_updates = update_src.shape
    src = update_src.reshape(-1)
    ok = (src >= 0) & (src < x.shape[0])
    rows = x.index_select(0, torch.where(ok, src, 0))
    bins = torch.where(ok[:, None], rows, rows.new_zeros(())).view(
        k, num_updates, x.shape[1])
    return pcpm_gather_ref(bins, edge_upd, edge_dst, part_size=part_size)


def tile_gather_ref(bins: torch.Tensor, schedule,
                    update_offsets: torch.Tensor) -> torch.Tensor:
    """The "tile" path's function on its own streams: ragged bins (U,)
    or (U, 1), partition p's at ``update_offsets[p]`` up to
    ``update_offsets[p + 1]``, and a ``ops.TileSchedule`` -> (k, P, 1).
    Every edge of every chunk adds partition p's update ``upd`` into
    ``out[p, dst]`` (p the chunk's partition), inside the chunk's tile or
    not; an edge with upd outside partition p's updates or dst outside
    [0, P) is a pad. Sums in float32, returns ``bins``' dtype."""
    k, p_size = schedule.num_partitions, schedule.part_size
    offsets = update_offsets.long()
    chunks = schedule.chunks.long()
    lengths = chunks[:, 3] - chunks[:, 2]
    # every edge of every chunk, with its chunk's partition
    part = torch.repeat_interleave(chunks[:, 0], lengths)
    edge = (torch.arange(int(lengths.sum()), device=bins.device)
            - torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                      lengths)
            + torch.repeat_interleave(chunks[:, 2], lengths))
    u = schedule.edge_upd.long()[edge]
    j = schedule.edge_dst.long()[edge]
    first = offsets[part]
    ok = (u >= 0) & (u < offsets[part + 1] - first) & (j >= 0) & (j < p_size)
    vals = bins.float().reshape(-1).index_select(0, (first + u)[ok])
    out = torch.zeros(k * p_size, dtype=torch.float32, device=bins.device)
    out.index_add_(0, (part * p_size + j)[ok], vals)
    return out.view(k, p_size, 1).to(bins.dtype)
