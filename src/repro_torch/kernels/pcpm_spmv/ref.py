"""Plain PyTorch version of the PCPM gather kernel."""
from __future__ import annotations

import torch


def pcpm_gather_ref(bins: torch.Tensor, edge_upd: torch.Tensor,
                    edge_dst: torch.Tensor, *, part_size: int) -> torch.Tensor:
    """bins: (k, U, d); edge_upd/edge_dst: (k, n_eb, Eb) -> (k, P, d).

    Pad conventions identical to the kernel: edge_upd == U selects a zero
    update; edge_dst == part_size discards the contribution. Sums in
    float32 and returns ``bins``' dtype, as the kernel does.
    """
    k, num_updates, d = bins.shape
    eu = edge_upd.reshape(k, -1)
    ed = edge_dst.reshape(k, -1)
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
