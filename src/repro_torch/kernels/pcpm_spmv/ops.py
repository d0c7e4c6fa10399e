"""BlockedPNG + feature matrix -> full PCPM SpMV through the gather kernel
(the scatter phase is a torch gather producing the bins, as it was an
XLA gather in the JAX package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.png import BlockedPNG
from ...device import resolve_device
from .kernel import pcpm_gather_cuda


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class PackedPNG:
    """Kernel-ready PNG blocks (device tensors)."""
    part_size: int
    num_nodes: int
    update_src: torch.Tensor    # (k, U) int32, pad -> 0 (never read)
    update_valid: torch.Tensor  # (k, U) bool, unused by the SpMV
    edge_upd: torch.Tensor      # (k, n_eb, Eb) int32, pad -> U
    edge_dst: torch.Tensor      # (k, n_eb, Eb) int32, pad -> part_size

    @property
    def num_partitions(self) -> int:
        return self.update_src.shape[0]


def pack_blocked(blocked: BlockedPNG, num_nodes: int, *,
                 edge_block: int = 512, lane: int = 1,
                 device=None) -> PackedPNG:
    """Pad the blocked PNG to whole edge blocks and upload it.

    The JAX package rounds U up to the TPU's 128 lanes (its ``lane``
    argument); the card needs no such padding, so ``lane`` defaults to
    1, with which both packages give equal arrays.
    """
    dev = resolve_device(device)
    k, max_u = blocked.update_src.shape
    _, max_e = blocked.edge_update_local.shape
    u_pad = _round_up(max(max_u, lane), lane)
    e_pad = _round_up(max(max_e, edge_block), edge_block)

    upd = np.zeros((k, u_pad), dtype=np.int32)
    valid = np.zeros((k, u_pad), dtype=bool)
    upd[:, :max_u] = np.maximum(blocked.update_src, 0)
    valid[:, :max_u] = blocked.update_src >= 0

    eu = np.full((k, e_pad), u_pad, dtype=np.int32)
    ed = np.full((k, e_pad), blocked.part_size, dtype=np.int32)
    eu[:, :max_e] = np.where(blocked.edge_update_local >= max_u, u_pad,
                             blocked.edge_update_local)
    ed[:, :max_e] = blocked.edge_dst_local

    n_eb = e_pad // edge_block
    return PackedPNG(
        blocked.part_size, num_nodes,
        torch.from_numpy(upd).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(eu.reshape(k, n_eb, edge_block)).to(dev),
        torch.from_numpy(ed.reshape(k, n_eb, edge_block)).to(dev))


def pcpm_spmv_pallas(packed: PackedPNG, x: torch.Tensor) -> torch.Tensor:
    """y = A^T x. x: (n,) or (n, d) with any d >= 1, on the device the
    packed layout lives on.

    The name is the JAX package's (``ops.pcpm_spmv_pallas``), kept so
    the counterpart is easy to find; on the card the gather runs the
    CUDA kernel (``kernel.pcpm_gather_cuda``), and d is not padded.

    The JAX version zeroes the pad update slots (``* update_valid``);
    here that pass is left out because no edge reads those slots: real
    edges point at real updates, and ``pack_blocked`` points pad edges
    at ``U``, which the gather drops. The bins of pad slots hold
    ``x[0]`` and are never summed.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n, d = x.shape
    k, num_updates = packed.update_src.shape
    # scatter phase: compressed bins (k, U, d) — one value per
    # (src, dst-partition) pair, the paper's update_bins.
    bins = x.index_select(0, packed.update_src.view(-1)).view(
        k, num_updates, d)
    out = pcpm_gather_cuda(bins, packed.edge_upd, packed.edge_dst,
                           part_size=packed.part_size)
    y = out.view(-1, d)[:n]
    return y[:, 0] if squeeze else y
