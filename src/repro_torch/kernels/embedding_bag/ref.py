"""Plain PyTorch oracle of kernel B2: a sum-mode embedding bag, with the
semantics of the JAX package's ``kernels/embedding_bag/ref.py::
embedding_bag_ref``."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d); idx (B, L) integer ids (pad: any id >= V); weights
    (B, L) or None for ones -> (B, d) = sum_l w[b,l] * table[idx[b,l]] in
    the table's dtype, summed in float32.

    As in the reference, ``valid = idx < V`` zeroes a pad's weight and ids
    are clipped into [0, V-1], so a negative id reads row 0. (The JAX
    package's Pallas path gives zero for a negative id instead; the model
    depends on this version.)"""
    v = table.shape[0]
    valid = (idx < v).to(torch.float32)
    w = valid if weights is None else weights.to(torch.float32) * valid
    rows = table[idx.clamp(0, v - 1)].to(torch.float32)      # (B, L, d)
    return torch.einsum("bl,bld->bd", w, rows).to(table.dtype)
