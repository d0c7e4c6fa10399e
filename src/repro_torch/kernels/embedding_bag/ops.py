"""Sum-mode embedding bag: the entry point of kernel B2.

The JAX package's ``ops.py::embedding_bag`` chooses a ``path``: "xla"
(its plain version) or "pallas" (the one-hot TPU kernel, after padding V
to 512, B to 8 and d to 128). Here there is no switch: on the card the
kernel is the only path and pads nothing; the plain version
(``ref.embedding_bag_ref``) runs for CPU tensors, and the tests call it
directly.
"""
from __future__ import annotations

import torch

from .kernel import embedding_bag_cuda, embedding_lookup_cuda


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d); idx (B, L) int32 or int64, pad = any id >= V;
    weights (B, L) or None -> (B, d) = sum_l w[b,l] * table[idx[b,l]].

    On CUDA tensors this launches B2 (or raises); on CPU tensors it runs
    the plain version. An id < 0 reads row 0, as the reference clips.
    """
    return embedding_bag_cuda(table, idx, weights)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, d); ids (...) -> rows (..., d): MIND's lookup, each id a
    one-id bag (zeros for an id >= V, row 0 for an id < 0).

    On CUDA tensors this launches B2 once, writing the final shape; on
    CPU tensors it runs the plain version."""
    return embedding_lookup_cuda(table, ids)
