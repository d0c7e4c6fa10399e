"""Sum-mode embedding bag: the entry point of kernel B2 and, for
training, of its backward B2-bwd.

The JAX package's ``ops.py::embedding_bag`` chooses a ``path``: "xla"
(its plain version) or "pallas" (the one-hot TPU kernel, after padding V
to 512, B to 8 and d to 128). Here there is no switch: on the card the
kernel is the only path and pads nothing; the plain version
(``ref.embedding_bag_ref``) runs for CPU tensors, and the tests call it
directly.

When gradients are on and the table requires one, both entry points go
through ``EmbeddingBag``, on either device: B2 (or its plain version on
the CPU) forward, B2-bwd (or the plain backward) for the table's
gradient. Otherwise a call builds no graph.
"""
from __future__ import annotations

import torch

from .kernel import (embedding_bag_bwd_cuda, embedding_bag_cuda,
                     embedding_lookup_cuda)

class EmbeddingBag(torch.autograd.Function):
    """B2 with B2-bwd as its backward, on the card and (through the plain
    versions) on the CPU. ``lookup`` True: ``idx`` holds ids of any shape,
    each a one-id bag, and the output is (..., d) (``embedding_lookup``);
    False: ``idx`` is (B, L) bags, weighted by ``weights`` or by ones.
    The backward gives the table a dense (V, d) gradient in its dtype
    (one B2-bwd call) and nothing to the ids or weights."""

    @staticmethod
    def forward(ctx, table, idx, weights, lookup):
        if lookup:
            out = embedding_lookup_cuda(table, idx)
        else:
            out = embedding_bag_cuda(table, idx, weights)
        ctx.save_for_backward(idx, weights)
        ctx.lookup, ctx.num_rows = lookup, table.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        idx, weights = ctx.saved_tensors
        d = dout.shape[-1]
        bags = idx.reshape(-1, 1) if ctx.lookup else idx
        grad = embedding_bag_bwd_cuda(dout.reshape(bags.shape[0], d), bags,
                                      weights, ctx.num_rows)
        return grad, None, None, None


def _needs_graph(table: torch.Tensor, weights: torch.Tensor | None) -> bool:
    if not torch.is_grad_enabled():
        return False
    if weights is not None and weights.requires_grad:
        raise NotImplementedError(
            "the embedding bag's gradient with respect to its weights is "
            "not implemented (ROADMAP.md A11.3, 'B2's weights gradient'): "
            "no model of the reference trains them")
    return table.requires_grad


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """table (V, d); idx (B, L) int32 or int64, pad = any id >= V;
    weights (B, L) or None -> (B, d) = sum_l w[b,l] * table[idx[b,l]].

    On CUDA tensors this launches B2 (or raises); on CPU tensors it runs
    the plain version. An id < 0 reads row 0, as the reference clips.
    A table that requires a gradient gets it through ``EmbeddingBag``;
    weights that require one raise ``NotImplementedError``.
    """
    if _needs_graph(table, weights):
        return EmbeddingBag.apply(table, idx, weights, False)
    return embedding_bag_cuda(table, idx, weights)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, d); ids (...) -> rows (..., d): MIND's lookup, each id a
    one-id bag (zeros for an id >= V, row 0 for an id < 0).

    On CUDA tensors this launches B2 once, writing the final shape; on
    CPU tensors it runs the plain version. A table that requires a
    gradient gets it through ``EmbeddingBag`` (B2-bwd once)."""
    if _needs_graph(table, None):
        return EmbeddingBag.apply(table, ids, None, True)
    return embedding_lookup_cuda(table, ids)
