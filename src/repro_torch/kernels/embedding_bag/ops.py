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

``segment_sum`` is the GNNs' message aggregation on the same two
kernels, each the other's transpose: B2-bwd sums (E, ...) rows by segment
id (sorted, no float atomics, the same bits on every call), and its
backward is one B2 call that gathers each row's gradient back.
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


class SegmentSum(torch.autograd.Function):
    """``segment_sum``'s forward (B2-bwd on one-id bags) and backward
    (B2 on the same bags), on the card and (through the plain versions)
    on the CPU. ``ids`` are already (E, 1) with every id outside [0,
    num_segments) mapped to num_segments, B2's and B2-bwd's pad."""

    @staticmethod
    def forward(ctx, values, ids, weights, num_segments):
        e = values.shape[0]
        out = embedding_bag_bwd_cuda(values.reshape(e, -1), ids, weights,
                                     num_segments)
        ctx.save_for_backward(ids, weights)
        ctx.shape = values.shape
        return out.view(num_segments, *values.shape[1:])

    @staticmethod
    def backward(ctx, gout):
        ids, weights = ctx.saved_tensors
        rows = gout.contiguous().view(gout.shape[0], -1)
        grad = embedding_bag_cuda(rows, ids, weights)
        return grad.view(ctx.shape), None, None, None


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """values (E, ...) float32 or bfloat16; seg (E,) int32 or int64;
    weights (E,) or None -> (num_segments, ...) in values' dtype: row s
    holds the sum of weights[e] · values[e] over the e with seg[e] == s,
    summed in float32.

    ``jax.ops.segment_sum``'s semantics: an id < 0 or >= num_segments is
    dropped (B2-bwd alone would send a negative id to row 0, so such ids
    are mapped to num_segments, its pad, first). On CUDA tensors the
    forward is one B2-bwd call and the gradient with respect to
    ``values`` one B2 call (or they raise); on CPU tensors both are the
    plain versions. ``weights`` that require a gradient raise
    ``NotImplementedError``, as the bag's weights do."""
    if values.dim() < 1 or seg.shape != values.shape[:1]:
        raise ValueError(f"values must be (E, ...) and seg (E,); got "
                         f"{tuple(values.shape)}, {tuple(seg.shape)}")
    if weights is not None and weights.shape != seg.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must have the "
                         f"shape of seg {tuple(seg.shape)}")
    _needs_graph(values, weights)
    ids = torch.where(seg < 0, num_segments, seg)[:, None]
    w = None if weights is None else weights[:, None]
    return SegmentSum.apply(values, ids, w, num_segments)
