"""Attention in the (B, S, H, D) layout that the model and its KV cache
hold: the entry point of kernel B3 and, for training, of its backward
B3-bwd.

The JAX package's ``ops.py::attention`` transposes to (B, H, S, D) and
pads S to block multiples for the TPU grid. Here the kernel reads the
model's layout through its strides and bounds-checks ragged tiles, so
there is neither a transpose nor a pad.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda


class FlashAttention(torch.autograd.Function):
    """B3 with B3-bwd as its backward, for CUDA tensors: the forward
    writes each row's log-sum-exp and its float32 output beside the
    output, and the backward launches B3-bwd once on the saved q, k, v,
    float32 output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out, lse, o32 = flash_attention_cuda(q, k, v, causal=causal,
                                             window=window, kv_len=kv_len,
                                             for_backward=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.mask = dict(causal=causal, window=window, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o32, lse, do,
                                              **ctx.mask)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    ``kv_len``: None, an int, or (B,) per-row lengths. On CUDA tensors
    this launches B3 (or raises); on CPU tensors it runs the plain
    version, which autograd differentiates. A float32 q against the
    bfloat16 cache gives a float32 output, as the reference's
    ``mha_ref`` promotes.

    When gradients are on and q, k or v requires one, a CUDA call goes
    through ``FlashAttention`` (B3 writing its log-sum-exp and float32
    output, B3-bwd in the backward; per-row ``kv_len`` then raises);
    otherwise it is the plain forward launch, with neither and no
    graph.
    """
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        if isinstance(kv_len, torch.Tensor):
            raise NotImplementedError("the attention backward takes kv_len "
                                      "None or an int")
        return FlashAttention.apply(q, k, v, causal, window, kv_len)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)
