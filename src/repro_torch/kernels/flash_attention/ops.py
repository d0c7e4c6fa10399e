"""Attention in the (B, S, H, D) layout that the model and its KV cache
hold: the entry point of kernel B3.

The JAX package's ``ops.py::attention`` transposes to (B, H, S, D) and
pads S to block multiples for the TPU grid. Here the kernel reads the
model's layout through its strides and bounds-checks ragged tiles, so
there is neither a transpose nor a pad.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    ``kv_len``: None, an int, or (B,) per-row lengths. On CUDA tensors
    this launches B3 (or raises); on CPU tensors it runs the plain
    version. A float32 q against the bfloat16 cache gives a float32
    output, as the reference's ``mha_ref`` promotes.
    """
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)
