"""Plain PyTorch oracle of kernel B3: masked multi-head attention with
GQA and a sliding window, a copy of the JAX package's
``kernels/flash_attention/ref.py::mha_ref``."""
from __future__ import annotations

import math

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). Hq % Hkv == 0.

    window = sliding-window size (Mistral-style: key j visible to query i
    iff i - window < j <= i). kv_len masks padded kv positions: a scalar,
    or one length per batch row (continuous batching). Mixed dtypes
    promote as ``jnp.einsum`` does; a row with no visible key is 0.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    dt = torch.promote_types(q.dtype, k.dtype)
    # the scale is sqrt(d) cast to q's dtype, as in the reference
    s = (torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt))
         / torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype))
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((1, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)[None, None]
    if window is not None:
        mask = mask & (k_pos > q_pos - window)[None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        if kv_len.dim() == 0:
            mask = mask & (k_pos < kv_len)[None, None]
        else:  # per-batch kv lengths (continuous batching)
            mask = mask & (k_pos[None] < kv_len[:, None, None])[:, None]
    s = s.masked_fill(~mask, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dt = torch.promote_types(p.dtype, v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(dt), v.to(dt))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  kv_len: int | torch.Tensor | None = None) -> torch.Tensor:
    """``mha_ref`` in the (B, S, H, D) layout of the model and the cache:
    q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    return mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   causal=causal, window=window,
                   kv_len=kv_len).transpose(1, 2)
