"""Shared neural-net layers of the LM, the counterparts of the JAX
package's ``models/layers.py``.

The reference's ``shard(...)`` annotations are dropped: the port runs on
one card and nothing is sharded. Both attention entry points reach
kernel B3 on CUDA tensors, through ``kernels.flash_attention.attention``,
and run their plain versions on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """float32 inside, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e6) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). Rotates the two halves of
    D (concatenated, not interleaved)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU feed-forward; with (E, N, d) rows and (E, d, f) /
    (E, f, d) weights, every MoE expert's as one batched GEMM each."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def dense_init(shape, *, generator: torch.Generator | None = None,
               scale: float | None = None, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """Normal(0, scale²) in float32, cast to ``dtype``; scale defaults to
    fan_in^-1/2. Draws from ``generator`` (on ``device``): the numbers
    are not those of ``jax.random``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def chunked_attention_ref(q, k, v, *, causal=True, window=None, chunk=1024,
                          kv_len=None):
    """Online-softmax attention over KV chunks, the plain copy of the
    reference's ``chunked_attention`` (its ``unroll`` is a cost-model
    switch of XLA and has no counterpart here).

    q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D); Skv a multiple of chunk.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    assert skv % chunk == 0, "pad kv to chunk multiple"
    group = hq // hkv
    scale = d ** -0.5
    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    m = torch.full((b, hq, sq), -1e30, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for c_idx in range(skv // chunk):
        kb = k[:, c_idx * chunk:(c_idx + 1) * chunk].float()
        vb = v[:, c_idx * chunk:(c_idx + 1) * chunk].float()
        kb = kb.repeat_interleave(group, dim=2)
        vb = vb.repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        k_pos = c_idx * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.tensor(0.0, device=q.device))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.where(l[..., None] == 0, 1.0, l[..., None])
    return out.transpose(1, 2).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, chunk=1024,
                      kv_len=None):
    """Attention for prefill and long forwards. On the card this is B3,
    which tiles the keys itself (``chunk`` has no meaning there); on the
    CPU, the plain chunked version."""
    if q.device.type == "cpu":
        return chunked_attention_ref(q, k, v, causal=causal, window=window,
                                     chunk=chunk, kv_len=kv_len)
    return attention(q, k, v, causal=causal, window=window, kv_len=kv_len)


def dense_attention(q, k, v, *, causal=True, window=None, kv_len=None):
    """Masked attention for short sequences and decode. On the card this
    is B3; on the CPU, ``mha_ref``."""
    return attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
