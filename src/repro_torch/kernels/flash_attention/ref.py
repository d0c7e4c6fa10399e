"""Plain PyTorch oracle of kernel B3: masked multi-head attention with
GQA and a sliding window, a copy of the JAX package's
``kernels/flash_attention/ref.py::mha_ref``; and the plain versions of
what training adds, the rows' log-sum-exp (``lse_ref``) and the backward
(``attention_bwd_ref``: autograd through ``attention_ref`` upcast to
float32)."""
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


def _mask(sq: int, skv: int, *, causal: bool, window: int | None,
          kv_len, device) -> torch.Tensor:
    """(Sq, Skv) visibility of key j to query i (at position
    i + Skv - Sq), as ``mha_ref`` masks with an int or no ``kv_len``."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < int(kv_len)
    return mask


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: int | None = None,
            kv_len: int | None = None) -> torch.Tensor:
    """(B, Hq, Sq) float32: each row's log-sum-exp of its visible scaled
    scores, log Σ_j exp(q_i·k_j / √D), +inf where a row sees no key (what
    kernel B3 writes with ``for_backward``). q (B, Sq, Hq, D), k (B, Skv,
    Hkv, D), in float32."""
    b, sq, hq, d = q.shape
    group = hq // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    mask = _mask(sq, k.shape[1], causal=causal, window=window,
                 kv_len=kv_len, device=q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, math.inf))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, causal: bool = True,
                      window: int | None = None,
                      kv_len: int | None = None):
    """The plain version of kernel B3-bwd: (dq, dk, dv) of
    ``attention_ref(q, k, v)`` for the output gradient ``do``, by autograd
    on the inputs upcast to float32, cast back to the inputs' dtypes."""
    with torch.enable_grad():
        qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
        out = attention_ref(qf, kf, vf, causal=causal, window=window,
                            kv_len=kv_len)
        grads = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))
