"""Dense LM transformer: GQA, RoPE, RMSNorm, SwiGLU, KV-cache decode.

The counterpart of the JAX package's ``models/transformer.py`` for dense
configurations. The parameters live in an ``nn.Module`` (``LM``, one
``Block`` per layer; weights kept in the reference's ``h @ W``
orientation), and the functional names of the reference stand beside
it: ``init_lm``, ``forward``, ``init_cache``, ``prefill`` and
``decode_step``. On the card every attention call launches kernel B3.

Not here yet (ROADMAP.md, Queue A): ``_moe_ffn`` (a MoE configuration
raises ``NotImplementedError``), ``lm_loss``, ``make_train_step``,
``param_logical`` and ``shard_params``. The reference's scan over layers
and its ``unroll_layers`` switch are a Python loop here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import LMConfig
from ..device import resolve_device
from .layers import (chunked_attention, dense_attention, dense_init,
                     rms_norm, rope, swiglu)

PARAM_DTYPE = torch.bfloat16
ATTN_CHUNK = 1024        # the reference's default ``attn_chunk``
LAYER_WEIGHTS = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                 "w_gate", "w_up", "w_down")


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name} is a MoE configuration: the MoE feed-forward "
            "(_moe_ffn) comes with the MoE slice of the port (ROADMAP.md, "
            "Queue A); this slice runs dense LMs only")


class Block(nn.Module):
    """One decoder layer: attention then SwiGLU feed-forward, each with a
    pre-RMSNorm and a residual add."""

    def __init__(self, cfg: LMConfig, weights: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in LAYER_WEIGHTS:
            setattr(self, name, nn.Parameter(weights[name],
                                             requires_grad=False))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, d) -> q (B, S, Hq, dh), k and v (B, S, Hkv, dh); q and
        k rotated by their positions."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = (h @ self.wq).reshape(b, s, cfg.n_heads, cfg.dh)
        k = (h @ self.wk).reshape(b, s, cfg.n_kv_heads, cfg.dh)
        v = (h @ self.wv).reshape(b, s, cfg.n_kv_heads, cfg.dh)
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)

    def attn_out(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        b, s = o.shape[:2]
        return x + o.reshape(b, s, -1) @ self.wo

    def ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, self.ffn_norm, self.cfg.norm_eps)
        return x + swiglu(h, self.w_gate, self.w_up, self.w_down)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attn_path: str = "dense") -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        if attn_path == "chunked":
            o = chunked_attention(q, k, v, causal=True,
                                  window=self.cfg.window,
                                  chunk=min(ATTN_CHUNK, x.shape[1]))
        else:
            o = dense_attention(q, k, v, causal=True, window=self.cfg.window)
        return self.ffn(self.attn_out(x, o))


class LM(nn.Module):
    """The dense LM: embedding, ``cfg.n_layers`` blocks, final RMSNorm
    and unembedding. Inference only: no parameter requires a gradient."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor,
                 unembed: torch.Tensor, final_norm: torch.Tensor,
                 layers: list[dict[str, torch.Tensor]]):
        super().__init__()
        _dense_only(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.unembed = nn.Parameter(unembed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, w) for w in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.final_norm, self.cfg.norm_eps) @ self.unembed

    def forward(self, tokens: torch.Tensor,
                attn_path: str = "auto") -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        s = tokens.shape[1]
        if attn_path == "auto":
            attn_path = "chunked" if s >= 2048 else "dense"
        if attn_path not in ("dense", "chunked"):
            raise ValueError(f"attn_path must be auto, dense or chunked; got "
                             f"{attn_path!r}")
        x = self.embed[tokens]
        positions = torch.arange(s, device=tokens.device)
        for block in self.layers:
            x = block(x, positions, attn_path)
        return self.logits(x)


# ---------------------------------------------------------------- params
def init_lm(cfg: LMConfig, *, generator: torch.Generator | None = None,
            device=None, dtype: torch.dtype = PARAM_DTYPE) -> LM:
    """Random parameters in the reference's shapes and scales (normal,
    fan_in^-1/2; the embedding at scale 1; norms at 1), drawn from
    ``generator`` on ``device`` (default ``"cuda"``). ``jax.random``
    cannot be reproduced: parity tests load the reference's parameters
    with ``params_from_numpy``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    d, dh, f = cfg.d_model, cfg.dh, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale=None):
        return dense_init(shape, generator=generator, scale=scale,
                          dtype=dtype, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    layers = [{"attn_norm": ones(d), "ffn_norm": ones(d),
               "wq": normal((d, hq * dh)), "wk": normal((d, hkv * dh)),
               "wv": normal((d, hkv * dh)), "wo": normal((hq * dh, d)),
               "w_gate": normal((d, f)), "w_up": normal((d, f)),
               "w_down": normal((f, d))} for _ in range(cfg.n_layers)]
    return LM(cfg, normal((cfg.vocab, d), scale=1.0),
              normal((d, cfg.vocab)), ones(d), layers)


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: LMConfig, tree: dict, *, device=None,
                      dtype: torch.dtype | None = None) -> LM:
    """The port's ``LM`` holding the parameters of the reference's
    ``init_lm`` pytree given as numpy arrays (``{"embed", "unembed",
    "final_norm", "layers": {name: (L, ...)}}``), in their ``h @ W``
    orientation; ``dtype`` None keeps each array's dtype."""
    dev = resolve_device(device)

    def put(a):
        return _tensor(a).to(device=dev, dtype=dtype, copy=True)

    stacked = tree["layers"]
    layers = [{name: put(np.asarray(stacked[name])[i])
               for name in LAYER_WEIGHTS} for i in range(cfg.n_layers)]
    return LM(cfg, put(tree["embed"]), put(tree["unembed"]),
              put(tree["final_norm"]), layers)


# ---------------------------------------------------------------- forward
def forward(model: LM, tokens: torch.Tensor, *,
            attn_path: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss). ``attn_path``:
    ``auto`` (chunked at S >= 2048, else dense), ``dense`` or
    ``chunked``; on the card all three are B3. The aux loss is that of
    MoE routing, 0 for a dense LM."""
    logits = model(tokens, attn_path)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ----------------------------------------------------------------- serve
def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device=None) -> dict[str, torch.Tensor]:
    """KV cache {"k", "v"}, each (L, B, slots, Hkv, dh) bfloat16 whatever
    the parameters' dtype (as the reference's); slots = max_len, or the
    window under sliding-window attention."""
    slots = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.dh)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev)}


def prefill(model: LM, tokens: torch.Tensor):
    """tokens (B, S) -> (logits of the last position (B, 1, V), cache
    {"k", "v"} (L, B, slots, Hkv, dh) with slots = S, or the window)."""
    cfg = model.cfg
    s = tokens.shape[1]
    slots = min(s, cfg.window) if cfg.window else s
    x = model.embed[tokens]
    positions = torch.arange(s, device=tokens.device)
    ks, vs = [], []
    for block in model.layers:
        q, k, v = block.qkv(x, positions)
        o = chunked_attention(q, k, v, causal=True, window=cfg.window,
                              chunk=min(ATTN_CHUNK, s))
        x = block.ffn(block.attn_out(x, o))
        ks.append(k[:, -slots:])
        vs.append(v[:, -slots:])
    return model.logits(x[:, -1:]), {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}


def decode_step(model: LM, cache: dict[str, torch.Tensor],
                tokens: torch.Tensor, t):
    """One token for every sequence in the batch.

    tokens (B, 1); t = current position: an int (lockstep batch) or (B,)
    per-slot positions (continuous batching, ``serve/engine.py``).
    Returns (logits (B, 1, V), cache). The reference returns a new cache;
    here each layer's new K/V row is written into ``cache`` in place with
    an index-put, so a step never copies the cache, and the same dict
    comes back.
    """
    cfg = model.cfg
    b = tokens.shape[0]
    slots = cache["k"].shape[2]
    dev = tokens.device
    per_slot = (t.dim() if isinstance(t, torch.Tensor) else np.ndim(t)) == 1
    if per_slot:
        t = torch.as_tensor(t, device=dev).long()
        slot = t % slots
        kv_len = torch.clamp(t + 1, max=slots).to(torch.int32)
        positions = t.reshape(b, 1)
        rows = torch.arange(b, device=dev)
    else:
        t = int(t)
        slot, kv_len = t % slots, min(t + 1, slots)
        positions = torch.full((1,), t, dtype=torch.long, device=dev)
    x = model.embed[tokens]
    for i, block in enumerate(model.layers):
        q, k, v = block.qkv(x, positions)
        kc, vc = cache["k"][i], cache["v"][i]          # (B, slots, Hkv, dh)
        if per_slot:
            kc.index_put_((rows, slot), k[:, 0].to(kc.dtype))
            vc.index_put_((rows, slot), v[:, 0].to(vc.dtype))
        else:
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
        o = dense_attention(q, kc, vc, causal=False, kv_len=kv_len)
        x = block.ffn(block.attn_out(x, o))
    return model.logits(x), cache
