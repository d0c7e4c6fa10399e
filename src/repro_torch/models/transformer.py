"""LM transformer (dense and MoE): GQA, RoPE, RMSNorm, SwiGLU,
sliding-window attention, capacity-bounded top-k MoE, KV-cache decode.

The counterpart of the JAX package's ``models/transformer.py``. The
parameters live in an ``nn.Module`` (``LM``, one ``Block`` per layer;
weights kept in the reference's ``h @ W`` orientation), and the
functional names of the reference stand beside it: ``init_lm``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``. On the card
every attention call launches kernel B3.

The MoE feed-forward (``_moe_ffn``) keeps the reference's partition-
centric dispatch: per sequence, each route (token, choice) takes the next
free slot of its expert's buffer in token-major order, routes past the
capacity are dropped, and the (E, B·cap, d) buffers go through batched
GEMMs (``swiglu`` over the experts' weights) before the gated combine.
The router's product is taken in float64 and rounded to float32, so no
TF32 setting of the caller's reaches it (a flip there changes a token's
experts). Only ``forward`` computes the aux loss; ``prefill`` and
``decode_step`` drop it, as the reference's do, and skip its work.

One layout differs from the reference on purpose. Under sliding-window
attention, ``prefill`` keeps position p of the last ``window`` keys in
cache slot ``p % window`` (a ring), the slot ``decode_step`` writes
position p to. The reference keeps them in position order from slot 0,
so after a prefill of S > window tokens with S % window != 0 its decode
overwrites a key that is not the oldest; the port's cache is the
reference's rolled by S % window, and its decode agrees with ``forward``.

Training (``lm_loss``, ``make_train_step``): the gradient comes from
torch autograd; on the card every attention call's backward is kernel
B3-bwd. The parameters are created with ``requires_grad=False``, so
serving never builds an autograd graph; a train step switches them on
for its own forward and backward only (``LM.trainable``). Each layer is
checkpointed (``torch.utils.checkpoint``, the reference's per-layer
``jax.checkpoint`` with nothing saved), so only the layer boundaries'
activations stay live; ``sqrt_remat`` and ``remat_dots`` are TPU memory
knobs of the reference, left to the TPU (README.md, "Left to the TPU"),
as are ``param_shapes``, ``cache_shapes``, ``param_logical`` and
``shard_params``, the shape trees and mesh placement of its dry run. The
reference's scan over layers and its ``unroll_layers`` switch are a
Python loop here.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ..device import resolve_device
from .layers import (chunked_attention, dense_attention, dense_init,
                     rms_norm, rope, swiglu)

PARAM_DTYPE = torch.bfloat16
# the reference's default ``attn_chunk``, which its ``REPRO_PERF``
# variable can change; here it only cuts the CPU path's chunks: on the
# card attention is B3, which tiles the keys itself and takes no chunk
ATTN_CHUNK = 1024
LAYER_WEIGHTS = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                 "w_gate", "w_up", "w_down")
MOE_WEIGHTS = LAYER_WEIGHTS + ("router",)


def layer_weights(cfg: LMConfig) -> tuple[str, ...]:
    """The names of one layer's weights: a MoE layer adds its router."""
    return MOE_WEIGHTS if cfg.moe else LAYER_WEIGHTS


def capacity(cfg: LMConfig, s: int) -> int:
    """Expert slots per sequence of ``s`` tokens (GShard-style group
    capacity), rounded up to a multiple of 128 above 128."""
    cap = max(int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts), 1)
    return -(-cap // 128) * 128 if cap > 128 else cap


def route(h: torch.Tensor, router: torch.Tensor, k: int):
    """h (B, S, d) -> (router logits (B, S, E) float32, top-k logits and
    experts (B, S, K), largest first). The product is float64 rounded to
    float32: float32 accuracy whatever TF32 flags the caller has set."""
    logits = (h.double() @ router.double()).float()
    top, experts = logits.topk(k, dim=-1)
    return logits, top, experts


def expert_slots(experts: torch.Tensor, n_experts: int,
                 cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """experts (B, S, K) -> (slot, kept), each (B, S·K) in token-major
    route order: a route's slot is its rank among the routes of its
    sequence to the same expert; it is kept while slot < cap."""
    b, s, k = experts.shape
    onehot = F.one_hot(experts.reshape(b, s * k), n_experts)  # (B, SK, E)
    slot = (onehot.cumsum(1) * onehot).sum(-1) - 1
    return slot, slot < cap


def aux_loss(logits: torch.Tensor, experts: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """The Switch load-balance loss E · Σ_e f_e · mean(probs)_e, with f_e
    the share of tokens whose top-1 expert is e."""
    probs = torch.softmax(logits, dim=-1)
    f_e = F.one_hot(experts[..., 0], n_experts).float().mean((0, 1))
    return n_experts * (f_e * probs.mean((0, 1))).sum()


def _moe_ffn(h: torch.Tensor, block: "Block", cfg: LMConfig, *,
             with_aux: bool = True) -> tuple[torch.Tensor,
                                             torch.Tensor | None]:
    """Capacity-bounded top-k MoE with per-sequence dispatch, as the
    reference's ``_moe_ffn``: h (B, S, d) -> (out (B, S, d), aux loss, or
    None without ``with_aux``).

    A route's slot is its rank among the routes of its sequence to the
    same expert, in token-major order (token t's choices, then token
    t+1's); slots >= cap drop the route, which then adds nothing. Expert
    e's buffer for batch row b is rows ``b·cap .. b·cap + cap - 1`` of
    ``buf[e]``; a last row takes the dropped routes and is never read.
    """
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, s)
    logits, top, experts = route(h, block.router, k)
    gates = torch.softmax(top, dim=-1)
    e_flat = experts.reshape(b, s * k)
    slot, keep = expert_slots(experts, e, cap)
    rows = torch.where(keep, torch.arange(b, device=h.device)[:, None] * cap
                       + slot, b * cap)
    buf = h.new_zeros((e, b * cap + 1, d))
    buf[e_flat, rows] = h.repeat_interleave(k, dim=1)
    out = swiglu(buf[:, :b * cap], block.w_gate, block.w_up, block.w_down)
    vals = out[e_flat, rows.clamp(max=b * cap - 1)]      # (B, SK, d)
    w = gates.reshape(b, s * k).to(h.dtype) * keep
    y = (vals * w[..., None]).reshape(b, s, k, d).sum(2)
    return y, aux_loss(logits, experts, e) if with_aux else None


class Block(nn.Module):
    """One decoder layer: attention then the feed-forward (SwiGLU, or a
    MoE of SwiGLU experts), each with a pre-RMSNorm and a residual add.
    A MoE layer holds its float32 ``router`` (d, E) and its experts'
    weights stacked as (E, d, f) and (E, f, d)."""

    def __init__(self, cfg: LMConfig, weights: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in layer_weights(cfg):
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

    def ffn(self, x: torch.Tensor, with_aux: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The reference's ``_ffn_block``: (x + feed-forward, aux loss);
        the aux is None for a dense layer, or without ``with_aux``."""
        h = rms_norm(x, self.ffn_norm, self.cfg.norm_eps)
        if self.cfg.moe:
            out, aux = _moe_ffn(h, self, self.cfg, with_aux=with_aux)
            return x + out, aux
        return x + swiglu(h, self.w_gate, self.w_up, self.w_down), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                attn_path: str = "dense") -> tuple[torch.Tensor,
                                                   torch.Tensor | None]:
        q, k, v = self.qkv(x, positions)
        if attn_path == "chunked":
            o = chunked_attention(q, k, v, causal=True,
                                  window=self.cfg.window,
                                  chunk=min(ATTN_CHUNK, x.shape[1]))
        else:
            o = dense_attention(q, k, v, causal=True, window=self.cfg.window)
        return self.ffn(self.attn_out(x, o), with_aux=True)


class LM(nn.Module):
    """The LM: embedding, ``cfg.n_layers`` blocks, final RMSNorm and
    unembedding. No parameter requires a gradient outside
    ``trainable()``."""

    def __init__(self, cfg: LMConfig, embed: torch.Tensor,
                 unembed: torch.Tensor, final_norm: torch.Tensor,
                 layers: list[dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.unembed = nn.Parameter(unembed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, w) for w in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @contextlib.contextmanager
    def trainable(self):
        """Every parameter requires a gradient inside the block, and none
        after it: a train step's forward builds its graph, and serving
        with the same model builds none."""
        self.requires_grad_(True)
        try:
            yield self
        finally:
            self.requires_grad_(False)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.final_norm, self.cfg.norm_eps) @ self.unembed

    def forward(self, tokens: torch.Tensor, attn_path: str = "auto",
                remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits (B, S, V), aux loss: the layers' MoE
        aux losses summed and divided by the depth). ``remat``: with
        gradients on, each layer is checkpointed (its activations are
        recomputed in the backward, attention's forward included)."""
        s = tokens.shape[1]
        if attn_path == "auto":
            attn_path = "chunked" if s >= 2048 else "dense"
        if attn_path not in ("dense", "chunked"):
            raise ValueError(f"attn_path must be auto, dense or chunked; got "
                             f"{attn_path!r}")
        x = self.embed[tokens]
        positions = torch.arange(s, device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        remat = remat and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                x, aux_l = checkpoint(block, x, positions, attn_path,
                                      use_reentrant=False)
            else:
                x, aux_l = block(x, positions, attn_path)
            if aux_l is not None:
                aux = aux + aux_l
        return self.logits(x), aux / self.cfg.n_layers


# ---------------------------------------------------------------- params
def init_lm(cfg: LMConfig, *, generator: torch.Generator | None = None,
            device=None, dtype: torch.dtype = PARAM_DTYPE) -> LM:
    """Random parameters in the reference's shapes and scales (normal,
    fan_in^-1/2; the embedding at scale 1; norms at 1), drawn from
    ``generator`` on ``device`` (default ``"cuda"``); a MoE router is
    float32 whatever ``dtype`` is, as the reference's. ``jax.random``
    cannot be reproduced: parity tests load the reference's parameters
    with ``params_from_numpy``."""
    dev = resolve_device(device)
    d, dh, f = cfg.d_model, cfg.dh, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale=None):
        return dense_init(shape, generator=generator, scale=scale,
                          dtype=dtype, device=dev)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def layer():
        w = {"attn_norm": ones(d), "ffn_norm": ones(d),
             "wq": normal((d, hq * dh)), "wk": normal((d, hkv * dh)),
             "wv": normal((d, hkv * dh)), "wo": normal((hq * dh, d))}
        if not cfg.moe:
            return {**w, "w_gate": normal((d, f)), "w_up": normal((d, f)),
                    "w_down": normal((f, d))}
        e = cfg.n_experts
        return {**w, "router": dense_init(
                    (d, e), generator=generator, dtype=torch.float32,
                    device=dev),
                "w_gate": normal((e, d, f)), "w_up": normal((e, d, f)),
                "w_down": normal((e, f, d))}

    layers = [layer() for _ in range(cfg.n_layers)]
    return LM(cfg, normal((cfg.vocab, d), scale=1.0),
              normal((d, cfg.vocab)), ones(d), layers)


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def param_tree(named: dict, stack=torch.stack) -> dict:
    """The reference's parameter tree (``{"embed", "unembed",
    "final_norm", "layers": {name: (L, ...)}}``) of a dict keyed by the
    port's parameter names (``dict(model.named_parameters())``, or
    gradients or optimizer moments keyed alike): each layer weight's
    per-layer values, in layer order, given to ``stack`` (by default
    stacked as one (L, ...) tensor, a copy)."""
    layers: dict[str, dict] = {}
    top = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(parts[2], {})[int(parts[1])] = t
        else:
            top[name] = t
    top["layers"] = {w: stack([rows[i] for i in range(len(rows))])
                     for w, rows in layers.items()}
    return top


def named_from_tree(tree: dict) -> dict:
    """The inverse of ``param_tree``: a dict keyed by the port's
    parameter names, each layer weight the row of its stack (a view of a
    stacked tensor, or an item of a list)."""
    named = {k: v for k, v in tree.items() if k != "layers"}
    for w, stack in tree["layers"].items():
        named.update((f"layers.{i}.{w}", row) for i, row in enumerate(stack))
    return named


def params_from_numpy(cfg: LMConfig, tree: dict, *, device=None,
                      dtype: torch.dtype | None = None) -> LM:
    """The port's ``LM`` holding the parameters of the reference's
    ``init_lm`` pytree given as numpy arrays (``{"embed", "unembed",
    "final_norm", "layers": {name: (L, ...)}}``), in their ``h @ W``
    orientation; ``dtype`` None keeps each array's dtype. A MoE router
    given a ``dtype`` becomes float32, as ``init_lm`` draws it."""
    dev = resolve_device(device)

    def put(a, dt=dtype):
        return _tensor(a).to(device=dev, dtype=dt, copy=True)

    def put_layer(name, a):
        if name == "router" and dtype is not None:
            return put(a, torch.float32)
        return put(a)

    stacked = tree["layers"]
    layers = [{name: put_layer(name, np.asarray(stacked[name])[i])
               for name in layer_weights(cfg)} for i in range(cfg.n_layers)]
    return LM(cfg, put(tree["embed"]), put(tree["unembed"]),
              put(tree["final_norm"]), layers)


# ---------------------------------------------------------------- forward
def forward(model: LM, tokens: torch.Tensor, *, attn_path: str = "auto",
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss). ``attn_path``:
    ``auto`` (chunked at S >= 2048, else dense), ``dense`` or
    ``chunked``; on the card all three are B3. The aux loss is the mean
    over layers of the MoE load-balance loss (float32), 0 for a dense
    LM. ``remat`` checkpoints each layer when gradients are on."""
    return model(tokens, attn_path, remat)


def lm_loss(model: LM, tokens: torch.Tensor, labels: torch.Tensor, *,
            attn_path: str = "auto", aux_weight: float = 0.01,
            remat: bool = False):
    """The reference's ``lm_loss``: (nll + aux_weight · aux, (nll, aux))
    with nll the mean over (B, S) of logsumexp(logits) − logits[label],
    logits in float32. The gold logit is a ``gather`` (the reference's
    one-hot contraction is a sharding device; the value is the same)."""
    logits, aux = forward(model, tokens, attn_path=attn_path, remat=remat)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = (lse - gold).mean()
    return nll + aux_weight * aux, (nll, aux)


def make_train_step(cfg: LMConfig, optimizer, *, attn_path: str = "auto",
                    num_microbatches: int = 1):
    """The reference's ``make_train_step``: ``train_step(model,
    opt_state, batch) -> (model, opt_state, metrics)`` with metrics
    {"loss", "nll", "aux", "gnorm"} as 0-d float32 tensors on the
    model's device (no host read).

    ``num_microbatches`` nm > 1 splits the batch strided (microbatch i
    holds rows i, i + nm, ...), accumulates each microbatch's gradients
    in float32 buffers in order and divides by nm, as the reference's
    scan does; with nm = 1 the gradients stay in the parameters' dtype.
    Each layer is checkpointed, as the reference's are. The optimizer
    updates the model's parameters in place (``optim.AdamW.update``)."""
    nm = num_microbatches

    def grads_of(model, names, params, tokens, labels):
        loss, (nll, aux) = lm_loss(model, tokens, labels,
                                   attn_path=attn_path, remat=True)
        grads = torch.autograd.grad(loss, params)
        return (loss.detach(), nll.detach(), aux.detach()), dict(zip(names,
                                                                      grads))

    def train_step(model: LM, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        names, params = zip(*model.named_parameters())
        with model.trainable():
            if nm == 1:
                (loss, nll, aux), grads = grads_of(model, names, params,
                                                   tokens, labels)
            else:
                b, s = tokens.shape
                if b % nm:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"num_microbatches {nm}")
                toks = tokens.reshape(b // nm, nm, s).transpose(0, 1)
                labs = labels.reshape(b // nm, nm, s).transpose(0, 1)
                grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in zip(names, params)}
                loss = nll = aux = torch.zeros((), dtype=torch.float32,
                                               device=tokens.device)
                for i in range(nm):
                    (l_i, n_i, a_i), g = grads_of(model, names, params,
                                                  toks[i], labs[i])
                    for n in names:
                        grads[n].add_(g.pop(n))
                    loss, nll, aux = loss + l_i, nll + n_i, aux + a_i
                for g in grads.values():
                    g.div_(nm)
                loss, nll, aux = loss / nm, nll / nm, aux / nm
        model, opt_state, gnorm = optimizer.update(grads, opt_state, model)
        return model, opt_state, {"loss": loss, "nll": nll, "aux": aux,
                                  "gnorm": gnorm}
    return train_step


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
    {"k", "v"} (L, B, slots, Hkv, dh) with slots = S, or the window).

    Position p of the cached keys sits in slot ``p % slots``, where
    ``decode_step`` writes and reads it: with S > slots the last
    ``slots`` keys form a ring (the reference's cache rolled by
    S % slots; the module docstring says why). The MoE aux loss is
    dropped, as the reference's prefill drops it."""
    cfg = model.cfg
    s = tokens.shape[1]
    slots = min(s, cfg.window) if cfg.window else s
    shift = s % slots
    x = model.embed[tokens]
    positions = torch.arange(s, device=tokens.device)
    ks, vs = [], []
    for block in model.layers:
        q, k, v = block.qkv(x, positions)
        o = chunked_attention(q, k, v, causal=True, window=cfg.window,
                              chunk=min(ATTN_CHUNK, s))
        x, _ = block.ffn(block.attn_out(x, o))
        k, v = k[:, -slots:], v[:, -slots:]
        if shift:
            k, v = k.roll(shift, 1), v.roll(shift, 1)
        ks.append(k)
        vs.append(v)
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
    comes back. At one token a sequence no MoE route is dropped
    (capacity >= 1 and a token's top-k experts differ); the aux loss is
    dropped, as the reference's decode drops it.
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
        x, _ = block.ffn(block.attn_out(x, o))
    return model.logits(x), cache
