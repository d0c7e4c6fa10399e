"""MIND: multi-interest network with dynamic (capsule) routing
[arXiv:1904.08030], serving path.

The counterpart of the JAX package's ``models/recsys.py`` for inference:
``init_mind``, ``lookup``, ``interests``, ``label_aware_attention``,
``serve_step`` and ``retrieval_step``. The parameters live in an
``nn.Module`` (``MIND``), float32 as the reference draws them.

The embedding lookup is the hot path, and every ``lookup`` is kernel B2
on one-id bags: ``kernels/embedding_bag/ops.py::embedding_lookup``, one
launch per call into an output of shape (..., d) (the row, or zeros for
an id >= V; an id < 0 reads row 0, as the reference's clip does). So ``serve_step`` launches B2 once and
``retrieval_step`` twice (the history, then the candidates).

The reference's ``shard(...)`` annotations place activations on a
(data, model) mesh; on one card they have no counterpart and are
dropped. ``mind_loss`` and ``make_train_step`` come with the training
slice (ROADMAP.md, Queue A).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import RecSysConfig
from ..device import resolve_device
from ..kernels.embedding_bag.ops import embedding_lookup

PARAM_NAMES = ("table", "bilinear", "route_init", "out_proj")


class MIND(nn.Module):
    """MIND's parameters: the item table (V, d), the bilinear map (d, d),
    the routing prior (hist_len, K) and the output projection (d, d).
    Inference only: no parameter requires a gradient."""

    def __init__(self, cfg: RecSysConfig, table: torch.Tensor,
                 bilinear: torch.Tensor, route_init: torch.Tensor,
                 out_proj: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        for name, value in zip(PARAM_NAMES,
                               (table, bilinear, route_init, out_proj)):
            setattr(self, name, nn.Parameter(value, requires_grad=False))


def init_mind(cfg: RecSysConfig, *, generator: torch.Generator | None = None,
              device=None) -> MIND:
    """Random float32 parameters in the reference's shapes and scales
    (normal; the table, bilinear map and output projection at d^-1/2, the
    routing prior at 1), drawn from ``generator`` on ``device`` (default
    ``"cuda"``). ``jax.random`` cannot be reproduced: parity tests load
    the reference's parameters with ``params_from_numpy``."""
    dev = resolve_device(device)
    d, v, k = cfg.embed_dim, cfg.vocab, cfg.n_interests

    def normal(shape, scale):
        # in place: MIND's table is 2.56 GB, a scaled copy would double it
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev).mul_(scale)

    return MIND(cfg, normal((v, d), d ** -0.5), normal((d, d), d ** -0.5),
                normal((cfg.hist_len, k), 1.0), normal((d, d), d ** -0.5))


def params_from_numpy(cfg: RecSysConfig, tree: dict, *,
                      device=None) -> MIND:
    """The port's ``MIND`` holding the parameters of the reference's
    ``init_mind`` pytree given as numpy arrays."""
    dev = resolve_device(device)
    return MIND(cfg, *(torch.from_numpy(np.array(tree[name], np.float32))
                       .to(dev) for name in PARAM_NAMES))


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (...) -> rows (..., d); an id >= V gives a zero row. One B2
    launch on one-id bags, written in the final shape (the plain version
    on the CPU)."""
    return embedding_lookup(table, ids)


def interests(params: MIND, cfg: RecSysConfig,
              hist: torch.Tensor) -> torch.Tensor:
    """Multi-interest extraction: hist (B, L) item ids (pad >= vocab)
    -> (B, K, d) interest capsules via ``capsule_iters`` routing
    iterations."""
    b_sz, l = hist.shape
    k = cfg.n_interests
    # the (B, L, d) rows are dropped once projected: at serve_bulk each
    # of the two is 3.36 GB
    eh = lookup(params.table, hist) @ params.bilinear           # (B, L, d)
    mask = (hist < cfg.vocab).to(torch.float32)                  # (B, L)
    logit_mask = (mask - 1.0) * 1e9
    b_route = params.route_init[None].expand(b_sz, l, k)
    caps = None
    for it in range(cfg.capsule_iters):
        w = torch.softmax(b_route + logit_mask[..., None], dim=-1)
        last = it == cfg.capsule_iters - 1
        caps = _squash(torch.einsum("blk,bld->bkd", w * mask[..., None],
                                    eh if last else eh.detach()))
        if not last:
            b_route = b_route + torch.einsum("bld,bkd->blk", eh.detach(),
                                             caps)
    return caps @ params.out_proj                                # (B, K, d)


def label_aware_attention(caps: torch.Tensor, target: torch.Tensor, *,
                          power: float = 2.0) -> torch.Tensor:
    """caps (B, K, d), target (B, d) -> user vector (B, d)."""
    att = torch.einsum("bkd,bd->bk", caps, target)
    att = torch.softmax(power * att, dim=-1)
    return torch.einsum("bk,bkd->bd", att, caps)


def serve_step(params: MIND, cfg: RecSysConfig,
               hist: torch.Tensor) -> torch.Tensor:
    """Online inference: user history -> K interest vectors."""
    return interests(params, cfg, hist)


def retrieval_step(params: MIND, cfg: RecSysConfig, hist: torch.Tensor,
                   cand: torch.Tensor, *, top_k: int = 64):
    """Score one (or few) users against a candidate set.

    hist (B, L); cand (Ncand,) item ids. The max over interests (MIND's
    retrieval rule), then the top k: (scores (B, k), positions in
    ``cand`` (B, k)), as ``jax.lax.top_k`` returns them (the order of
    equal scores may differ)."""
    caps = interests(params, cfg, hist)                          # (B, K, d)
    ce = lookup(params.table, cand)                              # (N, d)
    scores = torch.einsum("bkd,nd->bkn", caps, ce).amax(dim=1)   # (B, N)
    return torch.topk(scores, top_k, dim=-1)
