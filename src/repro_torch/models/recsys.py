"""MIND: multi-interest network with dynamic (capsule) routing
[arXiv:1904.08030]: serving and training.

The counterpart of the JAX package's ``models/recsys.py``: ``init_mind``,
``param_shapes``, ``lookup``, ``interests``, ``label_aware_attention``,
``mind_loss``, ``make_train_step``, ``serve_step`` and
``retrieval_step``. The parameters live in an ``nn.Module`` (``MIND``),
float32 as the reference draws them; they require a gradient only inside
``MIND.trainable()``, which the train step enters.

The embedding lookup is the hot path, and every ``lookup`` is kernel B2
on one-id bags: ``kernels/embedding_bag/ops.py::embedding_lookup``, one
launch per call into an output of shape (..., d) (the row, or zeros for
an id >= V; an id < 0 reads row 0, as the reference's clip does). So
``serve_step`` launches B2 once and ``retrieval_step`` twice (the
history, then the candidates). ``mind_loss`` looks up the history and
the target in one B2 call, so a train step launches B2 once and its
backward B2-bwd once, which writes the table's dense (V, d) gradient.

The reference's ``shard(...)`` annotations place activations on a
(data, model) mesh; on one card they have no counterpart and are
dropped.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import RecSysConfig
from ..device import resolve_device
from ..kernels.embedding_bag.ops import embedding_lookup

PARAM_NAMES = ("table", "bilinear", "route_init", "out_proj")
# rows of the in-batch softmax's (B, B) logits made at a time: at
# train_batch (B 65,536) the whole float32 matrix is 17.2 GB, and its
# log-softmax and gradient would hold several such copies
LOSS_BLOCK_ROWS = 8192


class MIND(nn.Module):
    """MIND's parameters: the item table (V, d), the bilinear map (d, d),
    the routing prior (hist_len, K) and the output projection (d, d).
    No parameter requires a gradient outside ``trainable()``."""

    def __init__(self, cfg: RecSysConfig, table: torch.Tensor,
                 bilinear: torch.Tensor, route_init: torch.Tensor,
                 out_proj: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        for name, value in zip(PARAM_NAMES,
                               (table, bilinear, route_init, out_proj)):
            setattr(self, name, nn.Parameter(value, requires_grad=False))

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


def param_shapes(cfg: RecSysConfig) -> dict[str, torch.Tensor]:
    """The reference's ``param_shapes``: each parameter's shape and dtype
    (float32), as meta tensors keyed like its pytree; nothing is
    allocated (the table at vocab 10M would be 2.56 GB)."""
    d, k = cfg.embed_dim, cfg.n_interests
    shapes = {"table": (cfg.vocab, d), "bilinear": (d, d),
              "route_init": (cfg.hist_len, k), "out_proj": (d, d)}
    return {name: torch.empty(shape, dtype=torch.float32, device="meta")
            for name, shape in shapes.items()}


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
    # the (B, L, d) rows are dropped once projected: at serve_bulk each
    # of the two is 3.36 GB
    return _capsules(params, cfg, hist, lookup(params.table, hist))


def _capsules(params: MIND, cfg: RecSysConfig, hist: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``interests`` on the history's looked-up rows (B, L, d). Only the
    last routing iteration passes a gradient to the rows, as the
    reference's ``stop_gradient`` does."""
    b_sz, l = hist.shape
    k = cfg.n_interests
    eh = rows @ params.bilinear                                  # (B, L, d)
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


def _block_nll(user: torch.Tensor, tgt: torch.Tensor,
               first: int) -> torch.Tensor:
    """The summed negative log-likelihood of the rows ``first`` ...
    ``first + len(user) - 1`` of the in-batch softmax, each row's label
    on the diagonal of the (B, B) logits."""
    logits = user @ tgt.T                                  # (rows, B)
    gold = logits.diagonal(offset=first)
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def mind_loss(params: MIND, cfg: RecSysConfig, batch: dict) -> torch.Tensor:
    """The reference's in-batch sampled-softmax loss: the users' vectors
    (B, d) against the targets' rows (B, d), the positives on the
    diagonal of the (B, B) logits; the mean over users of
    logsumexp(logits[i]) - logits[i, i].

    batch: "hist" (B, L) and "target" (B,) item ids. The history and the
    target are looked up in one B2 call. The logits are made
    ``LOSS_BLOCK_ROWS`` rows at a time, each block checkpointed (its
    logits made again in the backward), so no (B, B) matrix is ever
    whole."""
    hist, target = batch["hist"], batch["target"]
    b, l = hist.shape
    ids = torch.cat([hist, target.to(hist.dtype)[:, None]], dim=1)
    rows = lookup(params.table, ids)                       # (B, L + 1, d)
    caps = _capsules(params, cfg, hist, rows[:, :l])       # (B, K, d)
    tgt = rows[:, l]                                       # (B, d)
    user = label_aware_attention(caps, tgt)                # (B, d)
    total = user.new_zeros(())
    for first in range(0, b, LOSS_BLOCK_ROWS):
        total = total + checkpoint(
            _block_nll, user[first:first + LOSS_BLOCK_ROWS], tgt, first,
            use_reentrant=False)
    return total / b


def make_train_step(cfg: RecSysConfig, optimizer):
    """The reference's ``make_train_step``: ``step(params, opt_state,
    batch) -> (params, opt_state, {"loss", "gnorm"})``, the metrics 0-d
    float32 tensors on the model's device (no host read). The gradients
    of ``mind_loss`` (the table's dense, from B2-bwd) go to
    ``optimizer.update``, which updates the parameters in place
    (``optim.AdamW``)."""
    def step(params: MIND, opt_state, batch):
        names, tensors = zip(*params.named_parameters())
        with params.trainable():
            loss = mind_loss(params, cfg, batch)
            grads = torch.autograd.grad(loss, tensors)
        params, opt_state, gnorm = optimizer.update(
            dict(zip(names, grads)), opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}
    return step


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
