"""AdamW and its cosine schedule, the counterparts of the JAX package's
``optim/adamw.py``: the same ``init``/``update`` interface and the same
arithmetic (global-norm clip, bias correction, decoupled weight decay,
moments stored in ``state_dtype`` with float32 math).

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``); an ``nn.Module`` stands for its
named parameters. Unlike the reference, which returns new arrays,
``update`` writes the new parameters and moments in place and returns
the same objects: the float32 temporaries of one leaf at a time are all
it allocates (at mixtral's width one expert weight of one layer is
1.9 GB in float32). Every value stays on the device: the step, the
learning rate and the norm are 0-d tensors, read by nobody here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: dict
    nu: dict


def _named(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # storage dtype of mu/nu (the math stays float32); "bfloat16" halves
    # the optimizer's memory, as the reference uses it for large models
    state_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        """Zero moments in ``state_dtype`` beside each parameter, and step
        0 on the parameters' device."""
        named = _named(params)
        sd = _DTYPES[self.state_dtype]
        device = next(iter(named.values())).device
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=device),
            {n: torch.zeros(p.shape, dtype=sd, device=p.device)
             for n, p in named.items()},
            {n: torch.zeros(p.shape, dtype=sd, device=p.device)
             for n, p in named.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params):
        """One step: (params, new state, gnorm), params and moments
        updated in place. ``grads`` is keyed like the parameters, in any
        float dtype; gnorm is the global L2 norm before the clip."""
        named = _named(params)
        step = state.step + 1
        stepf = step.float()
        lr = self.lr(step) if callable(self.lr) else self.lr
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in grads.values()))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        for name, p in named.items():
            g = grads[name].float() * scale
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_(self.b1 * mu.float() + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu.float() + (1 - self.b2) * g * g)
            del g
            # the moments as stored (rounded to state_dtype), as the
            # reference reads them back
            u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2)
                                      + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        return params, AdamWState(step, state.mu, state.nu), gnorm


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """The learning rate at a step (a tensor): linear warm-up to
    ``peak_lr``, then a cosine down to ``floor · peak_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
