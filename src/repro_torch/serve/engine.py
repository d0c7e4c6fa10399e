"""LM serving with continuous batching: ``ServeEngine``.

The counterpart of the JAX package's ``serve/engine.py::ServeEngine``: a
fixed pool of B slots shares one KV cache of static shape. Requests are
admitted into free slots; their prompts are fed token by token into the
slot's cache region (per-slot positions through the batched
``decode_step``), then all active slots decode in lockstep. A finished
slot (EOS, ``max_new_tokens`` or the cache's end) is freed at once and
can be refilled without disturbing its neighbours.

Each step runs one ``decode_step`` on the model's device (kernel B3 for
every layer's attention on the card), samples there (greedy ``argmax``
by default) and reads the (B,) next tokens back to the host once.
``PageRankServer`` comes with the PageRank serving slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import LMConfig
from ..models import transformer as tf


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


class ServeEngine:
    def __init__(self, cfg: LMConfig, model: tf.LM, *, batch_slots: int = 4,
                 max_len: int = 256, eos_id: int = -1,
                 sample: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.device = model.device           # the cache lives with the model
        self.b = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.sample = sample or (lambda logits: logits.argmax(-1))
        self.cache = tf.init_cache(cfg, batch_slots, max_len,
                                   device=self.device)
        self.t = np.zeros(batch_slots, dtype=np.int32)   # next position
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.pending_prompt: list[list[int]] = [[] for _ in range(batch_slots)]
        self.steps = 0                                   # decode_step calls

    # ---------------------------------------------------------- admission
    def fits(self, req: Request) -> bool:
        """Whether the request can EVER be admitted: prompt plus token
        budget must stay inside the static per-slot cache region (the
        last KV write for a full generation lands at position
        ``len(prompt) + max_new_tokens - 2``; anything longer would be
        truncated or, for prompts past ``max_len``, corrupt the
        slot)."""
        return len(req.prompt) + req.max_new_tokens <= self.max_len

    def add_request(self, req: Request) -> bool:
        if not self.fits(req):
            return False
        for i in range(self.b):
            if self.slot_req[i] is None:
                self.slot_req[i] = req
                self.pending_prompt[i] = list(req.prompt)
                self.t[i] = 0
                return True
        return False

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # -------------------------------------------------------------- step
    def step(self):
        """Advance every active slot by one token (prompt feed or
        generation), one batched decode_step."""
        tokens = np.zeros((self.b, 1), dtype=np.int64)
        feeding = [False] * self.b
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.pending_prompt[i]:
                tokens[i, 0] = self.pending_prompt[i].pop(0)
                feeding[i] = True
            elif req.generated:
                tokens[i, 0] = req.generated[-1]
            elif req.prompt:
                tokens[i, 0] = req.prompt[-1]
        logits, self.cache = tf.decode_step(
            self.model, self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.t).to(self.device))
        self.steps += 1
        next_tok = self.sample(logits[:, 0, :]).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.t[i] += 1
            if feeding[i] and self.pending_prompt[i]:
                continue                         # still prefilling
            if not feeding[i] or not self.pending_prompt[i]:
                tok = int(next_tok[i])
                req.generated.append(tok)
                if (tok == self.eos_id
                        or len(req.generated) >= req.max_new_tokens
                        or self.t[i] >= self.max_len - 1):
                    req.done = True
                    self.slot_req[i] = None      # slot freed

    def run_until_drained(self, requests: list[Request],
                          max_steps: int = 10_000) -> list[Request]:
        queue = []
        for req in requests:
            # never-fitting requests are rejected up front instead of
            # blocking the head of the line forever
            if self.fits(req):
                queue.append(req)
            else:
                req.error = (f"prompt ({len(req.prompt)}) + "
                             f"max_new_tokens ({req.max_new_tokens})"
                             f" exceed max_len={self.max_len}")
                req.done = True
        for _ in range(max_steps):
            # every queued request fits, so admission only waits on a
            # free slot — no per-step queue rescans once the pool fills
            while queue and self.active < self.b:
                self.add_request(queue.pop(0))
            if not queue and self.active == 0:
                break
            if self.active:
                self.step()
        return requests
