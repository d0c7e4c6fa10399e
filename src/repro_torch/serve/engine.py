"""Serving engines: PageRank's lockstep ``PageRankServer`` and the LM's
continuous-batching ``ServeEngine``.

``PageRankServer`` (the counterpart of the JAX package's
``serve/engine.py::PageRankServer``) answers batched personalized
PageRank queries over a fixed graph. Construction does the expensive
work once (plan, device streams, inverse degrees, the fused loop), so a
query pays no rebuild: with ``batch > 1`` it iterates the (n, batch)
state in lockstep, one multi-vector SpMV per iteration (on a
pcpm_pallas plan, kernel B1's "warp" path at d = batch); with
``batch == 1`` the (n,) state, through B1's "tile" path. With
``sharded=True`` it serves from the all-to-all engine over the ranks of
the caller's process group (core/distributed.py): every rank makes the
same queries in the same order and gets the same answers.

``ServeEngine``, the counterpart of the JAX package's ``serve/engine.py::ServeEngine``: a
fixed pool of B slots shares one KV cache of static shape. Requests are
admitted into free slots; their prompts are fed token by token into the
slot's cache region (per-slot positions through the batched
``decode_step``), then all active slots decode in lockstep. A finished
slot (EOS, ``max_new_tokens`` or the cache's end) is freed at once and
can be refilled without disturbing its neighbours.

Each step runs one ``decode_step`` on the model's device (kernel B3 for
every layer's attention on the card), samples there (greedy ``argmax``
by default) and reads the (B,) next tokens back to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import LMConfig
from ..core.backends import reorder_device, resolve_engine
from ..core.pagerank import _inv_degree, fused_power_iteration
from ..core.plan import internal_graph, reorder_inverse
from ..core.spmv import SpMVEngine
from ..graphs.formats import Graph
from ..models import transformer as tf


# ---------------------------------------------------------------------------
# PageRank serving
# ---------------------------------------------------------------------------
def _normalize_teleport(host: np.ndarray) -> np.ndarray:
    """Validate and column-normalize teleport distributions (a single
    (n,) vector or (n, batch) columns)."""
    if host.ndim == 1:
        s = float(host.sum())
        if not (s > 0.0 and np.isfinite(s)):   # NaN fails s > 0.0
            raise ValueError(
                "every seed column must be finite with positive mass; "
                f"got column sums {s!r}")
        return host / np.float32(s)
    sums = host.sum(axis=0)
    if not (np.isfinite(sums).all() and np.all(sums > 0)):
        raise ValueError(
            "every seed column must be finite with positive mass; "
            f"got column sums {sums!r}")
    return host / sums


class PageRankServer:
    """Serve (personalized) PageRank queries from a fused iteration loop
    built once.

    ``batch`` > 1 serves a batch of personalization (seed) vectors in
    lockstep as one (n, batch) multi-vector iteration: the SpMV engines
    and kernel B1 are multi-vector native, so a batch costs one SpMV
    pass per iteration, not ``batch`` passes.

    Construction resolves the engine (the plan cache's plan), takes the
    inverse out-degrees in the plan's internal id space and builds the
    fused loop; ``query()`` only runs it. ``trace_count`` is 1 once the
    loop is built and stays 1 (the JAX package counts traces of its
    compiled loop; here it means the loop was built once).

    ``sharded=True`` serves from the sharded engine instead: the graph
    is vertex-sharded over ``num_shards`` ranks (default all of them)
    and each query runs the sharded loop — all-to-all scatter, blocked
    local gather, all-reduced residual (core/distributed.py) — over
    padded vectors; ranks outside a smaller mesh get the answer from
    rank 0. ``device`` defaults to ``"cuda"`` (ignored when ``engine``
    is given).
    """

    def __init__(self, g: Graph, *, method: str = "pcpm_pallas",
                 part_size: int = 65536, batch: int = 1,
                 damping: float = 0.85, num_iterations: int = 20,
                 tol: float = 0.0, check_every: int = 1,
                 dangling: str = "none", sharded: bool = False,
                 num_shards: int | None = None,
                 engine: SpMVEngine | None = None, device=None):
        self.g = g
        self.n = g.num_nodes
        self.batch = batch
        self.damping = damping
        self.engine = resolve_engine(g, method=method, sharded=sharded,
                                     part_size=part_size,
                                     num_shards=num_shards, engine=engine,
                                     device=device)
        self.sharded = self.engine.backend.supports_sharding
        self.device = self.engine.device
        self._uniform_cache = None
        # reordered plans: iterate in the plan's internal (relabeled)
        # space — seeds map in at query, ranks map back out, inverse
        # degrees come from the internal graph
        self._perm = self.engine.plan.reorder_perm
        self._inv = (None if self._perm is None
                     else reorder_inverse(self.engine.plan))
        gi = internal_graph(g, self.engine.plan)
        if self.sharded:
            from ..core.distributed import (padded_inv_degree,
                                            sharded_power_iteration)
            layout = self.engine.sharded_layout
            self._n_pad = layout.padded_nodes
            self._run = sharded_power_iteration(
                layout, self.engine.mesh, damping=damping,
                num_iterations=num_iterations, tol=tol,
                check_every=check_every, multi=batch > 1,
                dangling=dangling)
            self._inv_deg = padded_inv_degree(gi, layout, self.device)
        else:
            self._n_pad = self.n
            self._run = fused_power_iteration(
                self.engine, damping=damping,
                num_iterations=num_iterations, tol=tol,
                check_every=check_every, multi=batch > 1,
                dangling=dangling)
            self._inv_deg = _inv_degree(gi, self.device)
        self.trace_count = 1

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host (n, ...) array on the device, zero-padded to the
        shards' rows when sharded."""
        if self._n_pad != self.n:
            host = np.pad(host, ((0, self._n_pad - self.n),)
                          + ((0, 0),) * (host.ndim - 1))
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    def _uniform_batch(self):
        """The uniform-teleport start vector and base, both on the
        device and built once: the loops never write their start
        vector, so one buffer serves every uniform query."""
        if self._uniform_cache is None:
            shape = (self.n, self.batch) if self.batch > 1 else (self.n,)
            host = np.full(shape, 1.0 / self.n, dtype=np.float32)
            self._uniform_cache = (self._upload(host),
                                   self._upload((1.0 - self.damping) * host))
        return self._uniform_cache

    def query(self, seeds: np.ndarray | None = None):
        """Rank one batch. ``seeds``: (n, batch) per-query teleport
        distributions (columns need not be normalized — they are), or
        None for the uniform-teleport batch. Returns (ranks, iters,
        residuals) with ranks of shape (n, batch) (or (n,) when
        ``batch == 1``) on the device, and residuals as in
        ``PageRankResult`` (one float per convergence check, in
        iteration order)."""
        shape = (self.n, self.batch) if self.batch > 1 else (self.n,)
        if seeds is None:
            v, base = self._uniform_batch()
        else:
            host = _normalize_teleport(
                np.asarray(seeds, dtype=np.float32).reshape(shape))
            if self._perm is not None:
                host = host[self._inv]        # into internal space
            v = self._upload(host)
            base = (1.0 - self.damping) * v
        pr, it, res = self._run(v, self._inv_deg, base)
        if self.sharded:
            pr = pr[:self.n]
        if self._perm is not None:            # back to original ids
            perm_dev, _ = reorder_device(self.engine.plan, self.device)
            pr = pr.index_select(0, perm_dev)
        res_host = res[:it].cpu().numpy()
        return pr, int(it), [float(r) for r in res_host if r >= 0.0]


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------


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
