"""PageRank driver (paper eq. 1/2) over any SpMV engine.

Matches the paper's algorithms: ranks are stored SCALED (PR/|N_o|)
during iteration (alg. 1 line 3 / alg. 2) and unscaled at the end.
Dangling nodes (|N_o| = 0) contribute nothing downstream, matching the
paper's implicit behaviour; their own rank is still computed.

Two drivers:

- ``driver="fused"`` (default): the power iteration runs on device
  tensors; the L1 residual is computed on the device every
  ``check_every`` iterations (and on the last) into a device buffer.
  With ``tol == 0`` nothing is read back until the end; with
  ``tol > 0`` one scalar is read per check to decide the early exit.
  The iteration count and the residual slots are those of the JAX
  package's ``lax.while_loop`` driver.
- ``driver="python"``: the per-iteration loop that reads the residual
  every iteration (used automatically for ``two_phase`` engines).

A fused solve that cannot exit early (``tol == 0``) on a CUDA device,
on a backend that does not shard, runs as one replay of a CUDA graph:
the first such solve of a loop runs eagerly, the second captures the
same loop and replays it, and later solves replay it (``_SolveGraph``).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..graphs.formats import Graph
from .spmv import SpMVEngine


@dataclasses.dataclass
class PageRankResult:
    ranks: torch.Tensor      # unscaled PR vector
    iterations: int
    residuals: list


def _inv_degree(g: Graph, device) -> torch.Tensor:
    """1 / out-degree (0 for sinks) as float32 on ``device``, memoized
    on the graph per device: one host pass and one upload per graph,
    not one per solve. Callers never write into it."""
    key = f"_inv_degree_{torch.device(device)}"
    inv = g.__dict__.get(key)
    if inv is None:
        out_deg = np.asarray(g.out_degree)
        inv = np.where(out_deg == 0, 0.0, 1.0 / np.maximum(out_deg, 1))
        inv = torch.from_numpy(inv).to(device=device, dtype=torch.float32)
        g.__dict__[key] = inv        # frozen-safe: dict write
    return inv


# ---------------------------------------------------------------------------
# Fused driver
# ---------------------------------------------------------------------------
def fused_power_iteration(engine: SpMVEngine, *, damping: float = 0.85,
                          num_iterations: int = 20, tol: float = 0.0,
                          check_every: int = 1, multi: bool = False,
                          dangling: str = "none"):
    """Build (and cache on the engine's plan) the fused iteration loop.

    Returns a callable ``run(pr0, inv_deg, base) -> (pr, it, residuals)``
    where ``base`` is the already-(1-damping)-scaled teleport vector
    (same shape as ``pr0``), and ``residuals`` is a (num_iterations,)
    device tensor with -1.0 in slots where convergence was not checked.

    With ``multi=True`` the state is (n, d) — d independent rank vectors
    iterated in lockstep; the recorded residual is the max over columns
    and the loop exits only once every column is below ``tol``.

    ``dangling="redistribute"`` adds sink handling: the rank mass
    parked on zero-out-degree nodes is summed each step and
    redistributed over the teleport distribution (``base`` rescaled by
    ``damping / (1 - damping)``), so total mass is conserved at 1. The
    default ``"none"`` keeps the paper's implicit drop-the-mass
    behaviour.
    """
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    key = ("fused", str(engine.device), damping, num_iterations, tol,
           check_every, multi, dangling)
    cached = engine._fused_cache.get(key)
    if cached is not None:
        return cached

    spmv = engine.spmv_fn()

    def run(pr, inv_deg, base):
        if multi:
            inv_deg = inv_deg[:, None]
        dang = (inv_deg == 0).to(pr.dtype)
        redist = base * (damping / (1.0 - damping))
        residuals = torch.full((max(num_iterations, 1),), -1.0,
                               dtype=torch.float32, device=pr.device)
        it = 0
        while it < num_iterations:
            # the SpMV returns a fresh buffer: the damping update runs in
            # place on it and it becomes the next rank buffer (the JAX
            # driver donates its rank buffer to the same end)
            pr_next = spmv(pr * inv_deg)           # scaled ranks (alg.1 l.3)
            pr_next.mul_(damping).add_(base)
            if dangling == "redistribute":
                pr_next.add_((pr * dang).sum(0) * redist)
            check = ((it + 1) % check_every == 0
                     or it + 1 >= num_iterations)
            if check:
                res = (pr_next - pr).abs_().sum(0)
                if multi:
                    res = res.max()
                residuals[it] = res
            pr = pr_next
            it += 1
            # the only host read inside the loop: one scalar per check,
            # and only when an early exit is possible
            if check and tol > 0 and 0.0 <= float(res) < tol:
                break
        return pr, it, residuals

    engine._fused_cache[key] = run
    return run


class StepperFailure(RuntimeError):
    """A chunk-stepper call that raised. ``pool_written`` tells whether
    it had already updated its ``pr`` in place (the scheduler may retry
    a call only when it had not)."""

    def __init__(self, exc: BaseException, pool_written: bool):
        super().__init__(f"{type(exc).__name__}: {exc}")
        self.pool_written = pool_written


def _host_any(t: torch.Tensor) -> bool:
    """``bool(t.any())``: the chunk stepper's one host read per
    iteration (a module function, so tests can count the reads)."""
    return bool(t.any())


def masked_chunk_stepper(engine: SpMVEngine, *, damping: float = 0.85,
                         chunk: int = 8, dangling: str = "none"):
    """Chunked variant of the fused loop for continuous-batching query
    serving: the state is an (n, B) slot pool of independent rank
    vectors, each column carrying its own convergence state, and one
    call advances every still-active column by up to ``chunk``
    iterations.

    Returns ``step(pr, base, active, tol_col, budget, inv_deg) ->
    (pr, active, took, res)``:

    - ``pr``/``base`` (n, B) float32: rank state and per-column
      (1-damping)-scaled teleport vectors. ``pr`` is updated in place
      and returned (the JAX package donates it).
    - ``active`` (B,) bool: columns still iterating. Converged (or
      empty) columns are frozen: masked out of the damping update, so
      their ranks stay bit-identical while neighbours keep iterating.
    - ``tol_col`` (B,) float32 / ``budget`` (B,) int32: per-column
      tolerance and remaining-iteration allowance, as data.
    - outputs: ``pr``; ``active`` with newly converged, budget-exhausted
      or non-finite columns cleared; ``took`` (B,) int32 iterations run
      per column in this call; ``res`` (B,) float32 last L1 residual per
      column (-1 for columns that never ran).

    The loop exits as soon as every column froze. Torch has no traced
    ``while_loop``, so that test is a host read of ``active.any()``
    (``_host_any``), made at the end of each iteration but the last: at
    most one read per iteration. The caller steps a pool with at least
    one active column, as ``SlotScheduler`` does (an all-frozen pool
    runs one SpMV that changes nothing). The SpMV always runs on the
    full (n, B) state; frozen columns have their update discarded.
    Cached on the plan's fused-loop cache under the reference's key
    (plus the device).
    """
    if dangling not in ("none", "redistribute"):
        raise ValueError(f"unknown dangling policy {dangling!r}")
    key = ("chunk", str(engine.device), damping, chunk, dangling)
    cached = engine._fused_cache.get(key)
    if cached is not None:
        return cached

    spmv = engine.spmv_fn()

    def step(pr, base, active, tol_col, budget, inv_deg):
        inv_col = inv_deg[:, None]
        if dangling == "redistribute":
            dang_col = (inv_col == 0).to(pr.dtype)
            redist = base * (damping / (1.0 - damping))
        took = torch.zeros(pr.shape[1], dtype=torch.int32, device=pr.device)
        res = torch.full((pr.shape[1],), -1.0, dtype=torch.float32,
                         device=pr.device)
        act = active.clone()
        # the SpMV's input, a contiguous (n, B) float32 buffer reused
        # for the residual's difference once the SpMV has read it
        work = torch.empty_like(pr)
        written = False
        try:
            for i in range(chunk):
                torch.mul(pr, inv_col, out=work)        # scaled ranks
                pr_next = spmv(work)                    # a fresh buffer
                pr_next.mul_(damping).add_(base)
                if dangling == "redistribute":
                    pr_next.add_((pr * dang_col).sum(0)[None, :] * redist)
                r = torch.sub(pr_next, pr, out=work).abs_().sum(0)  # (B,)
                torch.where(act[None, :], pr_next, pr, out=pr)  # freeze
                written = True
                res = torch.where(act, r, res)
                took += act.to(torch.int32)
                # quarantine: a non-finite residual freezes its column
                # at once (NaN fails the tolerance test anyway; +Inf
                # would keep burning budget), so the host sees it
                act &= torch.isfinite(r) & (r >= tol_col) & (took < budget)
                if i + 1 < chunk and not _host_any(act):
                    break
        except Exception as exc:
            raise StepperFailure(exc, pool_written=written) from exc
        return pr, act, took, res

    engine._fused_cache[key] = step
    return step


# CUDA graphs of fixed-count solves (``_run_fused``): captures made and
# replays run in this process (a capturing solve replays too). Reset by
# assigning 0.
graph_captures = 0
graph_replays = 0
_graph_lock = threading.Lock()
# what a loop's key holds in the plan's loop cache after its first
# graph-eligible solve, which runs eagerly: the second captures
_SEEN = "seen"


def graph_eligible(eng: SpMVEngine, tol: float) -> bool:
    """Whether a fused solve on ``eng`` runs as a replay of a captured
    CUDA graph: the device is CUDA, ``tol == 0`` (no host read inside
    the loop, exactly ``num_iterations``) and the backend does not shard
    (``core/distributed.py`` owns that loop)."""
    return (eng.device.type == "cuda" and tol == 0
            and not eng.backend.supports_sharding)


def _start_vectors(n: int, damping: float, device):
    """The uniform start vector and the (1-damping)-scaled teleport."""
    pr0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    base = torch.full((n,), (1.0 - damping) / n, dtype=torch.float32,
                      device=device)
    return pr0, base


@dataclasses.dataclass
class _SolveGraph:
    """One fixed-count solve captured as a CUDA graph: the start vectors
    and every launch of the fused loop's ``run``, in its order. ``ranks``
    and ``residuals`` are the graph's static outputs, which each replay
    overwrites; ``launches`` the B1 launches of one replay, by path.
    ``run`` (whose closure holds the device layouts) and ``inv_deg`` are
    held because the captured kernels read them: ``release_device`` may
    drop the plan's cache, and the graph ``inv_deg`` is memoized on may
    go, while a solve still replays this entry."""
    graph: torch.cuda.CUDAGraph
    ranks: torch.Tensor
    residuals: torch.Tensor
    iterations: int
    launches: dict
    run: object
    inv_deg: torch.Tensor
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def capture(cls, run, inv_deg: torch.Tensor, n: int,
                damping: float) -> "_SolveGraph":
        """Capture ``run`` from its start vectors, on a side stream,
        after a solve has run it eagerly (the warm-up: device layouts,
        B1's library). Raises if the capture fails. The kernels' launch
        counters move while ``run`` is captured though nothing runs, so
        the capture takes back this thread's launches and each replay
        adds them. One capture at a time in the process: captures share
        PyTorch's capture stream."""
        global graph_captures
        from ..kernels.pcpm_spmv import kernel
        graph = torch.cuda.CUDAGraph()
        with _graph_lock:
            before = dict(kernel.thread_launch_counts())
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    pr0, base = _start_vectors(n, damping, inv_deg.device)
                    pr, it, res = run(pr0, inv_deg, base)
            finally:
                after = kernel.thread_launch_counts()
                launches = {path: after[path] - before[path]
                            for path in kernel.PATHS}
                kernel.count_launches({p: -c for p, c in launches.items()})
            graph_captures += 1
        return cls(graph, pr, res, int(it), launches, run, inv_deg)

    def replay(self):
        """Run the captured solve on the current stream: ``(ranks, it,
        residuals)`` in fresh tensors (one device copy each out of the
        static outputs), so no result aliases a later solve's."""
        global graph_replays
        from ..kernels.pcpm_spmv import kernel
        with self.lock:
            self.graph.replay()
            out = self.ranks.clone(), self.iterations, self.residuals.clone()
        kernel.count_launches(self.launches)
        with _graph_lock:
            graph_replays += 1
        return out


def _run_fused(g: Graph, eng: SpMVEngine, *, num_iterations: int,
               damping: float, tol: float, check_every: int,
               dangling: str, span=None) -> PageRankResult:
    """The fused solve. ``span`` (an ``obs`` ``Span``, or None to record
    nothing) gets three children in turn: ``solve_start`` (the loop's
    closure, the start vectors, 1 / out-degree), ``solve_launch`` (the
    loop's launches; ``graph`` says whether they ran ``"eager"``, were
    captured and replayed, ``"capture"``, or replayed, ``"replay"``)
    and ``solve_readback`` (the host waiting for the residuals, so for
    the card). Graph-eligible solves (``graph_eligible``) of one loop
    run eagerly the first time, so a one-off solve pays no capture, and
    capture the second; the graph lives in the plan's loop cache next
    to the loop, so ``release_device`` drops it with them."""
    if eng.backend.supports_sharding:
        # a sharding backend owns its own loop (all-to-all + blocked
        # gather + all-reduced residual, core/distributed.py)
        from .distributed import distributed_pagerank
        return distributed_pagerank(
            g, eng.mesh, num_iterations=num_iterations, damping=damping,
            tol=tol, check_every=check_every, dangling=dangling,
            layout=eng.sharded_layout, fused_cache=eng._fused_cache)
    stage = None if span is None else span.child("solve_start")
    try:
        n = g.num_nodes
        run = fused_power_iteration(eng, damping=damping,
                                    num_iterations=num_iterations, tol=tol,
                                    check_every=check_every,
                                    dangling=dangling)
        inv_deg = _inv_degree(g, eng.device)
        graphed = graph_eligible(eng, tol)
        key = ("graph", str(eng.device), damping, num_iterations,
               check_every, dangling)
        cache = eng._fused_cache
        solve = cache.get(key) if graphed else None
        if solve is None:
            pr0, base = _start_vectors(n, damping, eng.device)
        if stage is not None:
            stage.end()
            stage = span.child("solve_launch")
        if solve is None:
            pr, it, res = run(pr0, inv_deg, base)
            mode = "eager"
            if graphed:
                cache[key] = _SEEN
        else:
            mode = "replay"
            if solve is _SEEN:
                solve = cache[key] = _SolveGraph.capture(run, inv_deg, n,
                                                         damping)
                mode = "capture"
            pr, it, res = solve.replay()
        if stage is not None:
            stage.end(iterations=int(it), b1_path=b1_path(eng), graph=mode)
            stage = span.child("solve_readback")
        res_host = res[:it].cpu().numpy()
    except Exception as e:
        if stage is not None:
            stage.end(status="error", error=repr(e))
        raise
    if stage is not None:
        stage.end()
    return PageRankResult(pr, int(it),
                          [float(r) for r in res_host if r >= 0.0])


def b1_path(eng: SpMVEngine):
    """The path kernel B1 takes in a solve on ``eng`` (d = 1), or None
    when its backend does not run B1."""
    path = eng.backend.b1_path
    return None if path is None else path(1)


# ---------------------------------------------------------------------------
# Python-loop driver (reads the residual on the host every iteration)
# ---------------------------------------------------------------------------
def _run_python(g: Graph, eng: SpMVEngine, *, num_iterations: int,
                damping: float, tol: float,
                dangling: str = "none") -> PageRankResult:
    n = g.num_nodes
    inv_deg = _inv_degree(g, eng.device)
    dang = (inv_deg == 0).to(torch.float32)
    pr = torch.full((n,), 1.0 / n, dtype=torch.float32, device=eng.device)
    base = (1.0 - damping) / n
    residuals = []
    it = 0
    for it in range(1, num_iterations + 1):
        spr = pr * inv_deg
        pr_next = base + damping * eng(spr)   # A^T @ SPR
        if dangling == "redistribute":
            pr_next = pr_next + (pr * dang).sum() * (damping / n)
        res = float((pr_next - pr).abs().sum())
        residuals.append(res)
        pr = pr_next
        if tol and res < tol:
            break
    return PageRankResult(pr, it, residuals)


def pagerank(g: Graph, *, method: str = "pcpm", num_iterations: int = 20,
             damping: float = 0.85, part_size: int = 65536,
             tol: float = 0.0, engine: SpMVEngine | None = None,
             driver: str = "fused", check_every: int = 1,
             dangling: str = "none", device=None,
             span=None) -> PageRankResult:
    """Compatibility front-end. ``method`` is resolved through the
    backend registry and the graph plan comes from the process-level
    plan cache, so repeated calls on one graph never re-sort edges.
    ``device`` defaults to ``"cuda"`` (ignored when ``engine`` is
    given: the engine's device is used). ``span``, an open ``obs``
    span, is the parent of the fused solve's stage spans. New code
    should prefer ``repro_torch.open(g, cfg).pagerank()``."""
    eng = engine or SpMVEngine(g, method=method, part_size=part_size,
                               device=device)
    if driver == "python" or eng.two_phase:
        # the engine's __call__ already maps reordered plans back to
        # the original labeling per pass — nothing to do here
        return _run_python(g, eng, num_iterations=num_iterations,
                           damping=damping, tol=tol, dangling=dangling)
    if driver != "fused":
        raise ValueError(f"unknown driver {driver!r}")
    if eng.plan.reorder_perm is None:
        return _run_fused(g, eng, num_iterations=num_iterations,
                          damping=damping, tol=tol,
                          check_every=check_every, dangling=dangling,
                          span=span)
    # reordered plan: iterate wholly in internal (relabeled) space —
    # the uniform start/teleport vectors are permutation-invariant, so
    # only the FINAL ranks pay one gather back to the original ids
    from .backends import reorder_device
    from .plan import internal_graph
    res = _run_fused(internal_graph(g, eng.plan), eng,
                     num_iterations=num_iterations, damping=damping,
                     tol=tol, check_every=check_every, dangling=dangling,
                     span=span)
    perm, _ = reorder_device(eng.plan, eng.device)
    res.ranks = res.ranks.index_select(0, perm)
    return res


def pagerank_reference(g: Graph, *, num_iterations: int = 20,
                       damping: float = 0.85,
                       dangling: str = "none") -> np.ndarray:
    """Dense numpy oracle for tests (small graphs only)."""
    n = g.num_nodes
    A = np.zeros((n, n), dtype=np.float64)
    np.add.at(A, (g.src, g.dst), 1.0)
    deg = np.maximum(g.out_degree, 1).astype(np.float64)
    inv = np.where(g.out_degree == 0, 0.0, 1.0 / deg)
    sink = (np.asarray(g.out_degree) == 0).astype(np.float64)
    pr = np.full(n, 1.0 / n)
    for _ in range(num_iterations):
        y = A.T @ (pr * inv)
        if dangling == "redistribute":
            y = y + (pr * sink).sum() / n
        pr = (1 - damping) / n + damping * y
    return pr
