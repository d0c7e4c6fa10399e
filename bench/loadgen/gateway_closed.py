"""Closed loop of personalized PageRank queries through the gateway.

Set-up opens a ``repro_torch`` session (host preprocessing), builds its
gateway with a fixed slot count (``Session.gateway(slots=...)``, so the
slot autotune does not probe), and serves the first query (the lazy
device layouts and the kernel library), then ``warmup_queries`` at
once. ``clients`` threads then each submit a query, wait for its
future and submit the next, with no think time. Once ``ramp_queries``
have completed the window opens; clients submit no query after it
closes, and every query still open then is waited for.

Each query is a dense (n,) teleport vector over ``seeds_per_query``
nodes drawn uniformly from the seed, with ``top_k``, ``tol``,
``max_iters`` and ``route``. The queries are drawn in one list before
the run; clients take them in order.

Once the window has closed, ``sample`` completed queries drawn from the
seed, with the one that took most iterations, are compared with the
plain reference's personalized PageRank of the same seed nodes.
``control`` puts the reference's own answers, in a lower precision, in
the program's place and compares them the same way.

Traffic keys: the above, ``slots``, ``chunk``, ``max_queries``,
``trace_offset_s``, ``trace_seconds``, ``observe_capacity``,
``wait_s``, ``limits``; a reference key ``reference_tol``.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench import checks
from bench.devtrace import DeviceTrace
from bench.reference import pagerank as reference


def draw_queries(seed: int, n: int, traffic: dict) -> np.ndarray:
    """(max_queries, seeds_per_query) node ids, uniform over all nodes,
    from the seed alone."""
    rng = np.random.default_rng([seed, 2])
    count, k = int(traffic["max_queries"]), int(traffic["seeds_per_query"])
    return rng.integers(0, n, (count, k), dtype=np.int64)


def dense(n: int, nodes: np.ndarray) -> np.ndarray:
    v = np.zeros(n, dtype=np.float32)
    v[nodes] = 1.0
    return v


class Clients:
    """The closed loop's clients and what each query saw: one thread a
    client, each submitting its next query as soon as its last one
    resolves."""

    def __init__(self, gw, n, queries, traffic):
        self.gw, self.n, self.queries, self.tr = gw, n, queries, traffic
        self.next = itertools.count()
        self.lock = threading.Lock()
        self.done = threading.Condition(self.lock)
        self.completed = 0
        self.stop_at = math.inf
        # (index, t_submit, t_done, QueryResult or None, error or None)
        self.records: list = []
        self.threads = [threading.Thread(target=self._loop, daemon=True,
                                         name=f"bench-client-{i}")
                        for i in range(int(traffic["clients"]))]

    def _record(self, idx, t_s, res, err):
        t_d = time.perf_counter()
        with self.lock:
            self.records.append((idx, t_s, t_d, res, err))
            self.completed += 1
            self.done.notify_all()

    def _loop(self):
        """One client: its own (n,) vector, whose last query's nodes are
        cleared and the next one's set, which is safe once that query's
        future resolved (the scheduler normalizes the seeds into its own
        array at intake)."""
        tr = self.tr
        vec = np.zeros(self.n, dtype=np.float32)
        last = np.zeros(0, dtype=np.int64)
        while True:
            with self.lock:
                idx = next(self.next)
            if idx >= len(self.queries):
                return
            vec[last] = 0.0
            last = self.queries[idx]
            vec[last] = 1.0
            t_s = time.perf_counter()
            if t_s >= self.stop_at:
                return
            try:
                fut = self.gw.submit(
                    vec, top_k=int(tr["top_k"]), tol=float(tr["tol"]),
                    max_iters=int(tr["max_iters"]), route=tr["route"])
                res = fut.result(timeout=float(tr["wait_s"]))
            except TimeoutError:
                # the query may still read ``vec``: this client stops
                self._record(idx, t_s, None, "no answer in wait_s")
                return
            except Exception as exc:      # noqa: BLE001 — a failed query
                self._record(idx, t_s, None, f"{type(exc).__name__}: {exc}")
                continue
            self._record(idx, t_s, res, res.error)

    def start(self):
        for t in self.threads:
            t.start()

    def wait_completed(self, count: int, timeout: float) -> None:
        with self.done:
            if not self.done.wait_for(lambda: self.completed >= count,
                                      timeout=timeout):
                raise RuntimeError(f"only {self.completed} of {count} "
                                   f"ramp queries completed in {timeout} s")

    def join(self, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        alive = [t.name for t in self.threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"clients still waiting after {timeout} s: "
                               f"{alive}")


def run(run) -> None:
    import repro_torch
    cfg, tr, dev = run.config, run.traffic, run.device
    queries = draw_queries(run.seed, run.n, tr)
    run.extra["queries"] = queries
    t = time.perf_counter()
    sess = repro_torch.open(
        run.graph, repro_torch.EngineConfig(
            method=cfg["method"], part_size=int(cfg["part_size"]),
            damping=float(cfg["damping"]), chunk=int(tr["chunk"])),
        device=dev)
    if run.trace:
        sess.observe(capacity=int(tr["observe_capacity"]))
    gw = sess.gateway(slots=int(tr["slots"]))
    kw = dict(top_k=int(tr["top_k"]), tol=float(tr["tol"]),
              max_iters=int(tr["max_iters"]), route=tr["route"])
    # warm-up queries come from the end of the list, which the window
    # never reaches
    spare = len(queries) - 1
    gw.submit(dense(run.n, queries[spare]), **kw).result()
    run.prep_s = time.perf_counter() - t
    futs = [gw.submit(dense(run.n, queries[spare - 1 - i]), **kw)
            for i in range(int(tr["warmup_queries"]))]
    for f in futs:
        f.result()
    trace = DeviceTrace(dev) if run.trace else None
    if trace is not None:
        trace.warm()
    run.log(f"warm-up done: prep {run.prep_s:.3f} s")
    clients = Clients(gw, run.n, queries[:spare - len(futs)], tr)
    clients.start()
    clients.wait_completed(int(tr["ramp_queries"]), float(tr["wait_s"]))
    run.open_window()
    clients.stop_at = run.t0 + run.seconds
    if trace is not None:
        time.sleep(max(0.0, run.t0 + float(tr["trace_offset_s"])
                       - time.perf_counter()))
        trace.start()
        time.sleep(float(tr["trace_seconds"]))
        trace.stop()
    time.sleep(max(0.0, clients.stop_at - time.perf_counter()))
    run.t1 = clients.stop_at
    clients.join(float(tr["wait_s"]))
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    sch = next(iter(getattr(gw, "_schedulers", {}).values()), None)
    gw.close()
    run.extra["records"] = clients.records
    run.extra["query_traces"] = (dict(sch.metrics.traces)
                                 if sch is not None else None)
    run.extra["spans"] = (sess.obs.tracer.recorder.snapshot()
                          if sess.obs is not None else None)
    ends = np.array([r[2] for r in clients.records if r[4] is None])
    edges = np.arange(run.t0, run.t1 + 1e-9, 5.0)
    run.log("answers in each 5 s of the window: "
            f"{np.histogram(ends, edges)[0].tolist()}")
    in_window = [r for r in clients.records if r[1] >= run.t0]
    run.attempted = len(in_window)
    run.failed = sum(r[4] is not None or r[3] is None or not r[3].converged
                     for r in in_window)
    if trace is not None:
        trace.reduce()
        run.devtrace = trace
        run.trace_width = int(tr["slots"])
        run.trace_passes = traced_passes(run.extra["spans"], trace)
        run.log(f"traced {trace.window_s:.4f} s, device busy "
                f"{trace.busy_s}, {run.trace_passes} passes")
    from repro_torch.core.plan import clear_plan_cache, release_device
    release_device(sess.plan)
    del sess, gw, sch
    clear_plan_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def traced_passes(spans, trace) -> int | None:
    """SpMV passes of the stepper chunks that ran wholly inside the
    traced window: the ``iters`` of each ``chunk`` span."""
    if spans is None:
        return None
    return sum(int(s.attrs.get("iters", 0)) for s in spans
               if s.name == "chunk" and s.t_start >= trace.t0
               and s.t_end <= trace.t1)


def latencies_s(run) -> list[float]:
    """Client latency of every query submitted in the window: submit to
    the future resolving, a query open at the window's close at its age
    then, a failed query as infinite."""
    out = []
    for _, t_s, t_d, res, err in run.extra["records"]:
        if t_s < run.t0 or t_s >= run.t1:
            continue
        if err is not None or res is None:
            out.append(math.inf)
        else:
            out.append(min(t_d, run.t1) - t_s)
    return out


def nearest_rank(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (the smallest value with at
    least q% of the values at or under it)."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def check(run) -> dict:
    tr = run.traffic
    done = sorted((r for r in run.extra["records"]
                   if r[1] >= run.t0 and r[3] is not None
                   and r[4] is None), key=lambda r: r[0])
    if not done:
        return {"topk_gap": math.inf}
    rng = np.random.default_rng([run.seed, 3])
    size = min(int(tr["sample"]), len(done))
    pick = set(int(i) for i in rng.choice(len(done), size, replace=False))
    pick.add(max(range(len(done)), key=lambda i: done[i][3].iterations))
    sample = [done[i] for i in sorted(pick)]
    queries = run.extra["queries"]
    src, dst = (torch.from_numpy(a).to(run.device) for a in run.arcs)
    seeds = torch.from_numpy(np.stack([queries[r[0]] for r in sample])
                             ).to(run.device)
    ref, _ = reference.personalized(
        src, dst, run.n, seeds, damping=float(run.config["damping"]),
        tol=float(tr["reference_tol"]), max_iters=int(tr["reference_iters"]))
    worst = 0.0
    for j, r in enumerate(sample):
        res = r[3]
        worst = max(worst, checks.topk_gap(res.top_ids, res.top_scores,
                                           ref[:, j], int(tr["top_k"])))
    return {"topk_gap": worst}


def control(run, dtype) -> dict:
    """``check`` of a run whose answers the plain reference made in
    ``dtype``, in the program's place: the first ``sample`` queries of
    the seed's list, each stopped at the traffic's ``tol`` or
    ``max_iters``, its top-k taken from the lower-precision ranks."""
    tr = run.traffic
    queries = draw_queries(run.seed, run.n, tr)
    run.extra["queries"] = queries
    count, k = int(tr["sample"]), int(tr["top_k"])
    src, dst = (torch.from_numpy(a).to(run.device) for a in run.arcs)
    got, steps = reference.personalized(
        src, dst, run.n, torch.from_numpy(queries[:count]).to(run.device),
        damping=float(run.config["damping"]), tol=float(tr["tol"]),
        max_iters=int(tr["max_iters"]), dtype=dtype)
    del src, dst
    run.t0 = 0.0
    records = []
    for j in range(count):
        ids, scores = reference.top_k(got[:, j].to(torch.float32), k)
        res = SimpleNamespace(top_ids=ids, top_scores=scores,
                              iterations=int(steps[j]), converged=True,
                              error=None)
        records.append((j, 0.0, 0.0, res, None))
    run.extra["records"] = records
    del got
    return check(run)
