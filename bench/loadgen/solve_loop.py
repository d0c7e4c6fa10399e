"""Closed loop of whole PageRank solves from one caller.

Set-up opens a ``repro_torch`` session on the graph (host
preprocessing), runs the first solve (the lazy device layouts and the
kernel library) and ``warmup_solves`` more; the window then calls
``Session.pagerank()`` back to back until ``seconds`` have passed. Each
solve returns once its residuals are on the host, so its ranks are
ready on the card. The ranks of the window's solves at ``sample``
indices drawn from the seed, and of its last solve, are compared with
the plain reference's once the window has closed. ``control`` puts the
reference's own ranks, in a lower precision, in the program's place and
compares them the same way.

Traffic keys: ``num_iterations``, ``tol``, ``warmup_solves``,
``sample``, ``trace_offset_s``, ``trace_seconds``, ``limits``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import checks
from bench.devtrace import DeviceTrace
from bench.reference import pagerank as reference


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def engine_config(run):
    import repro_torch
    cfg, tr = run.config, run.traffic
    return repro_torch.EngineConfig(
        method=cfg["method"], part_size=int(cfg["part_size"]),
        damping=float(cfg["damping"]), num_iterations=int(tr["num_iterations"]), tol=float(tr["tol"]))


def run(run) -> None:
    import repro_torch
    tr, dev = run.traffic, run.device
    t = time.perf_counter()
    sess = repro_torch.open(run.graph, engine_config(run), device=dev)
    first = sess.pagerank()
    _sync(dev)
    run.prep_s = time.perf_counter() - t
    for _ in range(int(tr["warmup_solves"])):
        sess.pagerank()
    _sync(dev)
    rng = np.random.default_rng([run.seed, 1])
    keep = set(int(i) for i in rng.integers(0, 64, int(tr["sample"])))
    held, wrong_iters, i = {}, 0, 0
    want = int(tr["num_iterations"])
    trace = DeviceTrace(dev) if run.trace else None
    if trace is not None:
        trace.warm()
    traced_from = traced_to = None
    run.log(f"set-up done: prep {run.prep_s:.3f} s")
    run.open_window()
    end = run.t0 + run.seconds
    trace_at = run.t0 + float(tr["trace_offset_s"])
    while True:
        if trace is not None and traced_from is None and \
                time.perf_counter() >= trace_at:
            trace.start()
            traced_from = i
        res = sess.pagerank()
        wrong_iters += res.iterations != want
        if i in keep:
            held[i] = res.ranks
        last = res.ranks
        i += 1
        now = time.perf_counter()
        if traced_from is not None and traced_to is None and \
                now >= trace.t0 + float(tr["trace_seconds"]):
            trace.stop()
            traced_to = i
        if now >= end:
            break
    run.close_window()
    if trace is not None and traced_to is None:
        trace.stop()
        traced_to = i
    run.extra["solves"] = i
    run.attempted = i
    run.failed = wrong_iters
    held[i - 1] = last
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if trace is not None:
        trace.reduce()
        run.devtrace = trace
        run.trace_passes = (traced_to - traced_from) * want
        run.trace_width = 1
        run.log(f"traced {traced_to - traced_from} solves in "
                f"{trace.window_s:.4f} s, device busy {trace.busy_s}")
    # the program's state goes before the reference runs
    run.extra["held"] = {k: v.cpu().numpy() for k, v in held.items()}
    del held, last, res, first
    from repro_torch.core.plan import clear_plan_cache, release_device
    release_device(sess.plan)
    del sess
    clear_plan_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def check(run) -> dict:
    src, dst = (torch.from_numpy(a).to(run.device) for a in run.arcs)
    ref = reference.pagerank(src, dst, run.n,
                             damping=float(run.config["damping"]),
                             iterations=int(run.traffic["num_iterations"]))
    worst = {}
    for ranks in run.extra.pop("held").values():
        gaps = checks.ranks_gaps(torch.from_numpy(ranks), ref)
        for name, v in gaps.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def control(run, dtype) -> dict:
    """``check`` of a run whose one solve the plain reference made in
    ``dtype``, in the program's place."""
    src, dst = (torch.from_numpy(a).to(run.device) for a in run.arcs)
    ranks = reference.pagerank(src, dst, run.n,
                               damping=float(run.config["damping"]),
                               iterations=int(run.traffic["num_iterations"]),
                               dtype=dtype)
    run.extra["held"] = {0: ranks.to(torch.float32).cpu().numpy()}
    del src, dst, ranks
    return check(run)
