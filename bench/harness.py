"""One run of one cell: set-up, the measured window, the readers, the
check against the plain reference, and the result line.

``run_cell`` does the work on any device (the tests call it on the CPU
at a tiny size, with ``overrides`` for the configuration and the
traffic); ``main`` is the command's body: it refuses to run without
enough CUDA cards, prints the compared numbers as the last lines of
standard error and the result as the last line of standard output.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Optional

from . import spec as specs

# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a run measured, for the load generators and the readers."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    n: int = 0
    m: int = 0
    graph: Any = None             # the repro_torch Graph handed to the program
    arcs: Any = None              # (src, dst) host int32 arrays, the benchmark's
    prep_s: Optional[float] = None
    setup_s: Optional[float] = None
    t0: Optional[float] = None    # window, host perf_counter
    t1: Optional[float] = None
    memory_peak_bytes: int = 0
    devtrace: Any = None          # devtrace.DeviceTrace of the traced window
    trace_passes: Optional[int] = None   # SpMV passes inside the traced window
    trace_width: Optional[int] = None    # columns of each of those passes
    attempted: int = 0
    failed: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    def open_window(self) -> None:
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start

    def close_window(self) -> None:
        self.t1 = time.perf_counter()

    def log(self, what: str) -> None:
        """A progress line on standard error, with the seconds since the
        process started."""
        print(f"bench: {time.perf_counter() - self.t_start:9.3f} s {what}",
              file=sys.stderr, flush=True)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, root: Path = specs.ROOT,
             bench: Path = specs.BENCH,
             config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None) -> tuple[dict, dict]:
    """Runs ``workload`` once; returns (result line, compared numbers
    with their limits)."""
    import torch
    from . import checks
    spec = specs.load_spec(root)
    cell = specs.find_cell(spec, workload)
    config = {**specs.load_config(spec, cell, root),
              **(config_overrides or {})}
    traffic = {**specs.load_traffic(cell["traffic"], bench),
               **(traffic_overrides or {})}
    load = specs.loadgen(traffic, bench)
    run = Run(cell, config, traffic, int(seed), float(seconds), bool(trace),
              torch.device(device), t_start)
    run.extra["device_kind"] = (torch.cuda.get_device_name(run.device)
                                if run.device.type == "cuda" else "cpu")
    run.log("imports done")
    make_graph(run, bench)
    run.log(f"graph {config['name']}: n {run.n}, m {run.m}")
    load.run(run)
    run.log(f"window closed: {run.window_s:.3f} s, setup {run.setup_s:.3f} s, "
            f"prep {run.prep_s:.3f} s")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in specs.cell_metrics(spec, workload, kind):
        value = specs.reader(entry["name"], bench).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    if run.devtrace is not None:
        run.extra["breakdown"] = run.devtrace.breakdown()
    # the check runs once the window has closed and the peak was read;
    # the load generator frees the program's state first
    numbers = load.check(run)
    run.log("reference checked")
    ok, compared = checks.verdict(numbers, traffic["limits"])
    dev = run.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(run.memory_peak_bytes),
    }
    if trace and run.devtrace is not None and run.devtrace.busy_s:
        device_info["busy_s"] = run.devtrace.busy_s
        device_info["window_s"] = run.devtrace.window_s
    result = {"correct": bool(ok and run.failed == 0),
              "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": device_info}
    if trace and "breakdown" in run.extra:
        result["breakdown"] = run.extra["breakdown"]
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in compared.items()}
    return result, compared


def _finite(x):
    """A JSON-safe number: non-finite values as their names."""
    import math
    return x if math.isfinite(x) else repr(x)


def draw_arcs(run: Run, bench: Path) -> None:
    """The configuration's graph, drawn on the device from the seed and
    kept as host int32 arrays (``run.arcs``), which both the program and
    the reference are given."""
    import numpy as np
    gen = specs.generator(run.config, bench)
    n, src, dst = gen.make(run.config, run.seed, run.device)
    src_h = src.cpu().numpy().astype(np.int32, copy=False)
    dst_h = dst.cpu().numpy().astype(np.int32, copy=False)
    run.n, run.m = int(n), int(src_h.shape[0])
    run.arcs = (src_h, dst_h)


def make_graph(run: Run, bench: Path) -> None:
    """``draw_arcs``, then the arcs handed to the program as its Graph;
    the device copies are freed and the peak-memory count restarts
    after it."""
    import torch
    from repro_torch.graphs.formats import Graph
    draw_arcs(run, bench)
    run.graph = Graph(run.n, *run.arcs)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)


def main(argv, t_start: float) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        spec = specs.load_spec()
        chips = int(specs.find_cell(spec, args.workload)["chips"])
    except (OSError, KeyError, ValueError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    try:
        result, compared = run_cell(
            args.workload, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device="cuda:0", t_start=t_start)
    except Exception:                 # noqa: BLE001 — no result line
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, v in compared.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
