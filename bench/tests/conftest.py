"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src/`` on the path, and tiny sizes of each cell."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each cell's configuration and traffic cut to a CPU test's size
TINY = {
    "kron-solve": ({"scale": 10, "edge_factor": 8, "part_size": 512},
                   {"trace_offset_s": 0.1, "trace_seconds": 0.2}),
    "urand-solve": ({"scale": 10, "degree": 4, "part_size": 512},
                    {"trace_offset_s": 0.1, "trace_seconds": 0.2}),
    "kron-serve": ({"scale": 10, "edge_factor": 8, "part_size": 512},
                   {"clients": 4, "slots": 4, "max_queries": 400,
                    "warmup_queries": 2, "ramp_queries": 4, "sample": 4,
                    "trace_offset_s": 0.1, "trace_seconds": 0.3}),
}


# kron-serve is not a cell of BENCHMARK.json: its runs spread too widely
# between processes for a bound. Its load generator, mix and readers
# stay under bench/, and the tests run it from a copy of the spec that
# holds these entries, as a later PR would add them.
SERVING = {
    "workloads": [
        {"name": "kron-serve", "config": "kron", "traffic": "ppr_closed64",
         "chips": 1, "why": "kron-21 behind Session.gateway(slots=32): 64 "
         "closed-loop clients, 4-seed top-10 PPR at tol 1e-6"}],
    "end_to_end": [
        {"name": "serve_qps", "unit": "queries/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["kron-serve"]},
        {"name": "serve_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": ["kron-serve"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": moves, "workloads": ["kron-serve"]}
        for name, unit, better, source, layer, moves in [
            ("device_idle_pct.serve", "%", "lower", "device_trace",
             "device", "serve_qps"),
            ("spmv_roofline_pct.serve", "%", "higher", "device_trace",
             "SpMV engine and kernels", "serve_qps"),
            ("iters_per_query.serve", "iterations", "lower",
             "program_counter", "serving scheduler", "serve_qps"),
            ("queue_wait_p95_ms.serve", "ms", "lower", "program_span",
             "serving scheduler", "serve_p95_ms"),
            ("backlog_p95_ms.serve", "ms", "lower", "program_span",
             "gateway", "serve_p95_ms")]],
}
_SERVING_ROOT = []


def serving_root() -> Path:
    """A checkout root whose BENCHMARK.json is the spec with ``SERVING``
    added and whose ``bench`` is this benchmark's (made once a
    process, removed at its exit)."""
    if not _SERVING_ROOT:
        import atexit
        import json
        import shutil
        import tempfile
        from bench import spec as specs
        root = Path(tempfile.mkdtemp(prefix="bench-serving-"))
        atexit.register(shutil.rmtree, root, True)
        spec = specs.load_spec()
        for key, entries in SERVING.items():
            spec[key] = spec[key] + entries
        spec["per_layer"] = [
            dict(m, workloads=m["workloads"] + ["kron-serve"])
            if m["name"] == "prep_s" else m for m in spec["per_layer"]]
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        (root / "bench").symlink_to(specs.BENCH, target_is_directory=True)
        _SERVING_ROOT.append(root)
    return _SERVING_ROOT[0]


def spec_root(cell) -> Path:
    """The root whose BENCHMARK.json names ``cell``."""
    from bench import spec as specs
    return serving_root() if cell == "kron-serve" else specs.ROOT


def tiny_run(cell, *, seed=7, seconds=0.6, trace=False, root=None,
             bench=None):
    from bench import harness
    from bench import spec as specs
    config, traffic = TINY[cell]
    return harness.run_cell(
        cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
        t_start=time.perf_counter(), root=root or spec_root(cell),
        bench=bench or specs.BENCH, config_overrides=config,
        traffic_overrides=traffic)


@pytest.fixture
def tiny():
    return tiny_run
