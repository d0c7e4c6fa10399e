"""The control of a cell's check: the plain reference put in the
program's place and computed in bfloat16, the precision below the
configurations' float32, compared by the cell's own check.

    python3 bench/control.py --workload kron-solve --seeds 11 12 13

For each seed it draws the cell's graph as a run does, has the cell's
load generator make its answers with the reference (its ``control``)
and judge them with its ``check``, and prints the compared numbers
beside the traffic's limits; each has to read above its limit. The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench import spec as specs  # noqa: E402

# the precision below the configurations' float32
DTYPE = torch.bfloat16


def control(workload: str, seed: int, device, *, root=specs.ROOT,
            bench=specs.BENCH, config_overrides=None,
            traffic_overrides=None) -> dict:
    """The compared numbers of the control of ``workload`` on ``seed``."""
    spec = specs.load_spec(root)
    cell = specs.find_cell(spec, workload)
    config = dict(specs.load_config(spec, cell, root),
                  **(config_overrides or {}))
    traffic = dict(specs.load_traffic(cell["traffic"], bench),
                   **(traffic_overrides or {}))
    run = harness.Run(cell, config, traffic, int(seed), 0.0, False,
                      torch.device(device), time.perf_counter())
    harness.draw_arcs(run, bench)
    return specs.loadgen(traffic, bench).control(run, DTYPE)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    spec = specs.load_spec()
    traffic = specs.load_traffic(specs.find_cell(
        spec, args.workload)["traffic"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control(args.workload, seed, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_bf16": numbers,
                          "limits": traffic["limits"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
