#!/usr/bin/env python3
"""Phase 7b of ``chip_smoke.py`` (the sharded path at world size 1) alone,
on one CUDA card: the kron-21 graph, its pcpm and pcpm_pallas sessions and
their 20-iteration ranks, and the float64 oracle, made as phase 3 makes
them; then ``sharded_phase``, which opens its own one-rank NCCL group.

    python3 tools/sharded_phase.py      # from the root of a checkout

Prints the phase's lines. Exits non-zero where a gate fails.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.graphs import generators
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    card, cfg = cs.card_line(), cs.kron()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = generators.rmat(cs.SCALE, cfg.edge_factor, seed=0)
    sessions, ranks = {}, {}
    for method in ("pcpm", "pcpm_pallas"):
        sessions[method] = open_session(g, EngineConfig(
            method=method, part_size=cfg.part_size,
            num_iterations=cfg.num_iterations), device=dev)
        ranks[method] = sessions[method].pagerank().ranks.cpu().numpy()
    oracle = cs.oracle_pagerank(cs.transpose_adjacency(g), g.out_degree)
    torch.cuda.synchronize()
    cs.log(f"graph, plans, first solves and oracle: "
           f"{time.perf_counter() - t0:.1f} s")
    cs.sharded_phase(dev, card, {"g": g, "oracle": oracle, "ranks": ranks,
                                 "pcpm_sess": sessions["pcpm"]})


if __name__ == "__main__":
    main()
