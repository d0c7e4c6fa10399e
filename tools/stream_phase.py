#!/usr/bin/env python3
"""Phase 6 of ``chip_smoke.py`` (streaming edge deltas) alone, on one
CUDA card: the kernels built, the kron-21 graph and its pcpm_pallas
session made as phase 3 makes them, then ``streaming_phase``.

    python3 tools/stream_phase.py       # from the root of a checkout

Prints the phase's lines and, last, B1's two kernel entries with the
``"streaming"`` dicts the phase adds. Exits non-zero where a gate fails.
"""
import json
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
    from repro_torch.kernels import build_all
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    for built in build_all():
        cs.log(f"build: {built.path.name} {built.seconds:.2f} s")
    card, cfg = cs.card_line(), cs.kron()
    t0 = time.perf_counter()
    g = generators.rmat(cs.SCALE, cfg.edge_factor, seed=0)
    sess = open_session(g, EngineConfig(method="pcpm_pallas",
                                        part_size=cfg.part_size,
                                        num_iterations=cfg.num_iterations),
                        device="cuda")
    sess.pagerank()
    torch.cuda.synchronize()
    cs.log(f"graph, plan and first solve: {time.perf_counter() - t0:.1f} s")
    tile, warp = dict(cs.B1_ENTRY, path="tile"), dict(cs.B1_ENTRY,
                                                      path="warp")
    cs.streaming_phase(torch.device("cuda"), card, {"g": g, "sess": sess},
                       tile, warp)
    print(json.dumps({"kernels": [tile, warp]}), flush=True)


if __name__ == "__main__":
    main()
