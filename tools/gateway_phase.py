#!/usr/bin/env python3
"""Phase 7 of ``chip_smoke.py`` (the gateway and observability) alone, on
one CUDA card: the kernels built, the kron-21 graph, its pcpm_pallas
session and pcpm plan made as phase 3 makes them, A^T as the torch.sparse
yardstick, a delta like phase 6's D2 (8,192 insertions and removals in
the partition third nearest the median edge count), then
``gateway_phase``.

    python3 tools/gateway_phase.py      # from the root of a checkout

Prints the phase's lines and, last, B1's two kernel entries with the
``"gateway"`` dicts the phase adds. Exits non-zero where a gate fails.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.core.plan import PlanConfig, build_plan
    from repro_torch.graphs import generators
    from repro_torch.kernels import build_all
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    for built in build_all():
        cs.log(f"build: {built.path.name} {built.seconds:.2f} s")
    card, cfg = cs.card_line(), cs.kron()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = generators.rmat(cs.SCALE, cfg.edge_factor, seed=0)
    sess = open_session(g, EngineConfig(method="pcpm_pallas",
                                        part_size=cfg.part_size),
                        device=dev)
    sess.pagerank()
    build_plan(g, PlanConfig(method="pcpm", part_size=cfg.part_size))
    at = cs.transpose_adjacency(g)
    at_dev = torch.sparse_csr_tensor(
        torch.from_numpy(at.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(at.indices.astype(np.int64)).to(dev),
        torch.from_numpy(at.data.astype(np.float32)).to(dev),
        size=(g.num_nodes, g.num_nodes))
    # phase 6's D2: DELTA_EDGES + DELTA_EDGES in the partition third
    # nearest the median edge count (its D1 touches the first two only)
    counts = np.diff(sess.plan.png.edge_offsets)
    near = np.argsort(np.abs(counts - np.median(counts)), kind="stable")
    rng = np.random.default_rng(5)
    cs.local_delta(rng, g, [int(near[0]), int(near[1])], cs.D1_EDGES,
                   cfg.part_size)
    d2 = cs.local_delta(rng, g, [int(near[2])], cs.DELTA_EDGES,
                        cfg.part_size)
    torch.cuda.synchronize()
    cs.log(f"graph, plans and first solve: {time.perf_counter() - t0:.1f} s")
    tile, warp = dict(cs.B1_ENTRY, path="tile"), dict(cs.B1_ENTRY,
                                                      path="warp")
    cs.gateway_phase(dev, card, {"g": g, "plan": sess.plan,
                                 "at_dev": at_dev}, {"d2": d2}, tile, warp)
    print(json.dumps({"kernels": [tile, warp]}), flush=True)


if __name__ == "__main__":
    main()
