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

    python3 tools/gateway_phase.py --obs-cost 3 [--idle-wait 0.05]

runs only the phase's observability cost (``chip_smoke.observability_
cost``) on an observed session's autotuned gateway, after one storm and
its repeats as the phase serves them: ``--obs-cost`` pairs of
measurements in alternating order, one without and one with a
``gc.collect()`` before each storm; with ``--idle-wait``, one at the
gateways' default idle poll and one at the one given; with
``--instances``, one with a gateway for both sides (as phase 7) and one
with a gateway a side.
Prints each measurement's queries/s a side over its storms and their
ratio, the best single storm a side and its ratio, and its runs;
``--rounds`` sets the storms a side (phase 7's 16 by default).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def obs_cost(sess, n: int, pairs: int, idle_wait_s, instances) -> None:
    """The observability-cost measurement alone, in two variants a pair
    (module docstring)."""
    from repro_torch.gateway import GatewayConfig
    card = cs.card_line()
    sess.observe(capacity=1 << 17)
    gw = sess.gateway(config=GatewayConfig(
        push_workers=cs.GATEWAY_PUSH_WORKERS,
        cache_entries=cs.GATEWAY_CACHE,
        target_chunk_s=cs.GATEWAY_TARGET_S,
        autotune_candidates=cs.GATEWAY_CANDIDATES))
    width = gw.autotune_report.chosen
    work = cs.serving_mix(np.random.default_rng(3), n,
                          cs.GATEWAY_SUBMITTERS * cs.GATEWAY_PER_THREAD)
    cs.gateway_storm(gw, work, n)
    cs.gateway_storm(gw, [w for w in work if w[0] in (1, 2)]
                     [:cs.GATEWAY_REPEATS], n)
    gw.close()
    variants = ([dict(), dict(instances=2)] if instances else
                [dict(collect=False), dict(collect=True)]
                if idle_wait_s is None else
                [dict(), dict(idle_wait_s=idle_wait_s)])
    for pair in range(pairs):
        for kw in variants if pair % 2 == 0 else variants[::-1]:
            qps, best, runs, live = cs.observability_cost(
                sess, width, work, n, **kw)
            cs.log(f"obs cost at B={width}, {kw or 'as phase 7'}; {live} "
                   f"objects tracked: off {qps['off']!r}, on "
                   f"{qps['on']!r}, ratio {qps['on'] / qps['off']!r}; best "
                   f"storm off {best['off']!r}, on {best['on']!r}, ratio "
                   f"{best['on'] / best['off']!r}; runs {runs} ({card})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--obs-cost", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--idle-wait", type=float, default=None, metavar="S")
    ap.add_argument("--rounds", type=int, default=cs.QPS_ROUNDS)
    ap.add_argument("--instances", action="store_true")
    args = ap.parse_args()
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
    if args.obs_cost:
        cs.QPS_ROUNDS = args.rounds
        obs_cost(sess, g.num_nodes, args.obs_cost, args.idle_wait,
                 args.instances)
        return
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
