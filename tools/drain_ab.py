#!/usr/bin/env python3
"""Phase 5's 64-query drain of ``chip_smoke.py``, timed several times in
one process, for an A/B of two checkouts on one card.

    python3 tools/drain_ab.py [--src DIR] [--drains N]

Builds the kron-21 graph and its pcpm_pallas session as phase 3 does,
then runs N + 1 drains (the first a warm-up): each a fresh
``sess.serve(slots=16, chunk=8)`` given phase 5's mix of 64 queries
(``default_rng(3)``, by ``i % 4``: uniform at 20 iterations; one seed,
top 10, tol 1e-3, pushed on the card at submit; four seeds at tol 1e-6;
uniform top 10) and drained. Prints, per drain, queries/s, the seconds
of the submits (which answer the 16 pushes inline) and of the stepper
chunks, then the medians. ``--src`` puts another checkout's ``src``
(such as the parent commit's, unpacked with ``git archive``) first on
the path, so one script times both; run them in turns in one call.
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--drains", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from repro_torch import EngineConfig, open as open_session
    from repro_torch.configs.pagerank_kron import CONFIG as cfg
    from repro_torch.graphs import generators
    from repro_torch.kernels import build_all
    if not torch.cuda.is_available():
        sys.exit("drain_ab: needs a CUDA card")
    build_all()
    import repro_torch
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    g = generators.rmat(21, cfg.edge_factor, seed=0)
    n = g.num_nodes
    sess = open_session(g, EngineConfig(method="pcpm_pallas",
                                        part_size=cfg.part_size),
                        device="cuda")
    sess.pagerank()
    torch.cuda.synchronize()
    print(f"{repro_torch.__file__}: graph, plan and a solve "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    rng = np.random.default_rng(3)
    work = []
    for i in range(64):
        kind = i % 4
        if kind == 0:
            work.append((None, dict(tol=0.0, max_iters=20)))
        elif kind == 1:
            work.append(([int(rng.integers(0, n))], dict(top_k=10,
                                                          tol=1e-3)))
        elif kind == 2:
            work.append((rng.integers(0, n, size=4).tolist(),
                         dict(tol=1e-6, max_iters=200)))
        else:
            work.append((None, dict(top_k=10, tol=0.0, max_iters=20)))

    def seed(ids):
        if ids is None:
            return None
        s = np.zeros(n, np.float32)
        s[ids] = 1.0
        return s

    rows = []
    for r in range(args.drains + 1):
        sch = sess.serve(slots=16, chunk=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ids, kw in work:
            sch.submit(seed(ids), **kw)
        t_submit = time.perf_counter() - t0
        sch.run_until_drained()
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        if len(sch.completed) != len(work) or any(
                q.error for q in sch.completed):
            sys.exit("drain_ab: a query did not end once, error-free")
        label = "warm-up" if r == 0 else f"drain {r}"
        print(f"{label}: {len(work) / t_all!r} queries/s, submits "
              f"{t_submit!r} s, chunks {t_all - t_submit!r} s", flush=True)
        if r:
            rows.append((len(work) / t_all, t_submit, t_all - t_submit))
    med = [statistics.median(c) for c in zip(*rows)]
    print(f"median of {args.drains}: {med[0]!r} queries/s, submits "
          f"{med[1]!r} s, chunks {med[2]!r} s ({card})", flush=True)


if __name__ == "__main__":
    main()
