#!/usr/bin/env python3
"""Host sorts of the plan builders at the kron cell's chip scale: the
helpers of ``graphs/formats.py`` against ``np.lexsort`` and a stable
argsort of the same packed keys, on the same columns, timed in turns
(A B C C B A per round) on one host.

    python3 tools/host_sort_ab.py [--scale 21] [--rounds 1]

Sites (the kron graph from ``generators.rmat(scale, 31, seed=0)``):
  order1: ``lexsort_order(dst_s)``, build_png's gather order (one column);
  order3: ``lexsort_order(d_sh, s_sh, src)``, ``build_sharded_png``'s
          first order at 8 shards (three columns);
  sorted3: ``lexsorted(dstp, src, dst)``, build_png's first scan.
Each variant's result is checked equal to ``np.lexsort``'s. Prints one
JSON line of seconds per site and variant.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.pagerank_kron import CONFIG  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.graphs.formats import (_packed_keys, lexsort_order,  # noqa: E402
                                        lexsorted)

SHARDS = 8          # the sharded phase's layout


def stable_argsort(*cols):
    key, _ = _packed_keys(cols)
    return np.argsort(key, kind="stable")


def variants(cols):
    """site -> {variant: zero-argument call}; each call returns arrays
    that must equal the first variant's."""
    def gathered(order):
        return tuple(col[order] for col in cols)
    return {
        "np.lexsort": lambda: (np.lexsort(cols[::-1]),),
        "stable argsort of packed keys": lambda: (stable_argsort(*cols),),
        "packed keys, positions in the low bits": lambda: (
            lexsort_order(*cols),),
    }, {
        "np.lexsort + gathers": lambda: gathered(np.lexsort(cols[::-1])),
        "stable argsort of packed keys + gathers": lambda: gathered(
            stable_argsort(*cols)),
        "lexsorted (sort of the packed keys)": lambda: lexsorted(*cols),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    t0 = time.perf_counter()
    g = generators.rmat(args.scale, CONFIG.edge_factor, seed=0)
    print(f"graph rmat({args.scale}, {CONFIG.edge_factor}, seed=0): "
          f"n={g.num_nodes} m={g.num_edges}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dstp = g.dst.astype(np.int64) // CONFIG.part_size
    _, _, dst_s = lexsorted(dstp, g.src, g.dst)
    _, sorted3 = variants((dstp, g.src, g.dst))
    shard_size = -(-g.num_nodes // SHARDS)
    src = g.src.astype(np.int64)
    orders3, _ = variants((g.dst.astype(np.int64) // shard_size,
                           src // shard_size, src))
    orders1, _ = variants((dst_s,))
    sites = {"order1": orders1, "order3": orders3, "sorted3": sorted3}
    seconds = {site: {name: [] for name in calls}
               for site, calls in sites.items()}
    for site, calls in sites.items():
        names = list(calls)
        want = None
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                t = time.perf_counter()
                got = calls[name]()
                seconds[site][name].append(time.perf_counter() - t)
                if want is None:
                    want = got
                elif not all(np.array_equal(a, b)
                             for a, b in zip(got, want)):
                    sys.exit(f"host_sort_ab: {site} {name} differs from "
                             f"{names[0]}")
                del got
        for name in names:
            print(f"{site} (m={g.num_edges}): {name}: "
                  f"{seconds[site][name]!r} s", flush=True)
    print(json.dumps({"scale": args.scale, "edges": g.num_edges,
                      "seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
