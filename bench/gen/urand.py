"""GAP Benchmark Suite's urand: a uniform random undirected graph.

2**scale nodes and 2**scale * degree undirected pairs, each endpoint
uniform over the nodes; every pair is stored as two arcs, and
self-loops and repeated arcs are dropped, as GAP's graph construction drops them
(so m is a little under 2 * pairs). The arcs come out sorted by
(source, destination).
"""
from __future__ import annotations

import torch

from bench.gen import torch_generator


def make(config: dict, seed: int, device):
    dev = torch.device(device)
    n = 1 << int(config["scale"])
    pairs = n * int(config["degree"])
    gen = torch_generator(seed, dev)
    ends = torch.randint(0, n, (2, pairs), generator=gen, device=dev,
                         dtype=torch.int64)
    u, v = ends[0], ends[1]
    keep = u != v
    u, v = u[keep], v[keep]
    keys = torch.cat([u * n + v, v * n + u])
    del ends, u, v, keep
    keys = torch.unique(keys)                       # sorted, no repeats
    return n, (keys // n).to(torch.int32), (keys % n).to(torch.int32)
