"""Graph500 Kronecker (R-MAT) graph, as the paper's kron graph is built.

2**scale nodes and 2**scale * edge_factor node pairs. For each of the
``scale`` bits one uniform draw per pair picks a quadrant with
probabilities a, b, c and 1 - a - b - c (the Graph500 reference's rule);
then one random permutation relabels the nodes, so that degree is not
correlated with id. The graph is undirected: every pair is stored as
two arcs, and self-loops and repeated arcs are dropped, as Graph500's
graph construction drops them (so m is under 2 * pairs). The arcs come
out sorted by (source, destination).
"""
from __future__ import annotations

import torch

from bench.gen import torch_generator


def make(config: dict, seed: int, device):
    dev = torch.device(device)
    scale = int(config["scale"])
    n = 1 << scale
    pairs = n * int(config["edge_factor"])
    a, b, c = float(config["a"]), float(config["b"]), float(config["c"])
    ab, abc = a + b, a + b + c
    gen = torch_generator(seed, dev)
    u = torch.zeros(pairs, dtype=torch.int64, device=dev)
    v = torch.zeros(pairs, dtype=torch.int64, device=dev)
    r = torch.empty(pairs, dtype=torch.float32, device=dev)
    for bit in range(scale):
        r.uniform_(generator=gen)
        go_right = r >= ab
        go_down = ((r >= a) & (r < ab)) | (r >= abc)
        u |= go_down.to(torch.int64) << bit
        v |= go_right.to(torch.int64) << bit
    del r
    perm = torch.randperm(n, generator=gen, device=dev)
    u, v = perm[u], perm[v]
    keep = u != v
    u, v = u[keep], v[keep]
    keys = torch.cat([u * n + v, v * n + u])
    del u, v, keep, perm
    keys = torch.unique(keys)                       # sorted, no repeats
    return n, (keys // n).to(torch.int32), (keys % n).to(torch.int32)
