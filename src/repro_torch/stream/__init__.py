"""Dynamic-graph subsystem (DESIGN.md §9): streaming edge deltas,
incremental plan patching, residual-push PageRank.

    from repro_torch.stream import GraphDelta
    sess = repro_torch.open(g)
    sess.pagerank()                                  # cold solve
    sess.apply_delta(GraphDelta.insert(new_edges))   # patch the plan
    sess.pagerank(warm=True)                         # residual push
"""
from .delta import DynamicGraph, GraphDelta, apply_delta
from .incremental import residual_push_loop, seed_residual, update_ranks
from .patch import patch_plan, patch_png

__all__ = [
    "DynamicGraph", "GraphDelta", "apply_delta",
    "seed_residual", "residual_push_loop", "update_ranks",
    "patch_plan", "patch_png",
]
