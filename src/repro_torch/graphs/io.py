"""Graph and plan persistence (npz), in the JAX package's file formats.

``save``/``load`` persist the raw edge set; ``load_plan`` reads back a
preprocessing artifact persisted with ``GraphPlan.save`` (core/plan.py),
so a server process warm-loads both the graph and its sorted layouts. The
files are those of the JAX package's ``graphs/io.py``: a graph or a plan
saved by either package loads in the other.
"""
from __future__ import annotations

import numpy as np

from .formats import Graph


def save(path: str, g: Graph) -> None:
    np.savez_compressed(path, num_nodes=g.num_nodes, src=g.src, dst=g.dst)


def load(path: str) -> Graph:
    with np.load(path) as z:
        return Graph(int(z["num_nodes"]), z["src"], z["dst"])


def load_plan(path: str):
    """Load a persisted ``GraphPlan``; pair with
    ``core.plan.install_plan`` to seed the process plan cache."""
    from ..core.plan import GraphPlan
    return GraphPlan.load(path)


def nbytes(path: str) -> int:
    """Uncompressed in-memory footprint of a persisted graph or plan
    npz, summed from the zip members' declared sizes without loading any
    array: what a ``GraphRegistry(memory_budget_bytes=...)`` accounts
    (``core.plan.plan_nbytes``), read off disk."""
    import zipfile
    with zipfile.ZipFile(path) as zf:
        return sum(info.file_size for info in zf.infolist()
                   if not info.filename.startswith("__meta__"))
