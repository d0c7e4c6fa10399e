"""The configurations the port runs so far: the dense LMs of the LM
serving slice and MIND of the recsys serving slice, with MIND's input
shapes (``RECSYS_SHAPES``), and the PageRank kron workload
(``PAGERANK``). The MoE, SWA and GNN configurations come with their
slices (ROADMAP.md, Queue A)."""
from .base import (LMConfig, RECSYS_SHAPES, RecSysConfig, ShapeSpec,
                   all_archs, get, register)
from . import mind, pagerank_kron, stablelm_1_6b, tinyllama_1_1b

ALL_ARCHS = [stablelm_1_6b.CONFIG, tinyllama_1_1b.CONFIG, mind.CONFIG]
PAGERANK = pagerank_kron.CONFIG

__all__ = ["LMConfig", "RecSysConfig", "ShapeSpec", "RECSYS_SHAPES",
           "ALL_ARCHS", "PAGERANK", "all_archs", "get", "register"]
