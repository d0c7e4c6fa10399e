"""The configurations the port runs so far: the five LMs (dense
tinyllama-1.1b, stablelm-1.6b and deepseek-67b; the MoE mixtral-8x7b,
with a sliding window, and grok-1-314b) with their input shapes
(``LM_SHAPES``), MIND of the recsys serving slice with its own
(``RECSYS_SHAPES``), and the PageRank kron workload (``PAGERANK``).
``ALL_ARCHS`` keeps the JAX package's order. The GNN configurations
come with their slice (ROADMAP.md, Queue A)."""
from .base import (LM_SHAPES, LMConfig, RECSYS_SHAPES, RecSysConfig,
                   ShapeSpec, all_archs, get, register)
from . import (deepseek_67b, grok_1_314b, mind, mixtral_8x7b, pagerank_kron,
               stablelm_1_6b, tinyllama_1_1b)

ALL_ARCHS = [
    mixtral_8x7b.CONFIG, grok_1_314b.CONFIG, stablelm_1_6b.CONFIG,
    tinyllama_1_1b.CONFIG, deepseek_67b.CONFIG, mind.CONFIG,
]
PAGERANK = pagerank_kron.CONFIG

__all__ = ["LMConfig", "RecSysConfig", "ShapeSpec", "LM_SHAPES",
           "RECSYS_SHAPES", "ALL_ARCHS", "PAGERANK", "all_archs", "get",
           "register"]
