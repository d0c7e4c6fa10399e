"""The configurations of the port: the five LMs (dense tinyllama-1.1b,
stablelm-1.6b and deepseek-67b; the MoE mixtral-8x7b, with a sliding
window, and grok-1-314b) with their input shapes (``LM_SHAPES``), the
four GNNs (graphcast, nequip, mace, equiformer-v2) with theirs
(``GNN_SHAPES``), MIND with its own (``RECSYS_SHAPES``), and the
PageRank kron workload (``PAGERANK``). ``ALL_ARCHS`` keeps the JAX
package's order."""
from .base import (GNN_SHAPES, GNNConfig, LM_SHAPES, LMConfig, RECSYS_SHAPES,
                   RecSysConfig, ShapeSpec, all_archs, get, register)
from . import (deepseek_67b, equiformer_v2, graphcast, grok_1_314b, mace,
               mind, mixtral_8x7b, nequip, pagerank_kron, stablelm_1_6b,
               tinyllama_1_1b)

ALL_ARCHS = [
    mixtral_8x7b.CONFIG, grok_1_314b.CONFIG, stablelm_1_6b.CONFIG,
    tinyllama_1_1b.CONFIG, deepseek_67b.CONFIG, graphcast.CONFIG,
    nequip.CONFIG, mace.CONFIG, equiformer_v2.CONFIG, mind.CONFIG,
]
PAGERANK = pagerank_kron.CONFIG

__all__ = ["LMConfig", "GNNConfig", "RecSysConfig", "ShapeSpec",
           "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "ALL_ARCHS", "PAGERANK",
           "all_archs", "get", "register"]
