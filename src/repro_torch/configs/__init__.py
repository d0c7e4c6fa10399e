"""The configurations the port runs so far: the dense LMs of the LM
serving slice. The MoE, SWA, GNN and recsys configurations come with
their slices (ROADMAP.md, Queue A)."""
from .base import LMConfig, all_archs, get, register
from . import stablelm_1_6b, tinyllama_1_1b

ALL_ARCHS = [stablelm_1_6b.CONFIG, tinyllama_1_1b.CONFIG]

__all__ = ["LMConfig", "ALL_ARCHS", "all_archs", "get", "register"]
