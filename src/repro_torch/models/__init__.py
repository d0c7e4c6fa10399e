"""Models of the port: the LM, dense and MoE, with sliding-window
attention (``transformer``, ``layers``), and the MIND recsys model
(``recsys``). The GNN models come with their slice."""
from . import layers, recsys, transformer

__all__ = ["layers", "recsys", "transformer"]
