"""Models of the port: the LM, dense and MoE, with sliding-window
attention (``transformer``, ``layers``), the MIND recsys model
(``recsys``), and the four GNNs (``gnn``) with their equivariant
substrate (``equivariant``)."""
from . import equivariant, gnn, layers, recsys, transformer

__all__ = ["equivariant", "gnn", "layers", "recsys", "transformer"]
