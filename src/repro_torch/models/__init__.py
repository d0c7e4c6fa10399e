"""Models of the port: the dense LM so far (``transformer``, ``layers``).
The recsys and GNN models come with their slices."""
from . import layers, transformer

__all__ = ["layers", "transformer"]
