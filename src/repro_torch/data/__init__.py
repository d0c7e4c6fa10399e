"""Data of the port's training slices: the deterministic synthetic token
stream of LM training (``tokens``) and the GNNs' graphs for their shape
regimes (``graphdata``)."""
from .tokens import synthetic_lm_batches
from .graphdata import batch_for_shape, graph_for_shape

__all__ = ["synthetic_lm_batches", "graph_for_shape", "batch_for_shape"]
