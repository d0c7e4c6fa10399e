"""Data of the port's training slices: the deterministic synthetic token
stream of LM training (``tokens``). The GNN graphs come with their
slice (ROADMAP.md, Queue A)."""
from .tokens import synthetic_lm_batches

__all__ = ["synthetic_lm_batches"]
