"""The optimizer of LM training: AdamW with a global-norm clip and a
cosine schedule, the counterpart of the JAX package's ``optim``."""
from .adamw import AdamW, AdamWState, cosine_schedule

__all__ = ["AdamW", "AdamWState", "cosine_schedule"]
