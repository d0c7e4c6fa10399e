"""Grok-1 314B [hf:xai-org/grok-1; unverified]."""
from .base import LMConfig, register

CONFIG = LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    source="hf:xai-org/grok-1")
register(CONFIG)
