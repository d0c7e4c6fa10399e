"""Mixtral 8x7B [arXiv:2401.04088; hf]."""
from .base import LMConfig, register

CONFIG = LMConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    window=4096, source="arXiv:2401.04088")
register(CONFIG)
