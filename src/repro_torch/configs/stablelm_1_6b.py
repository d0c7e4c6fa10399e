"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import LMConfig, register

CONFIG = LMConfig(
    name="stablelm-1.6b", n_layers=24, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=5632, vocab=100352,
    source="hf:stabilityai/stablelm-2-1_6b")
register(CONFIG)
