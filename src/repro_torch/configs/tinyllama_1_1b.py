"""TinyLlama 1.1B (llama2-arch small) [arXiv:2401.02385; hf]."""
from .base import LMConfig, register

CONFIG = LMConfig(
    name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=5632, vocab=32000, source="arXiv:2401.02385")
register(CONFIG)
