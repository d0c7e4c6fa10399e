"""DeepSeek 67B (llama-arch) [arXiv:2401.02954; hf]."""
from .base import LMConfig, register

CONFIG = LMConfig(
    name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab=102400, source="arXiv:2401.02954")
register(CONFIG)
