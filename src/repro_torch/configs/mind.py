"""MIND multi-interest recsys network [arXiv:1904.08030]."""
from .base import RecSysConfig, register

CONFIG = RecSysConfig(
    name="mind", embed_dim=64, n_interests=4, capsule_iters=3,
    vocab=10_000_000, hist_len=50, source="arXiv:1904.08030")
register(CONFIG)
