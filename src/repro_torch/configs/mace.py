"""MACE higher-order equivariant message passing [arXiv:2206.07697]."""
from .base import GNNConfig, register

CONFIG = GNNConfig(
    name="mace", n_layers=2, d_hidden=128, flavor="equivariant",
    l_max=2, correlation_order=3, n_rbf=8, cutoff=5.0,
    source="arXiv:2206.07697")
register(CONFIG)
