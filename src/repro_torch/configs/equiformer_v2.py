"""EquiformerV2: equivariant graph attention via eSCN [arXiv:2306.12059]."""
from .base import GNNConfig, register

CONFIG = GNNConfig(
    name="equiformer-v2", n_layers=12, d_hidden=128, flavor="escn",
    l_max=6, m_max=2, n_heads=8, n_rbf=8, cutoff=5.0,
    source="arXiv:2306.12059")
register(CONFIG)
