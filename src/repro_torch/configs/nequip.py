"""NequIP O(3)-equivariant interatomic potential [arXiv:2101.03164]."""
from .base import GNNConfig, register

CONFIG = GNNConfig(
    name="nequip", n_layers=5, d_hidden=32, flavor="equivariant",
    l_max=2, n_rbf=8, cutoff=5.0, source="arXiv:2101.03164")
register(CONFIG)
